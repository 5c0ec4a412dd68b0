"""The frozen work counts against counts made by hand at small shapes:
N = 16, a level of 3 Q towers, 2 P towers, digits of 2 towers (2 and 1
at this level); a GINX batch of 2 gates at n = 4, N = 16, 27-bit Q,
B_g = 128 (4 digits, d2 = 6), q_KS = 2^15 in base 32 (3 digits)."""

from harness import work

# a forward NTT of one row at N = 16: 8 butterflies x 4 stages x 10
NTT1 = 8 * 4 * 10
# an inverse one: the same and N^-1, a Shoup product (5) a word
INTT1 = NTT1 + 16 * 5


def conv(outputs, terms):
    return outputs * (terms * 5 + 11)


def test_eval_mult():
    tensor = 3 * 16 * (3 * 10 + 2 * 2 + 2 * 3)
    mod_up = (3 * INTT1 + conv(16 * 3, 2) + 3 * NTT1      # digit of 2
              + conv(16 * 4, 1) + 4 * NTT1)               # digit of 1
    inner = 2 * 2 * 5 * 16 * 7
    down = 2 * INTT1 + conv(16 * 3, 2) + 3 * NTT1 + 3 * 16 * (3 + 5)
    ops = tensor + mod_up + inner + 2 * down + 2 * 3 * 16 * 2
    words = 16 * (4 * 3 + 2 * 2 * 5 + 2 * 3)
    assert work.eval_mult(16, 3, 2, 2, 2) == (4 * words, ops) \
        == (2432, 16128)


def test_rescale():
    ops = 2 * (INTT1 + 2 * 16 * 5 + 2 * NTT1 + 2 * 16 * 8)
    assert work.rescale(16, 3) == (4 * 16 * (6 + 4), ops) == (640, 2912)


def test_hoisted_rotation():
    mod_up = (3 * INTT1 + conv(48, 2) + 3 * NTT1 + conv(64, 1) + 4 * NTT1)
    assert work.fast_rotation_precompute(16, 3, 2, 2, 2) == \
        (4 * 16 * (3 + 2 * 5), mod_up)
    down = 2 * INTT1 + conv(48, 2) + 3 * NTT1 + 3 * 16 * 8
    ops = 2 * 2 * 5 * 16 * 7 + 2 * down + 3 * 16 * 2
    words = 16 * (2 * 5 + 2 * 2 * 5 + 3 + 2 * 3)
    assert work.fast_rotation(16, 3, 2, 2, 2) == (4 * words, ops) \
        == (2496, 8640)
    assert work.mult_plain(16, 3) == (4 * 16 * 15, 2 * 3 * 16 * 10)
    assert work.add(16, 3) == (4 * 16 * 18, 2 * 3 * 16 * 2)


def test_gate_batch():
    # a step: 2 + 6 transforms, N^-1 on 2 rows, the digits of 2 rows,
    # the key products (4 d2 terms of 4), 6 reductions, 4 monomial terms
    step = (8 * 8 * 4 * 10 + 2 * 16 * 5 + 2 * 16 * (3 + 4 * 6)
            + 16 * (4 * 6 * 4 + 6 * 10 + 4 * 4))
    gate = (5 * 2 + 16 * 2 + NTT1 + 4 * step + 2 * INTT1 + 17 * 4
            + 16 * 3 * (6 + 5 * 2) + 5 * 4)
    words = 4 * 2 * 6 * 2 * 16 + 16 * 3 * 5 + 2 * 3 * 5
    assert work.gate_batch(2, 4, 16, 27, 128, 1 << 15, 32) == \
        (4 * words, 2 * gate) == (7224, 54724)


def test_counts_are_shape_only_and_grow_with_the_level():
    a = work.eval_mult(1 << 16, 31, 16, 16, 2)
    b = work.eval_mult(1 << 16, 3, 16, 16, 2)
    assert a[0] > b[0] and a[1] > b[1]
