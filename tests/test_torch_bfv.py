"""The port's BFV against the JAX package, word for word.

One JAX BFV context (N=512, t = 12289, depth 2, HPS, HYBRID in three
digits, seed 7: `tests/test_matrix.py`'s chain, shared with the matrix
row and the EXTENDED case below) makes the keys and three fresh
ciphertexts; `convert` carries them into the port's context of the same
parameters on the CPU.
Every op (the packed encoding, EvalAdd / EvalSub with ciphertext,
plaintext and scalar operands, the plaintext and scalar multiply, the
RNS tensor product EvalMultNoRelin, Relinearize, EvalMult and a second
EvalMult, EvalRotate, Decrypt) must give the JAX words. The tables of the
tensor product (the auxiliary basis, every constant) equal the JAX
package's. HPSPOVERQLEVELED drops towers before its tensor products and
expands them back (N=64, t = 257, depth 3, as `tests/test_bgv_bfv.py`
runs it); EXTENDED encryption's words equal the JAX package's on the same
zero encryption (the two packages' RNGs never agree, so both take one
made by the JAX package). Then `tests/test_matrix.py`'s BFV row with
HYBRID key switching.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke.schemes import bfv as jbfv  # noqa: E402
from openfhe_tpu.pke.schemes import rns_pke as jrns  # noqa: E402

from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke.schemes import bfv, rns_pke  # noqa: E402
from test_torch_bgv import (assert_same, carry_keys,  # noqa: E402
                            check_each, ct, jax_context, matrix_case,
                            port_context)

N = 512
T = 12289
MAIN = dict(scheme="BFVRNS_SCHEME", ring_dim=N, mult_depth=2,
            plaintext_modulus=T)
LEVELED = dict(scheme="BFVRNS_SCHEME", ring_dim=64, mult_depth=3,
               plaintext_modulus=257, scaling_mod_size=28,
               multiplication_technique="HPSPOVERQLEVELED")

OPS = {
    "encode": lambda cc, i: cc.MakePackedPlaintext(i["u"]),
    "add": lambda cc, i: cc.EvalAdd(i["x"], i["y"]),
    "sub": lambda cc, i: cc.EvalSub(i["x"], i["y"]),
    "negate": lambda cc, i: cc.EvalNegate(i["x"]),
    "add_scalar": lambda cc, i: cc.EvalAdd(i["x"], 9),
    "add_plain": lambda cc, i: cc.EvalAdd(i["x"],
                                          cc.MakePackedPlaintext(i["v"])),
    "sub_plain": lambda cc, i: cc.EvalSub(i["x"],
                                          cc.MakePackedPlaintext(i["v"])),
    "mult_scalar": lambda cc, i: cc.EvalMult(i["x"], 3),
    "mult_plain": lambda cc, i: cc.EvalMult(i["x"],
                                            cc.MakePackedPlaintext(i["v"])),
    "mult_no_relin": lambda cc, i: i["tensor"],
    "relinearize": lambda cc, i: cc.Relinearize(i["tensor"]),
    "mult": lambda cc, i: i["prod"],
    "mult_depth2": lambda cc, i: cc.EvalMult(i["prod"], i["z"]),
    "add_deg2": lambda cc, i: cc.EvalAdd(i["prod"], i["x"]),
    "rotate": lambda cc, i: cc.EvalRotate(i["x"], 1),
    "rotate_product": lambda cc, i: cc.EvalRotate(i["prod"], -1),
}


def _inputs(cc, x, y, z, u, v):
    return dict(x=x, y=y, z=z, u=u, v=v, prod=cc.EvalMult(x, y),
                tensor=cc.EvalMultNoRelin(x, z))


@functools.lru_cache(maxsize=None)
def _sides():
    jcc = jax_context(7, **MAIN)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, [1, -1])
    rng = np.random.default_rng(7)
    u, v, w = (rng.integers(0, T, N) for _ in range(3))
    jx, jy, jz = (jcc.Encrypt(kp.public_key, jcc.MakePackedPlaintext(a))
                  for a in (u, v, w))
    jin = _inputs(jcc, jx, jy, jz, u, v)
    want = {op: fn(jcc, jin) for op, fn in OPS.items()}
    dec = {op: jcc.Decrypt(kp.secret_key, want[op])
           for op in ("mult_depth2", "rotate_product", "mult_no_relin")}
    cc = port_context(7, **MAIN)
    sk = carry_keys(jcc, cc, kp)
    port_in = _inputs(cc, ct(jx), ct(jy), ct(jz), u, v)
    return dict(jcc=jcc, cc=cc, kp=kp, sk=sk, want=want, dec=dec,
                port_in=port_in, uvw=(u, v, w))


def test_chain_and_tables_match_jax():
    s = _sides()
    cc, jcc = s["cc"], s["jcc"]
    assert cc.moduli_q == list(jcc.moduli_q)
    assert cc.moduli_p == list(jcc.moduli_p)
    assert (cc.big_q, cc.bfv_aux_pool, cc.bfv_m_sk) == (
        jcc.big_q, list(jcc.bfv_aux_pool), jcc.bfv_m_sk)
    np.testing.assert_array_equal(to_u32(cc.c_delta_q[0]),
                                  np.asarray(jcc.c_delta_q[0]))
    mt, jmt = bfv._size_tables(cc, len(cc.moduli_q)), jbfv._size_tables(
        jcc, len(jcc.moduli_q))
    assert mt.basis_rsk.moduli == tuple(jmt["basis_rsk"].moduli)
    assert mt.big_r == jmt["big_r"]
    for name in ("c_t_q", "c_t_rsk", "c_halfq_q", "c_halfq_plus_qs_rsk",
                 "c_qinv_rsk", "c_rinv_sk", "c_r_q", "c_s_q"):
        for got, want in zip(getattr(mt, name), jmt[name]):
            np.testing.assert_array_equal(to_u32(got), np.asarray(want),
                                          err_msg=name)
    for name in ("st_q_to_rsk", "st_r_to_qsk"):
        got = to_u32(getattr(mt, name).bhat_mod_d)
        np.testing.assert_array_equal(
            got, np.asarray(jmt[name].bhat_mod_d).reshape(got.shape),
            err_msg=name)


def test_ops_match_jax():
    """Every op of OPS, each against the JAX op's result."""
    s = _sides()
    check_each(OPS, lambda op: assert_same(OPS[op](s["cc"], s["port_in"]),
                                           s["want"][op]))


def test_decrypt_matches_jax_and_is_exact():
    s = _sides()
    u, v, w = s["uvw"]
    half = N // 2
    exact = {"mult_depth2": u * v % T * w % T,
             "mult_no_relin": u * w % T,
             "rotate_product": np.concatenate([
                 np.roll((u * v % T)[:half], 1),
                 np.roll((u * v % T)[half:], 1)])}

    def check(op):
        got = s["cc"].Decrypt(s["sk"], ct(s["want"][op]))
        want = s["dec"][op]
        np.testing.assert_array_equal(to_u32(got.poly),
                                      np.asarray(want.poly))
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.values, exact[op])

    check_each(exact, check)


def test_scale_round_matches_jax():
    """_bfv_scale_round alone, on random X over Q and R u sk (a batch of
    two, which the port runs as one)."""
    s = _sides()
    cc, jcc = s["cc"], s["jcc"]
    mt = bfv._size_tables(cc, len(cc.moduli_q))
    rng = np.random.default_rng(1)
    mk = lambda mods: np.stack([np.stack([rng.integers(0, m, N)
                                          for m in mods])
                                for _ in range(2)]).astype(np.uint32)
    xq, xr = mk(cc.moduli_q), mk(mt.basis_rsk.moduli)
    got = bfv._bfv_scale_round(u32_tensor(xq), u32_tensor(xr), mt)
    import jax.numpy as jnp
    tabs = jbfv._mult_tables(jcc)
    for i in range(2):
        want = jbfv._bfv_scale_round(jnp.asarray(xq[i]), jnp.asarray(xr[i]),
                                     tabs)
        np.testing.assert_array_equal(to_u32(got[i]), np.asarray(want))


@pytest.mark.parametrize("scheme", ["BFVRNS_SCHEME", "BGVRNS_SCHEME"])
def test_derived_ring_dim_matches_jax(scheme):
    """`tests/test_security.py`'s rule under HEStd_128_classic: with no
    ring_dim both packages pick the same smallest standardized N and
    chain (and the accessors agree); an explicit N too small for the
    chain is refused."""
    kw = dict(scheme=scheme, plaintext_modulus=65537, mult_depth=2,
              security_level="HEStd_128_classic")
    jcc, cc = jax_context(1, **kw), port_context(1, **kw)
    assert (cc.ring_dim, cc.moduli_q, cc.moduli_p) == (
        jcc.ring_dim, list(jcc.moduli_q), list(jcc.moduli_p))
    assert cc.GetModulus() == jcc.GetModulus()
    assert cc.GetRootOfUnity() == jcc.GetRootOfUnity()
    with pytest.raises(ValueError, match="standardized"):
        port_context(1, **dict(kw, mult_depth=8, ring_dim=1 << 12))


def test_modreduce_is_refused():
    s = _sides()
    with pytest.raises(ValueError, match="not applicable to BFV"):
        s["cc"].ModReduce(s["port_in"]["x"])


# ---------------------------------------------------------------------------
# HPSPOVERQLEVELED and EXTENDED encryption
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _leveled():
    jcc = jax_context(5, **LEVELED)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 257, 64), rng.integers(0, 257, 64)
    jx, jy = (jcc.Encrypt(kp.public_key, jcc.MakePackedPlaintext(a))
              for a in (x, y))
    chain = [jcc.EvalMult(jx, jy)]
    for _ in range(2):
        chain.append(jcc.EvalMult(chain[-1], jy))
    cc = port_context(5, **LEVELED)
    sk = carry_keys(jcc, cc, kp)
    return dict(jcc=jcc, cc=cc, sk=sk, xy=(x, y), jx=jx, jy=jy, chain=chain)


def test_hpspoverqleveled_chain_matches_jax():
    """Three products, each after dropping the towers the noise has used
    (the drop counts of both packages agree), the last at noise degree 4,
    its decryption exact."""
    s = _leveled()
    cc, jcc = s["cc"], s["jcc"]
    drops = [bfv._find_levels_to_drop(cc, d) for d in range(4)]
    assert drops == [jbfv._find_levels_to_drop(jcc, d) for d in range(4)]
    assert max(drops) > 0
    got = [cc.EvalMult(ct(s["jx"]), ct(s["jy"]))]
    for _ in range(2):
        got.append(cc.EvalMult(got[-1], ct(s["jy"])))
    for g, w in zip(got, s["chain"]):
        assert_same(g, w)
    assert got[-1].noise_deg == 4
    x, y = s["xy"]
    dec = cc.Decrypt(s["sk"], got[-1]).values[:64]
    np.testing.assert_array_equal(np.mod(dec, 257), x * y * y % 257 * y
                                  % 257)


@pytest.mark.parametrize("key", ["public", "secret"])
def test_extended_encryption_matches_jax(monkeypatch, key):
    """EncryptionTechnique.EXTENDED on one zero encryption over Q r made
    by the JAX package (handed to both sides): equal words, and the
    port's decryption exact."""
    kw = dict(MAIN, encryption_technique="EXTENDED")
    jcc = jax_context(21, **kw)
    kp = jcc.KeyGen()
    cc = port_context(21, **kw)
    sk = carry_keys(jcc, cc, kp)
    basis_qr = jcc.basis_q.concat(jcc.basis_p.slice(0, 1))
    zero = (jrns.encrypt_zero_pk(jcc.next_rng(), kp.public_key, basis_qr)
            if key == "public" else
            jrns.encrypt_zero_sk(jcc.next_rng(), kp.secret_key, basis_qr))
    zero = tuple(np.asarray(z) for z in zero)
    monkeypatch.setattr(jrns, "encrypt_zero_pk", lambda *a, **k: zero)
    monkeypatch.setattr(jrns, "encrypt_zero_sk", lambda *a, **k: zero)
    port_zero = tuple(u32_tensor(z) for z in zero)
    monkeypatch.setattr(rns_pke, "encrypt_zero_pk",
                        lambda *a, **k: port_zero)
    monkeypatch.setattr(rns_pke, "encrypt_zero_sk",
                        lambda *a, **k: port_zero)
    v = np.arange(16, dtype=np.int64) % 11
    jkey = kp.public_key if key == "public" else kp.secret_key
    from openfhe_tpu_torch import convert
    pkey = (convert.public_key_from_numpy(np.asarray(kp.public_key.b),
                                          np.asarray(kp.public_key.a),
                                          kp.public_key.key_tag, "cpu")
            if key == "public" else sk)
    want = jcc.Encrypt(jkey, jcc.MakePackedPlaintext(v))
    got = cc.Encrypt(pkey, cc.MakePackedPlaintext(v))
    assert_same(got, want)
    assert cc.Decrypt(sk, got).values[:16].tolist() == v.tolist()


# ---------------------------------------------------------------------------
# tests/test_matrix.py's BFV row with HYBRID key switching
# ---------------------------------------------------------------------------

def test_matrix_row_matches_jax():
    matrix_case("BFVRNS_SCHEME", "HYBRID", "GAUSSIAN",
                scal="FIXEDMANUAL")
