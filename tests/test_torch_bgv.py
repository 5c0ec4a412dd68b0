"""The port's BGV against the JAX package, word for word.

One JAX BGV context (N=2^10, t = 65537, depth 2, FIXEDAUTO, HYBRID in two
digits, seed 5) makes the keys and three fresh ciphertexts; `convert`
carries them into the port's context of the same parameters on the CPU.
Every op (the packed encoding at a level, EvalAdd / EvalSub / EvalMult
with ciphertext, plaintext and scalar operands, the scale-factor
alignment of operands at different levels, EvalMultNoRelin, Relinearize,
ModReduce, LevelReduce, EvalRotate, Decrypt) must give the JAX words with
equal `level`, `noise_deg` and `scale_int`. The mult chain's fused twins
with BGV's t in their tables (`ks_fused.mult_relin_fused`, K6f's t) must
give the words of the JAX package's unfused chain, the CPU oracle of its
fused BGV EvalMult (ROADMAP queue 3: the JAX fused K6f omits t), and
K6f's schedule, modelled in numpy, with t. Then the matrix rows of `tests/test_matrix.py` for BGV with HYBRID key switching,
one per scaling technique, each with its own secret distribution.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke.ciphertext import Plaintext  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402

N = 1 << 10
T = 65537
FEATS = ("PKE", "KEYSWITCH", "LEVELEDSHE")
MAIN = dict(scheme="BGVRNS_SCHEME", ring_dim=N, mult_depth=2,
            plaintext_modulus=T, num_large_digits=2,
            scaling_technique="FIXEDAUTO")


# ---------------------------------------------------------------------------
# the two sides (shared by the other integer-scheme files)
# ---------------------------------------------------------------------------

def _params(pkg_constants, make, **kw):
    """CCParams of either package from names: enum fields (and the
    security level, HEStd_NotSet unless given) by member name."""
    enums = dict(scheme="Scheme", scaling_technique="ScalingTechnique",
                 ks_technique="KeySwitchTechnique",
                 secret_key_dist="SecretKeyDist",
                 multiplication_technique="MultiplicationTechnique",
                 encryption_technique="EncryptionTechnique")
    level = kw.pop("security_level", "HEStd_NotSet")
    args = {k: (getattr(getattr(pkg_constants, enums[k]), v)
                if k in enums else v) for k, v in kw.items()}
    return make(security_level=getattr(pkg_constants.SecurityLevel, level),
                **args)


def jax_context(seed, **kw):
    cc = jctx.GenCryptoContext(_params(jc, jprm.CCParams, **kw), seed=seed)
    for f in FEATS:
        cc.Enable(getattr(jc.PKESchemeFeature, f))
    return cc


def port_context(seed, **kw):
    return fhe.GenCryptoContext(_params(fhe.pke.constants, fhe.CCParams,
                                        **kw), seed=seed, device="cpu")


def port_key(jek, tag):
    """A JAX eval key (hybrid or BV) on the port's CPU."""
    sh = [None if v is None else np.asarray(v) for v in (jek.bv_sh,
                                                         jek.av_sh)]
    return convert.bv_key_from_numpy(np.asarray(jek.bv), np.asarray(jek.av),
                                     key_tag=tag, device="cpu", bv_sh=sh[0],
                                     av_sh=sh[1])


def carry_keys(jcc, cc, kp):
    """The JAX context's eval keys into the port's; returns the port's
    secret key."""
    tag = kp.secret_key.key_tag
    if tag in jcc.eval_mult_keys:
        cc.eval_mult_keys[tag] = port_key(jcc.eval_mult_keys[tag], tag)
    cc.InsertEvalAutomorphismKey(
        {g: port_key(k, tag)
         for g, k in jcc.eval_automorphism_keys.get(tag, {}).items()}, tag)
    return convert.private_key_from_numpy(np.asarray(kp.secret_key.s_qp),
                                          key_tag=tag, device="cpu")


def ct(jct):
    return convert.ciphertext_from_jax(jct, device="cpu")


def check_each(cases, check):
    """check(case) for every case; one failure does not hide the others:
    the assertion names each failing case with its message."""
    failed = {}
    for case in cases:
        try:
            check(case)
        except AssertionError as exc:
            failed[case] = (str(exc).strip().splitlines() or ["failed"])[0]
    assert not failed, failed


def assert_same(got, want):
    """Equal words and equal level, degree, scale factor and encoding."""
    if isinstance(want, jctx.Plaintext):
        assert isinstance(got, Plaintext)
        np.testing.assert_array_equal(to_u32(got.poly), np.asarray(want.poly))
        assert (got.scale_int, got.encoding) == (want.scale_int,
                                                 want.encoding)
    else:
        assert len(got.elements) == len(want.elements)
        for g, w in zip(got.elements, want.elements):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))
        assert (got.scale_int, got.encoding, got.metadata) == (
            want.scale_int, want.encoding, want.metadata)
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)


# ---------------------------------------------------------------------------
# the main context: every op against JAX
# ---------------------------------------------------------------------------

# x, y, z fresh ciphertexts, prod = EvalMult(x, y) (degree 2), resc =
# ModReduce(prod) (one multiplicative level down), u, v slot vectors
OPS = {
    "encode": lambda cc, i: cc.MakePackedPlaintext(i["u"]),
    "encode_level1": lambda cc, i: cc.MakePackedPlaintext(i["u"], level=1),
    "encode_level_drop": lambda cc, i: cc.MakePackedPlaintext(
        i["u"], level=cc.bgv_drops_per_level),
    "add": lambda cc, i: cc.EvalAdd(i["x"], i["y"]),
    "sub": lambda cc, i: cc.EvalSub(i["x"], i["y"]),
    "negate": lambda cc, i: cc.EvalNegate(i["x"]),
    "add_scalar": lambda cc, i: cc.EvalAdd(i["x"], 7),
    "sub_scalar": lambda cc, i: cc.EvalSub(i["resc"], 3),
    "add_plain": lambda cc, i: cc.EvalAdd(i["x"],
                                          cc.MakePackedPlaintext(i["v"])),
    "add_plain_other_level": lambda cc, i: cc.EvalAdd(
        i["resc"], cc.MakePackedPlaintext(i["v"])),
    "mult_scalar": lambda cc, i: cc.EvalMult(i["x"], 5),
    "mult_plain": lambda cc, i: cc.EvalMult(i["x"],
                                            cc.MakePackedPlaintext(i["v"])),
    "mult_plain_other_level": lambda cc, i: cc.EvalMult(
        i["resc"], cc.MakePackedPlaintext(i["v"])),
    "mult": lambda cc, i: i["prod"],
    "mult_no_relin": lambda cc, i: cc.EvalMultNoRelin(i["x"], i["y"]),
    "relinearize": lambda cc, i: cc.Relinearize(
        cc.EvalMultNoRelin(i["x"], i["z"])),
    "mod_reduce": lambda cc, i: i["resc"],
    "mod_reduce_one_tower": lambda cc, i: cc.ModReduce(i["prod"], 1),
    "mult_levels": lambda cc, i: cc.EvalMult(i["prod"], i["z"]),
    "add_levels": lambda cc, i: cc.EvalAdd(i["z"], i["resc"]),
    "sub_levels_deg2": lambda cc, i: cc.EvalSub(i["prod"], i["resc"]),
    "level_reduce": lambda cc, i: cc.LevelReduce(i["x"], 2),
    "rotate": lambda cc, i: cc.EvalRotate(i["x"], 1),
    "rotate_level": lambda cc, i: cc.EvalRotate(i["resc"], -1),
    "square": lambda cc, i: cc.EvalSquare(i["resc"]),
    "compress": lambda cc, i: cc.Compress(i["prod"], 2),
}


def _inputs(cc, x, y, z, u, v):
    prod = cc.EvalMult(x, y)
    return dict(x=x, y=y, z=z, u=u, v=v, prod=prod, resc=cc.ModReduce(prod))


@functools.lru_cache(maxsize=None)
def _sides():
    jcc = jax_context(5, **MAIN)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, [1, -1])
    rng = np.random.default_rng(5)
    # full vectors: the JAX package broadcasts a plaintext's values to N
    # when it re-encodes them at another level
    u, v, w = (rng.integers(0, T, N) for _ in range(3))
    jx, jy, jz = (jcc.Encrypt(kp.public_key, jcc.MakePackedPlaintext(a))
                  for a in (u, v, w))
    jin = _inputs(jcc, jx, jy, jz, u, v)
    want = {op: fn(jcc, jin) for op, fn in OPS.items()}
    dec = {op: jcc.Decrypt(kp.secret_key, want[op]) for op in
           ("mult_levels", "sub_levels_deg2", "rotate_level", "compress")}
    cc = port_context(5, **MAIN)
    sk = carry_keys(jcc, cc, kp)
    port_in = _inputs(cc, ct(jx), ct(jy), ct(jz), u, v)
    return dict(jcc=jcc, cc=cc, kp=kp, sk=sk, want=want, dec=dec,
                port_in=port_in, jin=jin, uvw=(u, v, w))


def test_chain_matches_jax():
    s = _sides()
    cc, jcc = s["cc"], s["jcc"]
    assert cc.moduli_q == list(jcc.moduli_q)
    assert cc.moduli_p == list(jcc.moduli_p)
    assert (cc.bgv_drops_per_level, cc.L, cc.noise_scale_int,
            cc.plaintext_modulus, cc.slots) == (
        jcc.bgv_drops_per_level, jcc.L, jcc.noise_scale_int,
        jcc.plaintext_modulus, jcc.slots)
    from openfhe_tpu.pke.schemes import bgv as jbgv
    from openfhe_tpu_torch.pke.schemes import bgv
    assert [bgv.level_factor(cc, lv) for lv in range(5)] == [
        jbgv.level_factor(jcc, lv) for lv in range(5)]


def test_ops_match_jax():
    """Every op of OPS, each against the JAX op's result."""
    s = _sides()
    check_each(OPS, lambda op: assert_same(OPS[op](s["cc"], s["port_in"]),
                                           s["want"][op]))


def test_decrypt_matches_jax():
    """The words and the slots of Decrypt (the factor divided out)."""
    s = _sides()

    def check(op):
        got = s["cc"].Decrypt(s["sk"], ct(s["want"][op]))
        want = s["dec"][op]
        np.testing.assert_array_equal(to_u32(got.poly),
                                      np.asarray(want.poly))
        np.testing.assert_array_equal(got.values, want.values)

    check_each(s["dec"], check)


def test_jax_plaintexts_carried_by_convert():
    """A JAX-made plaintext carried over by `convert.plaintext_from_numpy`
    (level 0 and one multiplicative level down, its factor in
    `scale_int`) multiplies and adds as the JAX op does."""
    s = _sides()
    cc, jcc, i = s["cc"], s["jcc"], s["port_in"]
    for level, op, want in ((0, cc.EvalMult, "mult_plain"),
                            (0, cc.EvalAdd, "add_plain"),
                            (cc.bgv_drops_per_level, cc.EvalAdd,
                             "add_plain_other_level")):
        jpt = jcc.MakePackedPlaintext(i["v"], level=level)
        pt = convert.plaintext_from_numpy(
            np.asarray(jpt.poly), fmt=jpt.fmt, level=jpt.level,
            noise_deg=jpt.noise_deg, scale=jpt.scale, slots=jpt.slots,
            encoding=jpt.encoding, values=jpt.values,
            scale_int=jpt.scale_int, device="cpu")
        assert_same(pt, jpt)
        x = i["resc"] if level else i["x"]
        assert_same(op(x, pt), s["want"][want])


def test_decryptions_are_exact():
    s = _sides()
    u, v, w = s["uvw"]
    m = len(u)
    got = lambda op: s["cc"].Decrypt(s["sk"], ct(s["want"][op])).values
    assert (got("mult_levels")[:m] == u * v % T * w % T).all()
    assert (got("sub_levels_deg2") == 0).all()
    half = N // 2
    assert (got("rotate_level")[:half]
            == np.roll(u[:half] * v[:half] % T, 1)).all()


def test_fused_mult_chain_with_t_matches_the_unfused_chain():
    """K6f with t = 65537: the fused chain's twins with t in their tables
    (K45's t^-1, K6f's t) give the JAX package's unfused EvalMult words at
    level 0 and one level down, as its CPU EvalMult computes them."""
    s = _sides()
    cc = s["cc"]
    ek = cc.eval_mult_keys[s["kp"].secret_key.key_tag]
    for (a, b), want in (((s["port_in"]["x"], s["port_in"]["y"]),
                          s["want"]["mult"]),
                         ((s["port_in"]["resc"], s["port_in"]["resc"]),
                          s["want"]["square"])):
        tabs = ks_fused.make_fused_ks_tables(
            cc.basis_at(a.level).concat(cc.basis_p), cc.size_ql(a.level),
            len(cc.moduli_q), 2, ns_int=T)
        assert not tabs.t_is_one
        got = ks_fused.mult_relin_fused(*a.elements, *b.elements, ek.bv,
                                        ek.av, ek.bv_sh, ek.av_sh, tabs)
        for g, w in zip(got, want.elements):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    # the CPU context attaches no fused tables; with them attached, the
    # context's EvalMult takes the fused chain and gives the same words
    orig = cc.hybrid_tables

    def with_fused(size_ql):
        tabs = orig(size_ql)
        return dataclasses.replace(tabs, fused=ks_fused.make_fused_ks_tables(
            tabs.basis_qlp, size_ql, len(cc.moduli_q), 2, ns_int=T))

    cc.hybrid_tables = with_fused
    try:
        assert_same(cc.EvalMult(s["port_in"]["x"], s["port_in"]["y"]),
                    s["want"]["mult"])
        assert_same(cc.EvalRotate(s["port_in"]["x"], 1), s["want"]["rotate"])
    finally:
        del cc.hybrid_tables


def test_k6f_schedule_with_t_matches_twin_and_exact():
    """K6f's numpy model of `submul_cluster` with t = 65537 in the tables
    against the twin and JAX's NTT with exact products
    (`tests/test_torch_ks_final.py`'s 31-bit case, clusters of 4,
    ext_off 1)."""
    from test_torch_ks_final import \
        test_models_on_31_bit_primes_match_jax_ntt_and_twins as k6f_case
    k6f_case(10, 1, T)


def test_mod_down_with_t_matches_jax():
    """ApproxModDown with t: t^-1 on the P rows before the conversion, t
    after it."""
    import jax.numpy as jnp
    from openfhe_tpu.lattice import basis as jbasis
    from openfhe_tpu.lattice import rns_tools as jrt
    from openfhe_tpu_torch.lattice import rns_tools as rt
    from openfhe_tpu_torch.math.modops import u32_tensor
    s = _sides()
    cc = s["cc"]
    q, p = cc.moduli_q, cc.moduli_p
    rng = np.random.default_rng(3)
    xq = np.stack([rng.integers(0, m, N) for m in q]).astype(np.uint32)
    xp = np.stack([rng.integers(0, m, N) for m in p]).astype(np.uint32)
    want = jrt.approx_mod_down(jnp.asarray(xq), jnp.asarray(xp),
                               jbasis.make_basis(q, N),
                               jbasis.make_basis(p, N),
                               jrt.make_mod_down_tables(p, q, t=T))
    got = rt.approx_mod_down(u32_tensor(xq), u32_tensor(xp), cc.basis_q,
                             cc.basis_p, rt.make_mod_down_tables(p, q, t=T))
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# tests/test_matrix.py's BGV rows with HYBRID key switching
# ---------------------------------------------------------------------------

MATRIX = [("FIXEDMANUAL", "SPARSE_TERNARY"),
          ("FIXEDAUTO", "GAUSSIAN"),
          ("FLEXIBLEAUTO", "UNIFORM_TERNARY"),
          ("FLEXIBLEAUTOEXT", "UNIFORM_TERNARY")]


def matrix_program(cc, x, y):
    """test_matrix's program: EvalAdd(EvalMult(v, w), v) and
    EvalRotate(v, 1)."""
    return cc.EvalAdd(cc.EvalMult(x, y), x), cc.EvalRotate(x, 1)


def matrix_case(scheme, ks, dist, scal=None, seed=11):
    """One row: both sides at N=512, t = 12289, depth 2, the JAX-made
    inputs, the program's words on both sides and the port's decryptions
    against the plain integers."""
    t = 12289
    kw = dict(scheme=scheme, ring_dim=512, mult_depth=2,
              plaintext_modulus=t, ks_technique=ks, secret_key_dist=dist)
    if scal:
        kw["scaling_technique"] = scal
    if ks == "BV":
        kw["digit_size"] = 5
    jcc = jax_context(seed, **kw)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, [1])
    v = np.arange(16, dtype=np.int64) % 7
    w = (np.arange(16, dtype=np.int64) * 3) % 5
    jv, jw = (jcc.Encrypt(kp.public_key, jcc.MakePackedPlaintext(a))
              for a in (v, w))
    want = matrix_program(jcc, jv, jw)
    cc = port_context(seed, **kw)
    assert cc.moduli_q == list(jcc.moduli_q)
    assert cc.moduli_p == list(jcc.moduli_p)
    sk = carry_keys(jcc, cc, kp)
    got = matrix_program(cc, ct(jv), ct(jw))
    for g, wnt in zip(got, want):
        assert_same(g, wnt)
    prod, rot = (cc.Decrypt(sk, g).values for g in got)
    np.testing.assert_array_equal(prod[:16] % t, (v * w + v) % t)
    np.testing.assert_array_equal(rot[:15] % t, v[1:] % t)


@pytest.mark.parametrize("scal,dist", MATRIX,
                         ids=[f"{a}-{b}" for a, b in MATRIX])
def test_matrix_row_matches_jax(scal, dist):
    matrix_case("BGVRNS_SCHEME", "HYBRID", dist, scal)


def test_entry_points_need_a_gpu_by_default():
    """Without `device` the integer schemes' contexts and the new
    conversions ask for the GPU, as the CKKS context does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for kw in (MAIN, dict(MAIN, scheme="BFVRNS_SCHEME"),
               dict(MAIN, ks_technique="BV")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fhe.GenCryptoContext(_params(fhe.pke.constants, fhe.CCParams,
                                         **kw))
    words = np.zeros((2, 3, 8), np.uint32)
    for call in (lambda: convert.bv_key_from_numpy(words, words),
                 lambda: convert.plaintext_from_numpy(words[0]),
                 lambda: convert.ciphertext_from_numpy(
                     list(words), scale_int=3, metadata=(("k", 1),))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
