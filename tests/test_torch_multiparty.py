"""The port's multiparty layer against the JAX package, word for word.

The context of `tests/test_serialize_pre_multiparty.py::ckks` (CKKS,
N=256, depth 3, 28/30-bit, FLEXIBLEAUTO, seed 3) runs the JAX protocol
with its samplers recorded: `record_draws` wraps
`openfhe_tpu.math.sampling.ternary`, `discrete_gaussian` and
`uniform_residues`, which the JAX modules look up at call time, and keeps
what they return in call order (the jitted encryption of zero runs as its
Python function meanwhile). Each random step of the port is a draw and
a deterministic core (`*_core`), and the core fed JAX's draws must give
JAX's words with equal tags: 3-party keygen, the partial decryptions and
their fusion, the joint relinearization key of
`test_multiparty_joint_relin_key`, the joint rotation keys for +-1 and
EvalMult / EvalRotate under them; the same ops with fused tables attached
on the CPU give the unfused words, which shows that the joint keys carry
their Shoup companions. Then ShareKeys / RecoverSharedKey, the
NOISE_FLOODING_MULTIPARTY chains and masks on
`test_noise_flooding_multiparty_bfv_extra_limb`'s BFV (N=512, t=12289,
seed 31) and a BGV chain of the same sizes, the smudging draws'
statistics, and the entry points' refusal of the CPU unless asked.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.math import sampling as jsampling  # noqa: E402
from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402
from openfhe_tpu.pke.schemes import rns_pke as jrns  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice.automorph import \
    rotation_automorphism_index  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke import multiparty as mp  # noqa: E402
from openfhe_tpu_torch.pke.keys import PrivateKey, PublicKey  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused  # noqa: E402

FEATS = ("PKE", "KEYSWITCH", "LEVELEDSHE", "PRE", "MULTIPARTY")
CKKS = dict(scheme="CKKSRNS_SCHEME", ring_dim=256, mult_depth=3,
            scaling_mod_size=28, first_mod_size=30, batch_size=128,
            scaling_technique="FLEXIBLEAUTO")
FLOOD = dict(ring_dim=512, mult_depth=1, plaintext_modulus=12289,
             scaling_mod_size=28, multiparty_mode="NOISE_FLOODING_MULTIPARTY")


# ---------------------------------------------------------------------------
# the two sides (shared by the other protocol files)
# ---------------------------------------------------------------------------

def _params(pkg_constants, make, **kw):
    """CCParams of either package from names: enum fields by member name,
    HEStd_NotSet unless given."""
    enums = dict(scheme="Scheme", scaling_technique="ScalingTechnique",
                 ks_technique="KeySwitchTechnique",
                 multiparty_mode="MultipartyMode",
                 pre_mode="ProxyReEncryptionMode")
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


@contextlib.contextmanager
def record_draws():
    """The JAX samplers' outputs in call order, as port tensors: small
    signed samples as int32 [N], uniform residues as int32 words. The
    jitted `rns_pke.encrypt_zero_pk` runs as its Python function
    (`__wrapped__`, the NTTs inside still jitted) so that the wrappers see
    concrete arrays: `jax.disable_jit()` would run every NTT op by op,
    about 28 s for one IntBootEncrypt at N=512. Record no call that
    reaches a sampler inside a jitted function (Encrypt)."""
    draws = []
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jrns, "encrypt_zero_pk",
                       jrns.encrypt_zero_pk.__wrapped__)
        for name in ("ternary", "discrete_gaussian", "uniform_residues"):
            def rec(*a, _f=getattr(jsampling, name), _n=name, **k):
                out = _f(*a, **k)
                arr = np.asarray(out)
                draws.append(u32_tensor(arr) if _n == "uniform_residues"
                             else torch.from_numpy(arr.astype(np.int32)))
                return out
            mpatch.setattr(jsampling, name, rec)
        yield draws


def sk(jkey):
    return convert.private_key_from_numpy(np.asarray(jkey.s_qp),
                                          key_tag=jkey.key_tag, device="cpu")


def pk(jkey):
    return convert.public_key_from_numpy(np.asarray(jkey.b),
                                         np.asarray(jkey.a),
                                         key_tag=jkey.key_tag, device="cpu")


def ct(jct):
    return convert.ciphertext_from_jax(jct, device="cpu")


def words_equal(got, want) -> None:
    """Equal words of tensors, keys, ciphertexts or plaintexts, with equal
    tags and metadata; an EvalKey of the port must carry its
    companions."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            words_equal(g, w)
        return
    fields = {"Ciphertext": ("elements",), "PublicKey": ("b", "a"),
              "PrivateKey": ("s_qp",), "EvalKey": ("bv", "av"),
              "Plaintext": ("poly",)}.get(
                  type(want).__name__)
    if fields is None:
        np.testing.assert_array_equal(to_u32(got), np.asarray(want))
        return
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "elements":
            assert len(g) == len(w)
            for ge, we in zip(g, w):
                np.testing.assert_array_equal(to_u32(ge), np.asarray(we))
        else:
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    if type(want).__name__ == "EvalKey":
        assert got.bv_sh is not None and got.av_sh is not None
    if type(want).__name__ == "Ciphertext":
        assert (got.level, got.noise_deg, got.scale, got.slots,
                got.scale_int, got.metadata) == (
            want.level, want.noise_deg, want.scale, want.slots,
            want.scale_int, want.metadata)
    assert getattr(got, "key_tag", None) == getattr(want, "key_tag", None)


def keyswitch_gen_core(cc, draws, s_old, s_new):
    return hybrid.keyswitch_gen_core(
        draws, s_old, s_new, cc.basis_qp, len(cc.moduli_q),
        cc.params.num_large_digits, cc.p_modq, cc.p_modq_sh,
        cc.noise_scale_int)


def with_fused_tables(cc):
    """cc's level tables with the fused chain's tables attached on the
    CPU, every level."""
    kq = len(cc.moduli_q)
    for size in range(1, kq + 1):
        tabs = cc.hybrid_tables(size)
        cc._hybrid_cache[size] = dataclasses.replace(
            tabs, fused=ks_fused.make_fused_ks_tables(
                tabs.basis_qlp, size, kq, cc.params.num_large_digits,
                ns_int=cc.noise_scale_int))
    return cc


# ---------------------------------------------------------------------------
# the CKKS protocol, recorded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def side():
    jcc = jax_context(3, **CKKS)
    out = {"jcc": jcc}
    kp1 = jcc.MultipartyKeyGen()
    with record_draws() as d2:
        kp2 = jcc.MultipartyKeyGen(kp1.public_key)
    with record_draws() as d3:
        kp3 = jcc.MultipartyKeyGen(kp2.public_key)
    out.update(kp=(kp1, kp2, kp3), keygen_draws=(d2, d3))
    x = np.linspace(0, 1, jcc.slots)
    y = np.linspace(1, 2, jcc.slots)
    cx = jcc.Encrypt(kp3.public_key, jcc.MakeCKKSPackedPlaintext(x))
    cy = jcc.Encrypt(kp3.public_key, jcc.MakeCKKSPackedPlaintext(y))
    csum = jcc.EvalAdd(cx, cy)
    with record_draws() as dd:
        parts = [jcc.MultipartyDecryptLead(csum, kp1.secret_key),
                 jcc.MultipartyDecryptMain(csum, kp2.secret_key),
                 jcc.MultipartyDecryptMain(csum, kp3.secret_key)]
    out.update(x=x, y=y, cx=cx, csum=csum, parts=parts, dec_draws=dd,
               fused=jcc.MultipartyDecryptFusion(parts, csum))
    # the 2-party joint relinearization key (threshold-fhe.cpp's flow)
    s1, s2 = kp1.secret_key, kp2.secret_key
    tag = kp2.public_key.key_tag
    relin = {}
    with record_draws() as d:
        relin["ek1"] = jcc.KeySwitchGen(s1, s1)
    relin["ek1_draws"] = d
    with record_draws() as d:
        relin["ek2"] = jcc.MultiKeySwitchGen(s2, s2, relin["ek1"])
    relin["ek2_draws"] = d
    relin["ek12"] = jcc.MultiAddEvalKeys(relin["ek1"], relin["ek2"], tag)
    with record_draws() as d:
        relin["ek1m"] = jcc.MultiMultEvalKey(relin["ek12"], s1, tag)
        relin["ek2m"] = jcc.MultiMultEvalKey(relin["ek12"], s2, tag)
    relin["mult_draws"] = d
    relin["joint"] = jcc.MultiAddEvalMultKeys(relin["ek1m"], relin["ek2m"],
                                              tag)
    jcc.InsertEvalMultKey(relin["joint"], tag)
    cx2 = jcc.Encrypt(kp2.public_key, jcc.MakeCKKSPackedPlaintext(x))
    relin.update(cx2=cx2, prod=jcc.EvalMult(cx2, cx2))
    out["relin"] = relin
    # the joint rotation keys for +-1
    gs = [rotation_automorphism_index(r, jcc.ring_dim) for r in (1, -1)]
    rot = {"gs": gs}
    with record_draws() as d:
        jcc.EvalAutomorphismKeyGen(s1, gs)
    rot["map1_draws"] = d
    map1 = jcc.eval_automorphism_keys[s1.key_tag]
    with record_draws() as d:
        map2 = jcc.MultiEvalAutomorphismKeyGen(s2, map1, gs)
    rot.update(map1=map1, map2=map2, map2_draws=d,
               joint=jcc.MultiAddAutomorphismKeys(map1, map2, tag))
    jcc.InsertEvalAutomorphismKey(rot["joint"], tag)
    rot["rotated"] = {r: jcc.EvalRotate(cx2, r) for r in (1, -1)}
    out["rot"] = rot
    out["shares"] = jcc.ShareKeys(s1, num_parties=5, threshold=3)
    return out


@pytest.fixture(scope="module")
def port(side):
    """The port's context of the same parameters (CPU), with the JAX
    protocol's outputs rebuilt by the port's cores."""
    cc = port_context(3, **CKKS)
    kp1 = side["kp"][0]
    return dict(cc=cc, sk1=sk(kp1.secret_key), pk1=pk(kp1.public_key))


def test_keygen_and_pub_keys(side, port):
    """Later parties' keygen on JAX's draws; the tags of the port's own
    protocol (the key counter moves for the first party's fresh secret
    too); MultiAddPubKeys."""
    cc = port["cc"]
    prev = port["pk1"]
    for i, draws in enumerate(side["keygen_draws"]):
        want = side["kp"][i + 1]
        assert [tuple(d.shape) for d in draws] == [(256,), (256,)]
        tag = want.secret_key.key_tag.rsplit("+", 1)[1]
        got = mp.multiparty_key_gen_core(cc, prev, tag, draws)
        words_equal(got.public_key, want.public_key)
        words_equal(got.secret_key, want.secret_key)
        prev = got.public_key
    own = port_context(3, **CKKS)
    kps = [own.MultipartyKeyGen()]
    for _ in range(2):
        kps.append(own.MultipartyKeyGen(kps[-1].public_key))
    assert [k.public_key.key_tag for k in kps] == [
        k.public_key.key_tag for k in side["kp"]]
    jpk2, jpk3 = (k.public_key for k in side["kp"][1:])
    want = side["jcc"].MultiAddPubKeys(jpk2, jpk3, "sum")
    words_equal(cc.MultiAddPubKeys(pk(jpk2), pk(jpk3), "sum"), want)


def test_threshold_decryption(side, port):
    """Lead, Main, Main on JAX's smudging draws, then Fusion."""
    cc = port["cc"]
    csum = ct(side["csum"])
    keys = [sk(k.secret_key) for k in side["kp"]]
    draws = side["dec_draws"]
    got = [mp.multiparty_decrypt_lead_core(cc, csum, keys[0], draws[0])]
    got += [mp.multiparty_decrypt_main_core(cc, csum, k, d)
            for k, d in zip(keys[1:], draws[1:])]
    words_equal(got, side["parts"])
    pt = cc.MultipartyDecryptFusion(got, csum)
    want = side["fused"]
    np.testing.assert_array_equal(to_u32(pt.poly), np.asarray(want.poly))
    np.testing.assert_array_equal(pt.values, want.values)
    assert np.abs(pt.values.real - (side["x"] + side["y"])).max() < 1e-3


def test_joint_relin_key(side, port):
    """KeySwitchGen, MultiKeySwitchGen, MultiAddEvalKeys, two
    MultiMultEvalKeys and MultiAddEvalMultKeys on JAX's draws, each with
    companions; EvalMult under the joint key gives JAX's words."""
    cc, relin = port["cc"], side["relin"]
    kp1, kp2 = side["kp"][:2]
    s1, s2 = sk(kp1.secret_key), sk(kp2.secret_key)
    tag = kp2.public_key.key_tag
    ek1 = keyswitch_gen_core(cc, relin["ek1_draws"], s1, s1)
    words_equal(ek1, relin["ek1"])
    ek2 = mp.multi_key_switch_gen_core(cc, s2, s2, ek1, relin["ek2_draws"])
    words_equal(ek2, relin["ek2"])
    ek12 = cc.MultiAddEvalKeys(ek1, ek2, tag)
    words_equal(ek12, relin["ek12"])
    half = len(relin["mult_draws"]) // 2
    ek1m = mp.multi_mult_eval_key_core(cc, ek12, s1,
                                       relin["mult_draws"][:half], tag)
    ek2m = mp.multi_mult_eval_key_core(cc, ek12, s2,
                                       relin["mult_draws"][half:], tag)
    words_equal([ek1m, ek2m], [relin["ek1m"], relin["ek2m"]])
    joint = cc.MultiAddEvalMultKeys(ek1m, ek2m, tag)
    words_equal(joint, relin["joint"])
    cc.InsertEvalMultKey(joint, tag)
    cx2 = ct(relin["cx2"])
    words_equal(cc.EvalMult(cx2, cx2), relin["prod"])


def test_joint_rotation_keys(side, port):
    """Party 1's rotation keys, party 2's shares on their `a`, the joint
    map, and EvalRotate +-1 under it."""
    cc, rot = port["cc"], side["rot"]
    kp1, kp2 = side["kp"][:2]
    s1, s2 = sk(kp1.secret_key), sk(kp2.secret_key)
    tag = kp2.public_key.key_tag
    gs, d1 = rot["gs"], rot["map1_draws"]
    step = len(d1) // len(gs)
    map1 = {}
    for i, g in enumerate(gs):
        s_g = PrivateKey(s_qp=torch.index_select(s1.s_qp, -1,
                                                 cc._auto_idx(g)),
                         key_tag=s1.key_tag)
        map1[g] = keyswitch_gen_core(cc, d1[i * step:(i + 1) * step], s_g,
                                     s1)
    words_equal([map1[g] for g in gs], [rot["map1"][g] for g in gs])
    map2 = mp.multi_eval_automorphism_keygen_core(cc, s2, map1, gs,
                                                  rot["map2_draws"])
    words_equal([map2[g] for g in gs], [rot["map2"][g] for g in gs])
    joint = cc.MultiAddAutomorphismKeys(map1, map2, tag)
    words_equal([joint[g] for g in gs], [rot["joint"][g] for g in gs])
    cc.InsertEvalAutomorphismKey(joint, tag)
    cx2 = ct(side["relin"]["cx2"])
    for r in (1, -1):
        words_equal(cc.EvalRotate(cx2, r), rot["rotated"][r])


def test_joint_keys_run_the_fused_chains(side):
    """The joint keys as the port's protocol returns them, on a context
    with fused tables attached on the CPU: EvalMult and EvalRotate +-1
    give the unfused words (the fused chains refuse a key without
    companions)."""
    ctxs = [port_context(3, **CKKS), with_fused_tables(port_context(
        3, **CKKS))]
    kp1, kp2 = side["kp"][:2]
    relin, rot = side["relin"], side["rot"]
    cx2 = ct(relin["cx2"])
    outs = []
    for cc in ctxs:
        s1, s2 = sk(kp1.secret_key), sk(kp2.secret_key)
        tag = kp2.public_key.key_tag
        ek1 = keyswitch_gen_core(cc, relin["ek1_draws"], s1, s1)
        ek12 = cc.MultiAddEvalKeys(ek1, mp.multi_key_switch_gen_core(
            cc, s2, s2, ek1, relin["ek2_draws"]), tag)
        half = len(relin["mult_draws"]) // 2
        joint = cc.MultiAddEvalMultKeys(*(
            mp.multi_mult_eval_key_core(cc, ek12, s, d, tag) for s, d in (
                (s1, relin["mult_draws"][:half]),
                (s2, relin["mult_draws"][half:]))), tag)
        cc.InsertEvalMultKey(joint, tag)
        cc.InsertEvalAutomorphismKey(
            convert.eval_key_map_from_numpy(
                rot["joint"], device="cpu", moduli_qp=cc.basis_qp.moduli),
            tag)
        prod = cc.EvalMult(cx2, cx2)
        outs.append([prod, cc.Rescale(prod)]
                    + [cc.EvalRotate(cx2, r) for r in (1, -1)]
                    + [cc.EvalMult(cc.Rescale(prod), cc.Rescale(prod))])
    assert ctxs[1].hybrid_tables(4).fused is not None
    assert ctxs[0].hybrid_tables(4).fused is None
    for got, want in zip(*outs):
        for g, w in zip(got.elements, want.elements):
            assert torch.equal(g, w)


def test_share_and_recover(side, port):
    """ShareKeys(5, 3) word-equal to JAX's shares; any 3 recover the
    key."""
    cc = port["cc"]
    s1 = port["sk1"]
    shares = cc.ShareKeys(s1, num_parties=5, threshold=3)
    assert sorted(shares) == sorted(side["shares"])
    for party in shares:
        words_equal(shares[party], side["shares"][party])
    for subset in ((1, 3, 5), (2, 3, 4)):
        rec = cc.RecoverSharedKey({i: shares[i] for i in subset},
                                  key_tag=s1.key_tag)
        assert torch.equal(rec.s_qp, s1.s_qp)
    jrec = convert.shares_from_numpy(side["shares"], device="cpu")
    assert torch.equal(cc.RecoverSharedKey(jrec).s_qp, s1.s_qp)


# ---------------------------------------------------------------------------
# NOISE_FLOODING_MULTIPARTY for BFV and BGV
# ---------------------------------------------------------------------------

SCHEMES = ("BFVRNS_SCHEME", "BGVRNS_SCHEME")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_noise_flooding_chains(scheme):
    """The chains carry the flooding headroom (BGV: ceil(128 / 28) towers
    that ModReduce never drops; BFV: 128 bits of log Q), modulus for
    modulus JAX's."""
    for mode in ("FIXED_NOISE_MULTIPARTY", "NOISE_FLOODING_MULTIPARTY"):
        kw = dict(FLOOD, scheme=scheme, multiparty_mode=mode)
        jcc, cc = jax_context(31, **kw), port_context(31, **kw)
        assert (cc.moduli_q, cc.moduli_p, cc.L) == (
            [int(q) for q in jcc.moduli_q], [int(q) for q in jcc.moduli_p],
            jcc.L)
        if scheme == "BGVRNS_SCHEME":
            assert cc.bgv_flood_towers == jcc.bgv_flood_towers == (
                5 if mode.startswith("NOISE") else 0)
    fixed = port_context(31, **dict(FLOOD, scheme=scheme,
                                     multiparty_mode="FIXED_NOISE_MULTIPARTY"))
    assert len(cc.moduli_q) >= len(fixed.moduli_q) + 4


@pytest.mark.parametrize("scheme", SCHEMES)
def test_noise_flooding_mask_and_decrypt(scheme):
    """The extra-limb mask's core on JAX's draws gives JAX's partial
    decryptions, and the port's own 2-party protocol decrypts exactly."""
    kw = dict(FLOOD, scheme=scheme)
    jcc = jax_context(31, **kw)
    kp1 = jcc.KeyGen()
    kp2 = jcc.MultipartyKeyGen(kp1.public_key)
    v = np.arange(12, dtype=np.int64) + 1
    jct = jcc.Encrypt(kp2.public_key, jcc.MakePackedPlaintext(v))
    with record_draws() as d:
        lead = jcc.MultipartyDecryptLead([jct], kp1.secret_key)[0]
        main = jcc.MultipartyDecryptMain([jct], kp2.secret_key)[0]
    cc = port_context(31, **kw)
    k = len(cc.moduli_q)
    assert [tuple(x.shape) for x in d] == [(k - 1, 512)] * 2
    c = ct(jct)
    got = [mp.multiparty_decrypt_lead_core(cc, c, sk(kp1.secret_key), d[0]),
           mp.multiparty_decrypt_main_core(cc, c, sk(kp2.secret_key), d[1])]
    words_equal(got, [lead, main])
    out = cc.MultipartyDecryptFusion(got, c)
    assert np.asarray(out.values[:12]).tolist() == v.tolist()
    # the port's own protocol, its own draws
    k1 = cc.KeyGen()
    k2 = cc.MultipartyKeyGen(k1.public_key)
    x = cc.Encrypt(k2.public_key, cc.MakePackedPlaintext(v))
    if scheme == "BGVRNS_SCHEME":
        x = cc.ModReduce(x)
    parts = [cc.MultipartyDecryptLead([x], k1.secret_key)[0],
             cc.MultipartyDecryptMain([x], k2.secret_key)[0]]
    out = cc.MultipartyDecryptFusion(parts, x)
    assert np.asarray(out.values[:12]).tolist() == v.tolist()


def test_smudge_draw_statistics():
    """The port's own draws: the Gaussian smudge has sigma 2^17 under
    NOISE_FLOODING_MULTIPARTY for CKKS (int32 holds its 6 sigma clip) and
    3.19 otherwise; the extra-limb mask is uniform over each tower of
    Q' = Q / q_0 (range and mean)."""
    for mode, sigma in (("NOISE_FLOODING_MULTIPARTY", 2.0 ** 17),
                        ("FIXED_NOISE_MULTIPARTY", 3.19)):
        cc = port_context(5, **dict(CKKS, multiparty_mode=mode))
        x = torch.cat([mp.smudge_draw(cc, cc.basis_q) for _ in range(64)])
        assert x.dtype == torch.int32
        assert abs(x.double().std().item() / sigma - 1) < 0.02
        assert x.abs().max().item() <= 6 * sigma + 1
    cc = port_context(5, **dict(FLOOD, scheme="BFVRNS_SCHEME"))
    masks = torch.stack([mp.smudge_draw(cc, cc.basis_q)
                         for _ in range(16)]).long()
    q = torch.tensor(cc.moduli_q[1:]).view(-1, 1)
    assert masks.shape[1:] == (len(cc.moduli_q) - 1, 512)
    assert bool((masks >= 0).all()) and bool((masks < q).all())
    mean = masks.double().mean(dim=(0, 2)) / q.view(-1).double()
    assert float((mean - 0.5).abs().max()) < 0.01


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """Without a card every entry point raises unless given the CPU: the
    context factory, deserialize and deserialize_context, and convert."""
    from openfhe_tpu_torch.utils import serialization as ser
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _params(fhe.pke.constants, fhe.CCParams, **CKKS)
    cc = fhe.GenCryptoContext(params, seed=3, device="cpu")
    kp = cc.KeyGen()
    record = ser.serialize_context(cc)
    calls = {
        "GenCryptoContext": lambda: fhe.GenCryptoContext(params, seed=3),
        "CryptoContextFactory": lambda: ser.CryptoContextFactory.get_context(
            params),
        "deserialize_context": lambda: ser.deserialize_context(record),
        "deserialize": lambda: ser.deserialize(ser.serialize(kp.public_key)),
        "deserialize a record": lambda: ser.deserialize(record.encode()),
        "shares_from_numpy": lambda: convert.shares_from_numpy(
            {1: np.zeros((2, 4), np.uint32)}),
        "eval_key_from_jax": lambda: convert.eval_key_from_jax(
            types.SimpleNamespace(bv=np.zeros((1, 2, 4), np.uint32),
                                  av=np.zeros((1, 2, 4), np.uint32),
                                  key_tag=""), (17, 97))}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert isinstance(ser.deserialize(ser.serialize(kp.public_key),
                                      device="cpu"), PublicKey)
    assert ser.deserialize_context(record, device="cpu").device.type == "cpu"
    ser.CryptoContextFactory.release_all_contexts()
