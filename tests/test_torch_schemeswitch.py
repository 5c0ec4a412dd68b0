"""The port's CKKS <-> FHEW scheme switching (`pke/schemeswitch.py`)
against the JAX package, word for word.

One module fixture makes the JAX context of `tests/test_schemeswitch.py`
(N = 1024, depth 16, 28/30-bit moduli, FLEXIBLEAUTO, 8 slots, the TOY
FHEW side with a 17-bit q_LWE, seed 2), its keys and every JAX result the
tests compare with: EvalCKKStoFHEW at p_LWE = 16, EvalFHEWtoCKKS of eight
bits, EvalCompareSchemeSwitching at p_LWE = 8 and EvalMin / EvalMax over
two values (one tournament round; the indicator's fresh encryption is the
JAX one on both sides). `convert` carries the keys (the CKKS eval keys,
the Q' switching key, the FHEW -> CKKS key and the inner BinFHE context's
keys) into the port's context of the same parameters on the CPU. The
setup state, the S2C diagonals and every output must equal the JAX
package's; EvalMin over four values is checked against the plaintext
alone. The port's plaintext cache keeps no per-call diagonal of
EvalFHEWtoCKKS, and a second precompute drops the S2C encodings it
replaces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from openfhe_tpu.binfhe import lwe as jlwe  # noqa: E402
from openfhe_tpu.pke.constants import PKESchemeFeature as JFeature  # noqa
from openfhe_tpu.pke.schemeswitch import SchSwchParams as JParams  # noqa

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke.constants import PKESchemeFeature  # noqa: E402
from openfhe_tpu_torch.pke import schemeswitch as ssw  # noqa: E402
from test_torch_bgv import (carry_keys, ct as port_ct, jax_context,  # noqa
                            port_context)
from test_torch_binfhe import _exact_mod_switch  # noqa: E402

SLOTS = 8
CKKS = dict(scheme="CKKSRNS_SCHEME", ring_dim=1024, mult_depth=16,
            scaling_mod_size=28, first_mod_size=30, batch_size=SLOTS,
            scaling_technique="FLEXIBLEAUTO")
SWITCH = dict(security_level_fhew="TOY", num_slots_ckks=SLOTS,
              ctxt_mod_size_fhew_large_prec=17,
              ctxt_mod_size_fhew_intermed_swch=27)
X = np.arange(SLOTS, dtype=np.float64)
BITS = np.array([0, 1, 1, 0, 1, 0, 0, 1])
X1 = np.array([0.1, 0.5, 0.9, 0.2, 0.7, 0.3, 0.6, 0.4])
X2 = np.array([0.5, 0.5, 0.1, 0.8, 0.2, 0.9, 0.1, 0.45])
VALS = np.array([0.6, 0.2, 0.8, 0.4, 0, 0, 0, 0])


def same(got, want):
    """Equal words, level, noise degree, slots and scale."""
    assert len(got.elements) == len(want.elements)
    for g, w in zip(got.elements, want.elements):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)
    assert got.scale == want.scale


def same_lwe(got, want):
    assert (got.modulus, got.pt_modulus) == (want.modulus, want.pt_modulus)
    np.testing.assert_array_equal(to_u32(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_u32(got.b), np.asarray(want.b))


def _recording(jcc, name):
    """jcc.<name> recording its results (an instance attribute)."""
    rec, orig = [], getattr(jcc, name)

    def call(*args, **kw):
        rec.append(orig(*args, **kw))
        return rec[-1]
    setattr(jcc, name, call)
    return rec


@pytest.fixture(scope="module")
def ssw_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlwe, "mod_switch_device", _exact_mod_switch)
        jcc = jax_context(2, **CKKS)
        jcc.Enable(JFeature.SCHEMESWITCH)
        jlwe_sk = jcc.EvalSchemeSwitchingSetup(JParams(**SWITCH))
        kp = jcc.KeyGen()
        jcc.EvalMultKeyGen(kp.secret_key)
        jcc.EvalSchemeSwitchingKeyGen(kp, jlwe_sk)
        jbin = jcc.GetBinCCForSchemeSwitch()
        jbin.BTKeyGen(jlwe_sk)
        jst = jcc._schswch
        enc = lambda v: jcc.Encrypt(
            kp.public_key, jcc.MakeCKKSPackedPlaintext(v, slots=SLOTS))
        jin = dict(x=enc(X), x1=enc(X1), x2=enc(X2), vals=enc(VALS),
                   bits=jbin.Encrypt(jlwe_sk, jnp.asarray(BITS, jnp.uint32),
                                     p=4, q=jst.modulus_lwe))
        jcc.EvalCKKStoFHEWPrecompute(scale=1.0 / 16)
        want = dict(diags16=[d.copy() for d in jst.s2c_diags],
                    pt_slots=jst.s2c_pt_slots,
                    to_fhew=jcc.EvalCKKStoFHEW(jin["x"], SLOTS),
                    to_ckks=jcc.EvalFHEWtoCKKS(jin["bits"], SLOTS, SLOTS))
        jcc.EvalCompareSwitchPrecompute(p_lwe=8, scale_sign=1.0)
        want["compare"] = jcc.EvalCompareSchemeSwitching(
            jin["x1"], jin["x2"], SLOTS, SLOTS)
        for name, fn in (("min", jcc.EvalMinSchemeSwitching),
                         ("max", jcc.EvalMaxSchemeSwitching)):
            rec = _recording(jcc, "Encrypt")
            want[name] = fn(jin["vals"], kp.public_key, 2, SLOTS, p_lwe=8)
            want[name + "_ind_input"] = rec[0]
            del jcc.Encrypt

    cc = port_context(2, **CKKS)
    cc.Enable(PKESchemeFeature.SCHEMESWITCH)
    cc.EvalSchemeSwitchingSetup(ssw.SchSwchParams(**SWITCH))
    state_before_keys = (cc._schswch.q_prime, cc._schswch.modulus_lwe,
                         cc._schswch.n_lwe, cc._schswch.slots)
    cc.EvalFHEWtoCKKSSetup()            # keeps the state it finds
    assert cc.GetBinCCForSchemeSwitch() is cc._schswch.cc_lwe
    sk = carry_keys(jcc, cc, kp)
    lwe_sk = convert.scheme_switch_keys_from_jax(cc, jst, device="cpu")
    ins = {k: port_ct(v) for k, v in jin.items() if k != "bits"}
    ins["bits"] = convert.lwe_ciphertext_from_numpy(
        np.asarray(jin["bits"].a), np.asarray(jin["bits"].b),
        jin["bits"].modulus, jin["bits"].pt_modulus, device="cpu")
    return dict(jcc=jcc, jst=jst, cc=cc, sk=sk, lwe_sk=lwe_sk, kp=kp,
                ins=ins, want=want, state=state_before_keys)


def test_setup_state_matches_jax(ssw_pair):
    """Q', q_LWE, n, the slots, P of the Q' switch, the inner context's
    ring on the CKKS context's device and the FHEW -> CKKS seed."""
    cc, jcc, jst = ssw_pair["cc"], ssw_pair["jcc"], ssw_pair["jst"]
    st = cc._schswch
    assert ssw_pair["state"] == (jst.q_prime, jst.modulus_lwe, jst.n_lwe,
                                 jst.slots)
    assert st.basis_int.moduli == (jst.q_prime,)
    p_aux = ssw.aux_modulus(cc, st.q_prime)
    assert st.swk_tabs.basis_p.moduli == (p_aux,)
    jp = tuple(int(m) for m in jst.swk_tabs.basis_p.moduli)
    assert jp == (p_aux,)
    inner, jinner = st.cc_lwe, jst.cc_lwe
    assert (inner.n, inner.N, inner.q, inner.Q, inner.q_ks) == (
        jinner.n, jinner.N, jinner.q, jinner.Q, jinner.q_ks)
    assert inner.device == cc.device
    assert st.s2c_bstep == jst.s2c_bstep
    assert st.k_bound == jst.k_bound
    assert ssw._mod_func_coefficients(jst.k_bound, 3) == list(jst.cheb_fhew)
    np.testing.assert_array_equal(
        cc.Decrypt(ssw_pair["sk"], cc.GetSwkFC()).values.real[:jst.n_lwe]
        .round(), ssw_pair["lwe_sk"].s.numpy())


def test_s2c_diagonals_match_jax(ssw_pair):
    cc = ssw_pair["cc"]
    cc.EvalCKKStoFHEWPrecompute(scale=1.0 / 16)
    st = cc._schswch
    want = ssw_pair["want"]["diags16"]
    assert len(st.s2c_diags) == len(want)
    assert st.s2c_pt_slots == ssw_pair["want"]["pt_slots"]
    for got, w in zip(st.s2c_diags, want):
        np.testing.assert_array_equal(got, w)


def test_ckks_to_fhew_words(ssw_pair):
    cc = ssw_pair["cc"]
    cc.EvalCKKStoFHEWPrecompute(scale=1.0 / 16)
    out = cc.EvalCKKStoFHEW(ssw_pair["ins"]["x"], SLOTS)
    same_lwe(out, ssw_pair["want"]["to_fhew"])
    got = cc.GetBinCCForSchemeSwitch().Decrypt(
        ssw_pair["lwe_sk"], out.replace(pt_modulus=16))
    np.testing.assert_array_equal(got, X.astype(np.int64))


def test_fhew_to_ckks_words(ssw_pair):
    cc = ssw_pair["cc"]
    out = cc.EvalFHEWtoCKKS(ssw_pair["ins"]["bits"], SLOTS, SLOTS)
    same(out, ssw_pair["want"]["to_ckks"])
    dec = cc.Decrypt(ssw_pair["sk"], out).values.real[:SLOTS]
    assert np.abs(dec - BITS).max() < 0.05


def test_compare_words(ssw_pair):
    cc = ssw_pair["cc"]
    cc.EvalCompareSwitchPrecompute(p_lwe=8, scale_sign=1.0)
    out = cc.EvalCompareSchemeSwitching(ssw_pair["ins"]["x1"],
                                        ssw_pair["ins"]["x2"], SLOTS, SLOTS)
    same(out, ssw_pair["want"]["compare"])
    dec = cc.Decrypt(ssw_pair["sk"], out).values.real[:SLOTS]
    assert np.abs(dec - (X1 < X2)).max() < 0.1


@pytest.mark.parametrize("which", ["min", "max"])
def test_min_max_two_values_words(ssw_pair, which, monkeypatch):
    """One tournament round; the indicator's encryption of ones is the
    JAX one on both sides."""
    cc, want = ssw_pair["cc"], ssw_pair["want"]
    monkeypatch.setattr(cc, "Encrypt", lambda *a, **k: port_ct(
        want[which + "_ind_input"]))
    fn = (cc.EvalMinSchemeSwitching if which == "min"
          else cc.EvalMaxSchemeSwitching)
    val, ind = fn(ssw_pair["ins"]["vals"], ssw_pair["kp"].public_key, 2,
                  SLOTS, p_lwe=8)
    same(val, want[which][0])
    same(ind, want[which][1])
    pick = min if which == "min" else max
    dec = cc.Decrypt(ssw_pair["sk"], val).values.real[0]
    assert abs(dec - pick(VALS[:2])) < 0.05


def test_min_argmin_four_values(ssw_pair):
    """Two tournament rounds on the port alone: the min and the one-hot
    argmin against the plaintext."""
    cc, sk, jpk = ssw_pair["cc"], ssw_pair["sk"], ssw_pair["kp"].public_key
    pk = convert.public_key_from_numpy(np.asarray(jpk.b), np.asarray(jpk.a),
                                       key_tag=jpk.key_tag, device="cpu")
    ct = cc.Encrypt(pk, cc.MakeCKKSPackedPlaintext(VALS, slots=SLOTS))
    val, ind = cc.EvalMinSchemeSwitching(ct, pk, 4, SLOTS, p_lwe=8)
    assert abs(cc.Decrypt(sk, val).values.real[0] - VALS[:4].min()) < 0.05
    got = cc.Decrypt(sk, ind).values.real[:4]
    assert np.abs(got - (VALS[:4] == VALS[:4].min())).max() < 0.1


def test_fhew_to_ckks_keeps_no_diagonals(ssw_pair):
    """Two EvalFHEWtoCKKS calls leave the plaintext cache as one does: the
    per-call diagonals are encoded and dropped."""
    cc = ssw_pair["cc"]
    bits = ssw_pair["ins"]["bits"]
    before = len(cc._pt_cache)
    first = cc.EvalFHEWtoCKKS(bits, SLOTS, SLOTS)
    one = len(cc._pt_cache)
    second = cc.EvalFHEWtoCKKS(bits, SLOTS, SLOTS)
    assert len(cc._pt_cache) == one == before
    same(second, ssw_pair["want"]["to_ckks"])
    same(first, ssw_pair["want"]["to_ckks"])


def test_second_precompute_drops_replaced_entries(ssw_pair):
    """EvalCKKStoFHEW caches the S2C encodings; a precompute that
    replaces the diagonals drops them, and the next call caches the new
    ones alone."""
    cc = ssw_pair["cc"]
    st = cc._schswch
    cc.EvalCKKStoFHEWPrecompute(scale=1.0 / 16)
    base = len(cc._pt_cache)
    cc.EvalCKKStoFHEW(ssw_pair["ins"]["x"], SLOTS)
    cached = len(cc._pt_cache)
    old = {id(d) for d in st.s2c_diags}
    assert cached - base == len(st.s2c_diags)
    cc.EvalCompareSwitchPrecompute(p_lwe=8, scale_sign=1.0)
    assert len(cc._pt_cache) == base
    assert not any(k[0] in old for k in cc._pt_cache)
    cc.EvalCKKStoFHEW(ssw_pair["ins"]["x"], SLOTS)
    assert len(cc._pt_cache) == cached


def test_inner_context_and_accessors(ssw_pair):
    """The inner BinFHE context sits on the CKKS context's device; the
    getters and setters swap what they name."""
    cc = ssw_pair["cc"]
    inner = cc.GetBinCCForSchemeSwitch()
    assert inner.device == cc.device == torch.device("cpu")
    assert inner.bt_key.device == cc.device
    swk = cc.GetSwkFC()
    cc.SetSwkFC(None)
    assert cc.GetSwkFC() is None
    cc.SetSwkFC(swk)
    cc.SetBinCCForSchemeSwitch(None)
    assert cc.GetBinCCForSchemeSwitch() is None
    cc.SetBinCCForSchemeSwitch(inner)
    assert cc.EvalMinSchemeSwitchingAlt == cc.EvalMinSchemeSwitching
