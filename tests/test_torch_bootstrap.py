"""The port's CKKS bootstrap and EvalFBT / EvalMVB against the JAX package,
word for word.

Every pipeline runs on `tests/test_bootstrap.py`'s context
(`make_boot_ctx(64)`: N=64, depth 18, 28/30-bit moduli, FLEXIBLEAUTO,
seed 11), so that the JAX side's compiles are shared among the pipelines
here and with that file's through the persistent compile cache. One
module fixture makes the JAX keys and ciphertexts, carried into the
port's CPU context by `convert`, and runs the JAX package's EvalBootstrap,
EvalBootstrapStCFirst, the functional bootstrap's precompute and its LUTs
(full packing: the bootstrap's 32-slot precompute with the exponential
seed added) and the steps once. Each test compares the port's words,
level, noise degree and scale with the JAX result. ModRaise of a
composite chain runs on that file's composite context (N=256, depth 14,
50/56-bit, seed 4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from openfhe_tpu.pke.ciphertext import Ciphertext as JCiphertext  # noqa
from openfhe_tpu.pke.fhe import ckks_bootstrap as jbt  # noqa: E402
from openfhe_tpu.pke.fhe import fft_transform as jfftt  # noqa: E402
from openfhe_tpu.pke.schemelet import SchemeletRLWEMP as JSL  # noqa: E402

from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke.fhe import ckks_bootstrap as bt  # noqa: E402
from openfhe_tpu_torch.pke.fhe import fft_transform as fftt  # noqa: E402
from openfhe_tpu_torch.pke.schemelet import SchemeletRLWEMP as SL  # noqa
from openfhe_tpu_torch.utils.precision import \
    calculate_approximation_error  # noqa: E402
from test_bootstrap import make_boot_ctx  # noqa: E402
from test_torch_bgv import (carry_keys, ct as port_ct, jax_context,  # noqa
                            port_context)

BOOT = dict(scheme="CKKSRNS_SCHEME", mult_depth=18, scaling_mod_size=28,
            first_mod_size=30, scaling_technique="FLEXIBLEAUTO")
COMPOSITE = dict(scheme="CKKSRNS_SCHEME", ring_dim=256, mult_depth=14,
                 scaling_mod_size=50, first_mod_size=56, batch_size=8,
                 scaling_technique="COMPOSITESCALINGAUTO")
N, SLOTS, STAGED_SLOTS, P_IN = 64, 32, 16, 8
DIGITS = np.arange(SLOTS) * 5 % P_IN
LUTS = (np.array([1, 2, 4, 0, 6, 3, 7, 5]), np.arange(P_IN) ** 2 % P_IN)


def same(got, want):
    """Equal words, level, noise degree, slots and scale."""
    assert len(got.elements) == len(want.elements)
    for g, w in zip(got.elements, want.elements):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)
    assert got.scale == want.scale


@pytest.fixture(scope="module")
def boot():
    """make_boot_ctx(64) with the dense full-slot precompute and a (2, 2)
    staged one at 16 slots, its keys and ciphertexts, and every JAX
    result the tests compare with."""
    jcc = make_boot_ctx(N)
    jcc.EvalBootstrapSetup(slots=SLOTS)
    jcc.EvalBootstrapSetup(level_budget=(2, 2), slots=STAGED_SLOTS)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalBootstrapKeyGen(kp.secret_key, SLOTS)
    jcc.EvalBootstrapKeyGen(kp.secret_key, STAGED_SLOTS)
    x = np.random.default_rng(5).uniform(-1, 1, SLOTS)
    jct = jcc.Encrypt(kp.public_key,
                      jcc.MakeCKKSPackedPlaintext(x, slots=SLOTS))
    jlast = jcc.LevelReduce(jct, len(jcc.scf_real) - 1)
    jraised = jbt.mod_raise(jcc, jlast)
    jlt_in = jcc.ModReduce(jraised)
    p = jcc._boot_precom[SLOTS]
    p16 = jcc._boot_precom[STAGED_SLOTS]
    want = dict(
        boot=jcc.EvalBootstrap(jct),
        stc=jcc.EvalBootstrapStCFirst(jct),
        raise1=jraised,
        lt=jbt.eval_linear_transform(jcc, jlt_in, p.c2s_diags, p.bstep_enc,
                                     p.pt_slots),
        stages=jfftt.eval_fft_stages(jcc, jlt_in, p16.c2s_stages,
                                     p16.pt_slots),
        monomial=jbt.mult_by_monomial(jcc, jlt_in, 3 * SLOTS + 5),
        integer=jbt.mult_by_integer(jcc, jlt_in, 16),
    )
    # the functional bootstrap on the same context: the schemelet's digits
    # at scale q0 / p on the last level
    jcc.EvalFBTSetup(num_slots=SLOTS, p_in=P_IN)
    q0, last = jcc.moduli_q[0], len(jcc.moduli_q) - 1
    polys = JSL.encrypt_coeff(jcc, kp.secret_key, DIGITS, q0, P_IN,
                              level=last)
    jfct = JSL.convert_rlwe_to_ckks(jcc, polys, q0, slots=SLOTS, level=last,
                                    scale=q0 / P_IN).replace(
                                        key_tag=kp.secret_key.key_tag)
    powers = jcc.EvalMVBPrecompute(jfct, P_IN)
    want["mvb"] = [jcc.EvalMVBNoDecoding(powers, lut, P_IN) for lut in LUTS]
    want["decoded"] = jcc.EvalMVB(powers, LUTS[0], P_IN)

    cc = port_context(11, ring_dim=N, **BOOT)
    cc.EvalBootstrapSetup(slots=SLOTS)
    cc.EvalBootstrapSetup(level_budget=(2, 2), slots=STAGED_SLOTS)
    sk = carry_keys(jcc, cc, kp)
    fct = SL.convert_rlwe_to_ckks(cc, polys, q0, slots=SLOTS, level=last,
                                  scale=q0 / P_IN)
    same(fct, jfct)
    return dict(jcc=jcc, cc=cc, sk=sk, x=x, jct=jct, ct=port_ct(jct),
                last=port_ct(jlast), lt_in=port_ct(jlt_in), want=want,
                fct=dataclasses.replace(fct, key_tag=kp.secret_key.key_tag))


@pytest.mark.parametrize("comp_deg", [1, 2])
def test_mod_raise_matches_jax(boot, comp_deg):
    if comp_deg == 1:
        same(bt.mod_raise(boot["cc"], boot["last"]), boot["want"]["raise1"])
        return
    # any words are a ciphertext of the last level (its two towers): no
    # keys needed
    jcc = jax_context(4, **COMPOSITE)
    assert jcc.comp_deg == 2
    rng = np.random.default_rng(1)
    last = len(jcc.scf_real) - 1
    words = [np.array([rng.integers(0, q, jcc.ring_dim) for q in
                       jcc.moduli_q[:2]], np.uint32) for _ in range(2)]
    jct = JCiphertext(elements=tuple(jnp.asarray(w) for w in words),
                      level=last, scale=jcc.scf_real[last], slots=8)
    cc = port_context(4, **COMPOSITE)
    same(bt.mod_raise(cc, port_ct(jct)), jbt.mod_raise(jcc, jct))
    assert ("modraise", tuple(cc.moduli_q[:2]), tuple(cc.moduli_q)) in \
        cc._modraise_cache


def test_mult_by_monomial_and_integer_match_jax(boot):
    cc, x = boot["cc"], boot["lt_in"]
    same(bt.mult_by_monomial(cc, x, 3 * SLOTS + 5), boot["want"]["monomial"])
    same(bt.mult_by_integer(cc, x, 16), boot["want"]["integer"])


def test_eval_linear_transform_matches_jax(boot):
    cc = boot["cc"]
    p = cc._boot_precom[SLOTS]
    same(bt.eval_linear_transform(cc, boot["lt_in"], p.c2s_diags,
                                  p.bstep_enc, p.pt_slots),
         boot["want"]["lt"])


def test_eval_fft_stages_matches_jax(boot):
    cc = boot["cc"]
    p = cc._boot_precom[STAGED_SLOTS]
    assert len(p.c2s_stages) == 2
    same(fftt.eval_fft_stages(cc, boot["lt_in"], p.c2s_stages, p.pt_slots),
         boot["want"]["stages"])


def test_eval_bootstrap_matches_jax(boot):
    cc = boot["cc"]
    out = cc.EvalBootstrap(boot["ct"])
    same(out, boot["want"]["boot"])
    assert cc.size_ql(out.level) > 2
    dec = cc.Decrypt(boot["sk"], out)
    assert calculate_approximation_error(dec.values, boot["x"]) > 4.0


def test_two_round_bootstrap_matches_jax(boot):
    """EvalBootstrap(ct, num_iterations=2) on the same JAX-made
    ciphertext: the JAX words, level, noise degree and scale."""
    cc = boot["cc"]
    want = boot["jcc"].EvalBootstrap(boot["jct"], num_iterations=2)
    out = cc.EvalBootstrap(boot["ct"], num_iterations=2)
    same(out, want)
    assert cc.size_ql(out.level) > 2
    dec = cc.Decrypt(boot["sk"], out)
    assert calculate_approximation_error(dec.values, boot["x"]) > 4.0


def test_eval_bootstrap_stc_first_matches_jax(boot):
    cc = boot["cc"]
    out = cc.EvalBootstrapStCFirst(boot["ct"])
    same(out, boot["want"]["stc"])
    assert cc.size_ql(out.level) > 2
    dec = cc.Decrypt(boot["sk"], out)
    assert calculate_approximation_error(dec.values, boot["x"]) > 4.0


@pytest.fixture(scope="module")
def fbt(boot):
    """The port's functional-bootstrap setup on the bootstrap's context:
    its exponential seed is the JAX one within 1e-12."""
    cc = boot["cc"]
    cc.EvalFBTSetup(num_slots=SLOTS, p_in=P_IN)
    np.testing.assert_allclose(
        cc._boot_precom[SLOTS].exp_coeffs,
        boot["jcc"]._boot_precom[SLOTS].exp_coeffs, rtol=0, atol=1e-12)
    return boot


def test_eval_fbt_matches_jax(fbt):
    """EvalFBT in slot form: the JAX words (of EvalMVB on JAX's shared
    powers, which is what its EvalFBT runs), and the LUT back exactly
    after rounding."""
    cc = fbt["cc"]
    out = cc.EvalFBT(fbt["fct"], LUTS[0], P_IN, decode=False)
    same(out, fbt["want"]["mvb"][0])
    got = cc.Decrypt(fbt["sk"], out).values.real
    np.testing.assert_array_equal(np.round(got), LUTS[0][DIGITS])


def test_eval_fbt_decoded_matches_jax(fbt):
    """EvalFBT with EvalHomDecoding: the JAX words, then through the
    schemelet back to the LUT's digits mod p."""
    cc = fbt["cc"]
    out = cc.EvalFBT(fbt["fct"], LUTS[0], P_IN)
    same(out, fbt["want"]["decoded"])
    q_level = SL.get_q_prime(cc, len(cc.moduli_q) - cc.size_ql(out.level))
    back = SL.convert_ckks_to_rlwe(cc, out, q_level)
    dec = SL.decrypt_coeff(cc, fbt["sk"], back, q_level, P_IN,
                           level=out.level, num_slots=SLOTS)
    np.testing.assert_array_equal(dec % P_IN, LUTS[0][DIGITS] % P_IN)


def test_eval_mvb_shared_powers_match_jax(fbt):
    """One EvalMVBPrecompute, two LUTs in slot form and one decoded: each
    the JAX words."""
    cc = fbt["cc"]
    powers = cc.EvalMVBPrecompute(fbt["fct"], P_IN)
    for lut, want in zip(LUTS, fbt["want"]["mvb"]):
        out = cc.EvalMVBNoDecoding(powers, lut, P_IN)
        same(out, want)
        got = cc.Decrypt(fbt["sk"], out).values.real
        np.testing.assert_array_equal(np.round(got), lut[DIGITS])
    same(cc.EvalFBTNoDecoding(fbt["fct"], LUTS[0], P_IN),
         fbt["want"]["mvb"][0])
    same(cc.EvalHomDecoding(cc.EvalMVBNoDecoding(powers, LUTS[0], P_IN),
                            P_IN, SLOTS), fbt["want"]["decoded"])


def test_stc_first_counts_composite_levels():
    """EvalBootstrapStCFirst under composite scaling (N=256, two towers a
    level), port alone: an input with fewer than l_dec + 2 levels is
    refused, and a fresh one comes back within the floor. The JAX package
    compares that bound with the input's towers, so a composite input one
    level short passes its check and ModRaise gets no tower (ROADMAP queue
    3, faults in the reference); there is no JAX result to compare."""
    cc = port_context(4, **COMPOSITE)
    cc.EvalBootstrapSetup(slots=8)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalBootstrapKeyGen(kp.secret_key, 8)
    x = np.random.default_rng(5).uniform(-1, 1, 8)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    short = cc.LevelReduce(ct, len(cc.scf_real) - 2)
    assert cc.size_ql(short.level) == 4 >= 3
    with pytest.raises(ValueError, match="3 levels"):
        cc.EvalBootstrapStCFirst(short)
    out = cc.EvalBootstrapStCFirst(ct)
    dec = cc.Decrypt(kp.secret_key, out)
    assert calculate_approximation_error(dec.values, x) > 4.0
