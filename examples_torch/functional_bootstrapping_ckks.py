"""Vectorized functional bootstrapping over CKKS on the port (EvalFBT).

Counterpart of `examples/functional_bootstrapping_ckks.py` (reference:
src/pke/examples/functional-bootstrapping-ckks.cpp): a lookup table
applied to a batch of Z_8 digits packed in one RLWE ciphertext, through
the CKKS schemelet. On the GPU unless `--device cpu`:

    python examples_torch/functional_bootstrapping_ckks.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)
from openfhe_tpu_torch.pke.schemelet import (  # noqa: E402
    SchemeletRLWEMP as SL)

DIGITS = np.array([0, 3, 1, 7, 2, 6, 5, 4])
LUT = np.array([1, 2, 4, 0, 6, 3, 7, 5])     # an arbitrary f: Z_8 -> Z_8


def main(device=None, ring_dim=512, mult_depth=22, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=14, slots=8, p_in=8) -> dict:
    """f(digits) through EvalFBT, rounded, beside the table's values."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=slots,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.FHE):
        cc.Enable(f)

    cc.EvalFBTSetup(num_slots=slots, p_in=p_in)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalFBTKeyGen(keys.secret_key, slots)

    q0 = cc.moduli_q[0]
    last = len(cc.moduli_q) - 1
    ct_polys = SL.encrypt_coeff(cc, keys.secret_key, DIGITS, q0, p_in,
                                level=last)
    ct = SL.convert_rlwe_to_ckks(cc, ct_polys, q0, slots=slots, level=last,
                                 scale=q0 / p_in)
    ct = ct.replace(key_tag=keys.secret_key.key_tag)

    res = cc.EvalFBT(ct, LUT, p_in, decode=False)
    got = np.round(np.asarray(
        cc.Decrypt(keys.secret_key, res).values).real[:slots]).astype(int)
    print("digits:", DIGITS)
    print("f(digits):", got, "expected:", LUT[DIGITS])
    assert np.array_equal(got, LUT[DIGITS])
    print("OK")
    return {"checks": {"f(digits)": exact(got, LUT[DIGITS])}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
