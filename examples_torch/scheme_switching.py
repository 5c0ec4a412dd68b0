"""CKKS <-> FHEW scheme switching and an encrypted comparison on the port.

Counterpart of `examples/scheme_switching.py` (reference:
src/pke/examples/scheme-switching.cpp): CKKS slots moved into LWE
ciphertexts, and x1 < x2 computed through FHEW's sign. On the GPU unless
`--device cpu`:

    python examples_torch/scheme_switching.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import bits, close, exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)
from openfhe_tpu_torch.pke.schemeswitch import SchSwchParams  # noqa: E402

CMP_TOL = 0.1   # tests/test_schemeswitch.py's limit; the example asserts none


def main(device=None, ring_dim=1024, mult_depth=16, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=0, slots=8, security_level_fhew="TOY", large_prec=17,
         p_lwe=16) -> dict:
    """EvalCKKStoFHEW of 0 ... 7 and EvalCompareSchemeSwitching of two
    vectors; returns each decryption beside what it should be."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=slots,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.SCHEMESWITCH, PKESchemeFeature.FHE):
        cc.Enable(f)

    sp = SchSwchParams(security_level_fhew=security_level_fhew,
                       num_slots_ckks=slots,
                       ctxt_mod_size_fhew_large_prec=large_prec)
    lwe_sk = cc.EvalSchemeSwitchingSetup(sp)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalSchemeSwitchingKeyGen(keys, lwe_sk)
    cc.GetBinCCForSchemeSwitch().BTKeyGen(lwe_sk)

    # CKKS -> FHEW: integer slots into LWE ciphertexts
    cc.EvalCKKStoFHEWPrecompute(scale=1.0 / p_lwe)
    x = np.arange(slots, dtype=float)
    ct = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x, slots=slots))
    lwe_cts = cc.EvalCKKStoFHEW(ct, slots)
    dec = bits(cc.GetBinCCForSchemeSwitch().Decrypt(
        lwe_sk, lwe_cts.replace(pt_modulus=p_lwe)))
    print("CKKS->FHEW:", dec, "expected:", x.astype(int))

    # an encrypted comparison through FHEW's sign
    cc.EvalCompareSwitchPrecompute(p_lwe=8)
    x1 = np.array([0.1, 0.5, 0.9, 0.2, 0.7, 0.3, 0.6, 0.4])
    x2 = np.array([0.5, 0.5, 0.1, 0.8, 0.2, 0.9, 0.1, 0.45])
    c1 = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x1, slots=slots))
    c2 = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x2, slots=slots))
    cmp_ct = cc.EvalCompareSchemeSwitching(c1, c2, slots, slots)
    got = np.asarray(cc.Decrypt(keys.secret_key, cmp_ct).values).real[:slots]
    want = (x1 < x2).astype(float)
    print("x1 < x2  :", np.round(got, 2), "expected:", want)
    return {"checks": {"CKKS->FHEW": exact(dec, x.astype(int)),
                       "x1 < x2": close(got, want, CMP_TOL)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
