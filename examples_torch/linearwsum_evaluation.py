"""A linear weighted sum of five ciphertexts on the port (CKKS).

Counterpart of `examples/linearwsum_evaluation.py` (reference:
src/pke/examples/linearwsum-evaluation.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/linearwsum_evaluation.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import close  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)

TOL = 1e-2


def main(device=None, ring_dim=512, mult_depth=2, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=12, data_seed=0) -> dict:
    """EvalLinearWSum of five random vectors with real weights; returns
    the decryption beside what it should be."""
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, scaling_mod_size=scaling_mod_size,
                 first_mod_size=first_mod_size, batch_size=8,
                 security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.ADVANCEDSHE)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)

    rng = np.random.default_rng(data_seed)
    vecs = [rng.uniform(-1, 1, 8) for _ in range(5)]
    weights = [3.0, 1.5, -0.75, 0.25, 2.25]
    cts = [cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(v, slots=8))
           for v in vecs]

    res = cc.EvalLinearWSum(cts, weights)
    got = np.asarray(cc.Decrypt(kp.secret_key, res).values).real[:8]
    want = sum(w * v for w, v in zip(weights, vecs))
    print("sum w_i*x_i =", np.round(got, 4))
    print("expected    =", np.round(want, 4))
    assert np.abs(got - want).max() < TOL
    print("linear weighted sum OK")
    return {"checks": {"sum w_i*x_i": close(got, want, TOL)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
