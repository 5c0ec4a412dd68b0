"""CKKS noise-flooding decryption on the port: estimate, then flood.

Counterpart of `examples/ckks_noise_flooding.py` (reference:
src/pke/examples/ckks-noise-flooding.cpp, NOISE_FLOODING_DECRYPT with the
EXEC_NOISE_ESTIMATION pass), on the GPU unless `--device cpu`:

    python examples_torch/ckks_noise_flooding.py [--device cpu]
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
from openfhe_tpu_torch.pke.constants import (  # noqa: E402
    DecryptionNoiseMode, ExecutionMode)

TOL = 0.05


def run(device, execution_mode, noise_estimate, ring_dim, mult_depth,
        security_level, seed):
    """f(x) = 2 x^2 on 8 slots; returns the decryption and x."""
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, scaling_mod_size=28,
                 first_mod_size=30, batch_size=8,
                 security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO,
                 decryption_noise_mode=(
                     DecryptionNoiseMode.NOISE_FLOODING_DECRYPT),
                 execution_mode=execution_mode,
                 noise_estimate=noise_estimate)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)

    x = np.linspace(-1, 1, 8)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    res = cc.EvalMult(cc.EvalAdd(ct, ct), ct)        # f(x) = 2x^2
    return cc.Decrypt(kp.secret_key, res), x


def main(device=None, ring_dim=512, mult_depth=3,
         security_level=SecurityLevel.HEStd_NotSet, seed=6) -> dict:
    """Pass 1 measures the noise, pass 2 floods to it; returns the flooded
    decryption beside 2 x^2 and the estimate."""
    pt, x = run(device, ExecutionMode.EXEC_NOISE_ESTIMATION, 0.0, ring_dim,
                mult_depth, security_level, seed)
    log_err = pt.GetLogError()
    print(f"estimated log2(noise) = {log_err:.1f}")

    pt2, x = run(device, ExecutionMode.EXEC_EVALUATION, log_err, ring_dim,
                 mult_depth, security_level, seed)
    got = np.asarray(pt2.values).real[:8]
    want = 2 * x * x
    print("flooded decrypt:", np.round(got, 3))
    print("expected       :", np.round(want, 3))
    assert np.abs(got - want).max() < TOL
    print("ckks noise flooding OK")
    return {"checks": {"flooded 2x^2": close(got, want, TOL)},
            "log_error": log_err}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
