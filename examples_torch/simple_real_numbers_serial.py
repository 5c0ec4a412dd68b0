"""CKKS with serialization between every step on the port.

Counterpart of `examples/simple_real_numbers_serial.py` (reference:
src/pke/examples/simple-real-numbers-serial.cpp): the context, keys,
relinearization keys and ciphertext go through files between the
"client" and the "server". Files go to a temporary directory. On the GPU
unless `--device cpu`:

    python examples_torch/simple_real_numbers_serial.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import close  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)
from openfhe_tpu_torch.utils import serialization as ser  # noqa: E402

TOL = 1e-2
FEATURES = (PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
            | PKESchemeFeature.LEVELEDSHE)


def main(device=None, ring_dim=512, mult_depth=3, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=9) -> dict:
    """x^2 on the server's restored objects; returns the client's
    decryption beside what it should be."""
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, scaling_mod_size=scaling_mod_size,
                 first_mod_size=first_mod_size, batch_size=8,
                 security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(FEATURES)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)

    x = np.linspace(-1, 1, 8)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    with tempfile.TemporaryDirectory() as d:
        # the client writes everything out (binary, as SERBINARY)
        ser.serialize_to_file(f"{d}/context.bin", cc)
        ser.serialize_to_file(f"{d}/pub.bin", kp.public_key)
        ser.serialize_to_file(f"{d}/sec.bin", kp.secret_key)
        ser.serialize_to_file(f"{d}/ct.bin", ct)
        with open(f"{d}/multkeys.json", "w") as f:
            f.write(ser.serialize_eval_mult_keys(cc))

        # the server: a fresh deserialization (the context dedups through
        # the factory)
        cc2 = ser.deserialize_from_file(f"{d}/context.bin",
                                        device=cc.device)
        cc2.Enable(FEATURES)
        with open(f"{d}/multkeys.json") as f:
            ser.deserialize_eval_mult_keys(cc2, f.read())
        ct_in = ser.deserialize_from_file(f"{d}/ct.bin", device=cc2.device)
        ser.serialize_to_file(f"{d}/result.bin", cc2.EvalMult(ct_in, ct_in))

        # the client reads the result back
        sk = ser.deserialize_from_file(f"{d}/sec.bin", device=cc2.device)
        res = ser.deserialize_from_file(f"{d}/result.bin",
                                        device=cc2.device)
        got = np.asarray(cc2.Decrypt(sk, res).values).real[:8]
    print("x^2      =", np.round(got, 4))
    print("expected =", np.round(x * x, 4))
    assert np.abs(got - x * x).max() < TOL
    print("serialized CKKS workflow OK")
    return {"checks": {"x^2": close(got, x * x, TOL)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
