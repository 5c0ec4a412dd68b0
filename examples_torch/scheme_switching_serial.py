"""A scheme-switching context's objects through files on the port.

Counterpart of `examples/scheme_switching_serial.py` (reference:
src/pke/examples/scheme-switching-serial.cpp): the server writes a
ciphertext and the secret key, the client restores and decrypts them.
Files go to a temporary directory. On the GPU unless `--device cpu`:

    python examples_torch/scheme_switching_serial.py [--device cpu]
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

TOL = 1e-3


def main(device=None, ring_dim=256, mult_depth=6, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=12) -> dict:
    """The restored ciphertext's decryption beside the input."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=4,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FIXEDMANUAL)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.SCHEMESWITCH):
        cc.Enable(f)
    keys = cc.KeyGen()

    x = np.array([0.2, -0.4, 0.6, -0.8])
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x, slots=4))
    with tempfile.TemporaryDirectory() as d:
        # the server writes the ciphertext and the key
        ser.serialize_to_file(os.path.join(d, "ct.bin"), ct)
        ser.serialize_to_file(os.path.join(d, "sk.bin"), keys.secret_key)
        # the client restores and decrypts
        ct2 = ser.deserialize_from_file(os.path.join(d, "ct.bin"),
                                        device=cc.device)
        sk2 = ser.deserialize_from_file(os.path.join(d, "sk.bin"),
                                        device=cc.device)
        got = np.asarray(cc.Decrypt(sk2, ct2).values).real[:4]
    print("restored decrypt:", np.round(got, 3))
    assert np.abs(got - x).max() < TOL
    print("OK")
    return {"checks": {"restored": close(got, x, TOL)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
