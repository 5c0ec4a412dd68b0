"""openfhe_tpu_torch — the PyTorch + CUDA port of openfhe_tpu.

Runs the CKKS main path (KeyGen, EvalMultKeyGen, encode, Encrypt,
EvalMult with HYBRID relinearization, Rescale, Decrypt), Relinearize,
KeySwitch, rotations and conjugation (with hoisted rotations and the
EvalSum family of rotation ladders) with hand-written Hopper kernels for
the NTT, the RNS base conversion and the fused key switch (`csrc/`). The
JAX package `openfhe_tpu` is the reference it is held against; this
package never imports it.

    import openfhe_tpu_torch as fhe
    cc = fhe.GenCryptoContext(fhe.CCParams(...))            # on the GPU
    cc = fhe.GenCryptoContext(fhe.CCParams(...), device="cpu")
"""

from openfhe_tpu_torch.pke.constants import (KeySwitchTechnique,
                                             PKESchemeFeature,
                                             ScalingTechnique, Scheme,
                                             SecretKeyDist, SecurityLevel)
from openfhe_tpu_torch.pke.parameters import CCParams
from openfhe_tpu_torch.pke.context import CryptoContext, GenCryptoContext
from openfhe_tpu_torch.pke.keys import EvalKey, KeyPair, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext

__all__ = [
    "CCParams", "Ciphertext", "CryptoContext", "EvalKey", "GenCryptoContext",
    "KeyPair", "KeySwitchTechnique", "PKESchemeFeature", "Plaintext",
    "PrivateKey", "PublicKey", "ScalingTechnique", "Scheme", "SecretKeyDist",
    "SecurityLevel",
]
