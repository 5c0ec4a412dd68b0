"""Scheme/technique enums and feature flags.

A copy of `openfhe_tpu/pke/constants.py`. Reference analog: OpenFHE's
src/pke/include/constants-defs.h (enums at :41-110) and
src/core/include/lattice/constants-lattice.h. Names match the reference
so user code ports 1:1.
"""

from __future__ import annotations

import enum


class Scheme(enum.Enum):
    CKKSRNS_SCHEME = "CKKSRNS"
    BFVRNS_SCHEME = "BFVRNS"
    BGVRNS_SCHEME = "BGVRNS"


class PKESchemeFeature(enum.IntFlag):
    """Feature bitmask (constants-defs.h:41-50)."""
    PKE = 1 << 0
    KEYSWITCH = 1 << 1
    PRE = 1 << 2
    LEVELEDSHE = 1 << 3
    ADVANCEDSHE = 1 << 4
    MULTIPARTY = 1 << 5
    FHE = 1 << 6
    SCHEMESWITCH = 1 << 7


class ScalingTechnique(enum.Enum):
    """CKKS/BGV rescaling modes (constants-defs.h:52-61)."""
    FIXEDMANUAL = "FIXEDMANUAL"
    FIXEDAUTO = "FIXEDAUTO"
    FLEXIBLEAUTO = "FLEXIBLEAUTO"
    FLEXIBLEAUTOEXT = "FLEXIBLEAUTOEXT"
    NORESCALE = "NORESCALE"
    COMPOSITESCALINGAUTO = "COMPOSITESCALINGAUTO"
    COMPOSITESCALINGMANUAL = "COMPOSITESCALINGMANUAL"


class KeySwitchTechnique(enum.Enum):
    """(constants-defs.h:86-90)"""
    BV = "BV"
    HYBRID = "HYBRID"


class SecretKeyDist(enum.Enum):
    """(constants-lattice.h)"""
    GAUSSIAN = "GAUSSIAN"
    UNIFORM_TERNARY = "UNIFORM_TERNARY"
    SPARSE_TERNARY = "SPARSE_TERNARY"


class MultiplicationTechnique(enum.Enum):
    """BFV multiplication variants (constants-defs.h:97-102)."""
    BEHZ = "BEHZ"
    HPS = "HPS"
    HPSPOVERQ = "HPSPOVERQ"
    HPSPOVERQLEVELED = "HPSPOVERQLEVELED"


class EncryptionTechnique(enum.Enum):
    STANDARD = "STANDARD"
    EXTENDED = "EXTENDED"


class ProxyReEncryptionMode(enum.Enum):
    """(constants-defs.h:63-68)"""
    NOT_SET = "NOT_SET"
    INDCPA = "INDCPA"
    FIXED_NOISE_HRA = "FIXED_NOISE_HRA"
    NOISE_FLOODING_HRA = "NOISE_FLOODING_HRA"


class MultipartyMode(enum.Enum):
    """(constants-defs.h:70-74)"""
    INVALID_MULTIPARTY_MODE = "INVALID"
    FIXED_NOISE_MULTIPARTY = "FIXED_NOISE"
    NOISE_FLOODING_MULTIPARTY = "NOISE_FLOODING"


class ExecutionMode(enum.Enum):
    """(constants-defs.h:76-79)"""
    EXEC_EVALUATION = "EXEC_EVALUATION"
    EXEC_NOISE_ESTIMATION = "EXEC_NOISE_ESTIMATION"


class CKKSDataType(enum.Enum):
    """(constants-defs.h:117-120); COMPLEX keeps both embedding halves
    through encode/decode, REAL conjugate-folds on decode."""
    REAL = "REAL"
    COMPLEX = "COMPLEX"


class DecryptionNoiseMode(enum.Enum):
    FIXED_NOISE_DECRYPT = "FIXED_NOISE_DECRYPT"
    NOISE_FLOODING_DECRYPT = "NOISE_FLOODING_DECRYPT"


class SecurityLevel(enum.Enum):
    """HomomorphicEncryption.org levels (stdlatticeparms.h:69-75)."""
    HEStd_128_classic = "HEStd_128_classic"
    HEStd_192_classic = "HEStd_192_classic"
    HEStd_256_classic = "HEStd_256_classic"
    HEStd_128_quantum = "HEStd_128_quantum"
    HEStd_192_quantum = "HEStd_192_quantum"
    HEStd_256_quantum = "HEStd_256_quantum"
    HEStd_NotSet = "HEStd_NotSet"


class PlaintextEncodings(enum.Enum):
    """(constants-defs.h:104-110)"""
    COEF_PACKED_ENCODING = "COEF_PACKED"
    PACKED_ENCODING = "PACKED"
    STRING_ENCODING = "STRING"
    CKKS_PACKED_ENCODING = "CKKS_PACKED"


class Format(enum.IntEnum):
    COEFFICIENT = 0
    EVALUATION = 1


# NoiseFlooding constants (constants-defs.h:131 ff.)
NOISE_FLOODING_MULTIPARTY_MOD_SIZE = 60  # reference uses 2 extra 60-bit limbs
