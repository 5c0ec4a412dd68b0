"""CCParams parameter objects + modulus-chain generation.

Counterpart of `openfhe_tpu/pke/parameters.py`, kept as a copy so the port
never imports the JAX package. It must produce the same modulus chains:
the port is held word for word against the JAX package, which needs the
same moduli. Reference analog: OpenFHE's gen-cryptocontext-params.h (the
user knobs), gen-cryptocontext-params-validation.cpp and
ckksrns-parametergeneration.cpp.

Residues are 32-bit words, so moduli are < 2^31. The defaults mirror the
reference's NATIVE_SIZE=32 configuration: scalingModSize <= 28,
firstModSize <= 30.
"""

from __future__ import annotations

import dataclasses
import math

from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.pke.constants import (CKKSDataType,
                                             DecryptionNoiseMode,
                                             EncryptionTechnique,
                                             ExecutionMode,
                                             KeySwitchTechnique,
                                             MultipartyMode,
                                             MultiplicationTechnique,
                                             ProxyReEncryptionMode,
                                             ScalingTechnique, Scheme,
                                             SecretKeyDist, SecurityLevel)
from openfhe_tpu_torch.lattice import stdlatticeparms

MAX_MODULUS_BITS = 31          # residues are 32-bit words; q < 2^31
DEFAULT_AUX_MOD_BITS = 27      # special-prime (P) size for hybrid KS


@dataclasses.dataclass
class CCParams:
    """Scheme parameters (reference: CCParams<CryptoContext*RNS>).

    The fields and defaults are those of the JAX package, so one set of
    keyword arguments builds the same context in both."""
    scheme: Scheme = Scheme.CKKSRNS_SCHEME
    # ring / depth
    ring_dim: int = 0                          # 0 = derive from security level
    mult_depth: int = 1
    scaling_mod_size: int = 26
    first_mod_size: int = 27
    batch_size: int = 0                        # 0 = max slots
    # security
    security_level: SecurityLevel = SecurityLevel.HEStd_128_classic
    secret_key_dist: SecretKeyDist = SecretKeyDist.UNIFORM_TERNARY
    standard_deviation: float = 3.19
    # key switching
    ks_technique: KeySwitchTechnique = KeySwitchTechnique.HYBRID
    num_large_digits: int = 3
    digit_size: int = 0                        # BV relin window (bits)
    aux_mod_size: int = DEFAULT_AUX_MOD_BITS
    # scaling / mult technique
    scaling_technique: ScalingTechnique = ScalingTechnique.FLEXIBLEAUTO
    multiplication_technique: MultiplicationTechnique = (
        MultiplicationTechnique.HPS)
    encryption_technique: EncryptionTechnique = EncryptionTechnique.STANDARD
    # BFV/BGV
    plaintext_modulus: int = 0
    max_relin_sk_deg: int = 2
    # multiparty / PRE
    pre_mode: ProxyReEncryptionMode = ProxyReEncryptionMode.INDCPA
    multiparty_mode: MultipartyMode = MultipartyMode.FIXED_NOISE_MULTIPARTY
    threshold_num_of_parties: int = 1
    # misc (reference parity)
    execution_mode: ExecutionMode = ExecutionMode.EXEC_EVALUATION
    decryption_noise_mode: DecryptionNoiseMode = (
        DecryptionNoiseMode.FIXED_NOISE_DECRYPT)
    noise_estimate: float = 0.0
    desired_precision: float = 25.0
    composite_degree: int = 1
    register_word_size: int = 32
    evaluation_ks_count: int = 0
    num_adversarial_queries: int = 0
    interactive_boot_compression_level: str = "SLACK"
    ckks_data_type: CKKSDataType = CKKSDataType.REAL

    def validate(self) -> None:
        """Central validation (reference:
        gen-cryptocontext-params-validation.cpp)."""
        if self.scheme == Scheme.CKKSRNS_SCHEME:
            if self.scaling_technique in (
                    ScalingTechnique.COMPOSITESCALINGAUTO,
                    ScalingTechnique.COMPOSITESCALINGMANUAL):
                if (self.scaling_technique ==
                        ScalingTechnique.COMPOSITESCALINGAUTO
                        and self.register_word_size < 20):
                    raise ValueError(
                        "register_word_size must be >= 20 for "
                        "COMPOSITESCALINGAUTO; use COMPOSITESCALINGMANUAL")
                cap = min(self.register_word_size, 28)
                if self.composite_degree < 2:
                    self.composite_degree = max(
                        2, -(-self.scaling_mod_size // cap))
                per = -(-self.scaling_mod_size // self.composite_degree)
                if per > cap:
                    raise ValueError(
                        "scaling_mod_size too large for the composite "
                        f"degree at {cap}-bit effective word size")
            elif self.scaling_mod_size > 28:
                raise ValueError(
                    "scaling_mod_size > 28 unsupported on 32-bit words;"
                    " use composite scaling (COMPOSITESCALING* technique)")
        if self.first_mod_size >= MAX_MODULUS_BITS and \
                self.scaling_technique not in (
                    ScalingTechnique.COMPOSITESCALINGAUTO,
                    ScalingTechnique.COMPOSITESCALINGMANUAL):
            raise ValueError("first_mod_size must be < 31")
        if self.scheme != Scheme.CKKSRNS_SCHEME and not self.plaintext_modulus:
            raise ValueError("plaintext_modulus required for BFV/BGV")
        if self.num_large_digits < 1:
            raise ValueError("num_large_digits must be >= 1")


def main_path_params() -> CCParams:
    """The configuration the JAX repo is built around (`bench.py`
    `bench_north`): CKKS at N=2^16, 30 levels of 26/27-bit moduli, 2 large
    digits (31 Q + 16 P towers), HEStd_128_classic, FIXEDMANUAL."""
    return CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=1 << 16,
                    mult_depth=30, scaling_mod_size=26, first_mod_size=27,
                    aux_mod_size=27, num_large_digits=2,
                    security_level=SecurityLevel.HEStd_128_classic,
                    scaling_technique=ScalingTechnique.FIXEDMANUAL)


def _distinct_prime_chain(order: int, bit_sizes, forbidden=()) -> list:
    """Primes = 1 mod order with the given bit sizes, all distinct."""
    used = set(forbidden)
    out = []
    for bits in bit_sizes:
        q = nbtheory.first_prime(bits, order)
        while q in used:
            q = nbtheory.next_prime(q, order)
        used.add(q)
        out.append(q)
    return out


def _nearest_prime(target: float, order: int, used: set) -> int:
    """Nearest unused prime = 1 mod order to `target`."""
    t = max(order + 1, int(round(target)))
    hi = nbtheory.next_prime(t - 1, order)
    while hi in used:
        hi = nbtheory.next_prime(hi, order)
    lo = nbtheory.previous_prime(t, order)
    while lo in used and lo > order:
        lo = nbtheory.previous_prime(lo, order)
    if lo <= order or lo in used:
        return hi
    return lo if (t - lo) <= (hi - t) else hi


# FLEXIBLEAUTOEXT extra top modulus (reference rns-modulus-limits.h:42)
DEFAULT_EXTRA_MOD_SIZE = 20


def _ext_prime(ext_mod_size: int, order: int, used: set) -> int:
    """FLEXIBLEAUTOEXT's extra top prime: the first (ext_mod_size - 1)-bit
    prime = 1 mod order, as the JAX package picks it. From N = 2^13 on
    there is none (the 19-bit range holds at most two candidates), where
    the JAX package raises. The port then takes the first ext_mod_size-bit
    prime = 1 mod order (786433 at N = 2^15 ... 2^17): a choice of the
    port's own, backed by no reference, so there its chain is held only
    against itself (fused against unfused) and against decryption limits.
    Where the JAX package has a prime, the chains are equal."""
    try:
        q_ext = nbtheory.first_prime(ext_mod_size - 1, order)
    except RuntimeError:
        q_ext = nbtheory.first_prime(ext_mod_size, order)
    while q_ext in used:
        q_ext = nbtheory.next_prime(q_ext, order)
    return q_ext


def select_ckks_moduli(n: int, mult_depth: int, scaling_mod_size: int,
                       first_mod_size: int, forbidden=(),
                       flexible: bool = True, ext_mod_size: int = 0) -> list:
    """CKKS modulus chain: q0 (first_mod_size bits) + mult_depth scaling
    primes (reference: ckksrns-parametergeneration.cpp).

    FLEXIBLE modes track the scaling-factor recurrence
    scf[l+1] = scf[l]^2 / q_dropped(l) and pick each dropped prime nearest
    scf^2 / 2^p so the chain stays anchored at 2^p. FIXED modes alternate
    primes above/below 2^p to keep the running product centered instead.
    """
    order = 2 * n
    used = set(forbidden)
    q0 = nbtheory.first_prime(first_mod_size, order)
    while q0 in used:
        q0 = nbtheory.next_prime(q0, order)
    used.add(q0)
    target = float(1 << scaling_mod_size)
    if flexible:
        # generate in drop order (last chain element is dropped first)
        drops = []
        scf = None
        for i in range(mult_depth):
            t = target if i == 0 else scf * scf / target
            q = _nearest_prime(t, order, used)
            if q >= 1 << MAX_MODULUS_BITS:
                raise ValueError("scaling prime exceeded 31 bits; reduce "
                                 "scaling_mod_size")
            used.add(q)
            drops.append(q)
            scf = float(q) if i == 0 else scf * scf / q
        chain = [q0] + drops[::-1]
        if ext_mod_size:
            chain.append(_ext_prime(ext_mod_size, order, used))
        return chain
    chain = [q0]
    up = int(target) + 1
    down = int(target) + 1
    log_drift = 0.0  # sum of log2(q_i / 2^p)
    for _ in range(mult_depth):
        if log_drift <= 0:
            q = nbtheory.next_prime(up - 1, order)
            while q in used:
                q = nbtheory.next_prime(q, order)
            up = q + 1
        else:
            q = nbtheory.previous_prime(down, order)
            while q in used:
                q = nbtheory.previous_prime(q, order)
            down = q
        used.add(q)
        chain.append(q)
        log_drift += math.log2(q) - scaling_mod_size
    return chain


def select_ckks_moduli_composite(n: int, mult_depth: int,
                                 scaling_mod_size: int, first_mod_size: int,
                                 degree: int, forbidden=()) -> list:
    """Composite-scaling chain (reference COMPOSITESCALING*,
    ckksrns-parametergeneration.cpp:57-135): each level is a group of
    `degree` word-sized primes whose product tracks the scaling factor
    2^scaling_mod_size; the FLEXIBLE recurrence runs on group products,
    scf[l+1] = scf[l]^2 / prod(group_l)."""
    order = 2 * n
    used = set(forbidden)

    def pick_group_exact(target: float, count: int) -> list:
        # log2(target) shared over `count` primes, each the nearest prime
        # to its share of what is left, so the product stays anchored
        group = []
        rem_log = math.log2(target)
        for i in range(count):
            share_bits = rem_log / (count - i)
            q = _nearest_prime(2.0 ** share_bits, order, used)
            if q >= 1 << MAX_MODULUS_BITS:
                raise ValueError("composite prime exceeded 31 bits")
            used.add(q)
            group.append(q)
            rem_log -= math.log2(q)
        return group

    first = pick_group_exact(2.0 ** first_mod_size, degree)
    target = 2.0 ** scaling_mod_size
    groups = []
    scf = None
    for i in range(mult_depth):
        t = target if i == 0 else scf * scf / target
        g = pick_group_exact(t, degree)
        prod = 1.0
        for q in g:
            prod *= q
        scf = prod if i == 0 else scf * scf / prod
        groups.append(g)
    # [first group, level depth-1's group, ..., level 0's group]: the group
    # made first (which anchors scf[0]) sits at the end and drops first
    chain = list(first)
    for g in groups[::-1]:
        chain.extend(g)
    return chain


def select_aux_moduli(n: int, q_moduli, num_large_digits: int,
                      aux_mod_bits: int = DEFAULT_AUX_MOD_BITS) -> list:
    """Special primes P for hybrid KS: log P >= max digit size (reference:
    CryptoParametersRNS::EstimateLogP, rns-cryptoparameters.h)."""
    order = 2 * n
    k = len(q_moduli)
    alpha = -(-k // num_large_digits)
    max_digit_bits = 0
    for j in range(num_large_digits):
        bits = sum(math.log2(q) for q in q_moduli[j * alpha:(j + 1) * alpha])
        max_digit_bits = max(max_digit_bits, bits)
    size_p = max(1, math.ceil(max_digit_bits / aux_mod_bits))
    return _distinct_prime_chain(order, [aux_mod_bits] * size_p,
                                 forbidden=q_moduli)


def _dist(params: CCParams) -> str:
    return (stdlatticeparms.TERNARY
            if params.secret_key_dist != SecretKeyDist.GAUSSIAN
            else stdlatticeparms.ERROR)


def derive_ring_dim(params: CCParams, log_qp: float) -> int:
    return stdlatticeparms.find_ring_dim(_dist(params),
                                         params.security_level,
                                         math.ceil(log_qp))


def validate_security(params: CCParams, n: int, log_qp: float) -> None:
    stdlatticeparms.validate(_dist(params), params.security_level, n,
                             math.ceil(log_qp))
