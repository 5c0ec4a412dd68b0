"""RNS basis: per-tower modular constants + NTT twiddle tables on a device.

Counterpart of `openfhe_tpu/lattice/basis.py` (reference analog: the
cached root-of-unity tables of transformnat.h and `ILDCRTParams`). A
`Basis` bundles, for a tuple of NTT-friendly primes (q_i = 1 mod 2N,
q_i < 2^31), what the NTT and the modular arithmetic need for `[k, N]`
residue tensors. Every table is an int32 tensor (Shoup companions as bit
patterns, see math/modops.py) on one device; the Python-int moduli ride
along for exact host work.

EVAL order and roots are those of the JAX package: psi_br[j] holds
psi^bitrev(j) for the same 2N-th root psi, so EVAL words carry over.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.math.modops import mod_constants, u32_tensor


@dataclasses.dataclass(frozen=True)
class Basis:
    # per-tower scalar constants, [k, 1] for broadcasting over [k, N]
    q: torch.Tensor          # moduli
    ninv: torch.Tensor       # N^{-1} mod q
    ninv_sh: torch.Tensor    # its Shoup companion
    # twiddle tables [k, N]: psi^bitrev(j) for the 2N-th root psi
    psi_br: torch.Tensor
    psi_br_sh: torch.Tensor
    ipsi_br: torch.Tensor
    ipsi_br_sh: torch.Tensor
    moduli: tuple
    ring_dim: int

    @property
    def k(self) -> int:
        return len(self.moduli)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def big_modulus(self) -> int:
        """Q = prod(moduli) as an exact Python int."""
        return math.prod(self.moduli)

    @functools.cached_property
    def red64(self) -> torch.Tensor:
        """[k, 3] per tower: 2^32 mod q, its Shoup companion and
        floor(2^32 / q), with which a kernel reduces a 64-bit word mod q
        (`reduce_wide` of csrc/pconv_core.cuh). Made on the host at first use
        and kept with the basis; a slice makes its own."""
        return u32_tensor(np.array([mod_constants(q) for q in self.moduli],
                                   np.uint64).reshape(-1, 3), self.device)

    def _map(self, fn, moduli) -> "Basis":
        return Basis(moduli=tuple(moduli), ring_dim=self.ring_dim,
                     **{name: fn(name) for name in _TABLES})

    def slice(self, start: int, stop: int) -> "Basis":
        """Sub-basis of towers [start, stop) (contiguous views)."""
        return self._map(lambda name: getattr(self, name)[start:stop],
                         self.moduli[start:stop])

    def take(self, idx: tuple) -> "Basis":
        """Sub-basis of any tuple of tower indices, in that order (fresh
        contiguous tables)."""
        ix = torch.as_tensor(list(idx), dtype=torch.long, device=self.device)
        return self._map(lambda name: getattr(self, name)[ix],
                         [self.moduli[i] for i in idx])

    def to(self, device) -> "Basis":
        """The same basis with its tables on `device`."""
        return self._map(lambda name: getattr(self, name).to(device),
                         self.moduli)

    def concat(self, other: "Basis") -> "Basis":
        if self.ring_dim != other.ring_dim:
            raise ValueError("ring dimensions differ")
        return self._map(lambda name: torch.cat([getattr(self, name),
                                                 getattr(other, name)]),
                         self.moduli + other.moduli)


_TABLES = ("q", "ninv", "ninv_sh", "psi_br", "psi_br_sh", "ipsi_br",
           "ipsi_br_sh")


def _bitrev_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _power_table(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q, log-doubling, uint64-safe (q < 2^31)."""
    pows = np.ones(n, dtype=np.uint64)
    m = 1
    cur = base % q
    while m < n:
        span = min(m, n - m)
        pows[m:m + span] = (pows[:span] * np.uint64(cur)) % np.uint64(q)
        cur = cur * cur % q
        m *= 2
    return pows


def _shoup_table(c: np.ndarray, q: int) -> np.ndarray:
    return ((c.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(
        np.uint32)


@functools.lru_cache(maxsize=None)
def _tower_tables(q: int, n: int, root: int | None = None) -> tuple:
    """Numpy twiddle tables for one tower (cached host-side). `root`
    overrides the 2N-th root (golden-vector interop with the reference's
    RootOfUnity choice)."""
    psi = root if root is not None else nbtheory.root_of_unity(2 * n, q)
    ipsi = nbtheory.mod_inverse(psi, q)
    rev = _bitrev_indices(n)
    psi_pows = _power_table(psi, n, q)[rev].astype(np.uint32)
    ipsi_pows = _power_table(ipsi, n, q)[rev].astype(np.uint32)
    return (psi_pows, _shoup_table(psi_pows, q),
            ipsi_pows, _shoup_table(ipsi_pows, q))


def make_basis(moduli, ring_dim: int, roots=None, device="cpu") -> Basis:
    """Build a Basis for `moduli` (each = 1 mod 2*ring_dim) at `ring_dim`
    on `device`. `roots` (optional, per modulus) overrides the 2N-th
    primitive roots."""
    moduli = tuple(int(m) for m in moduli)
    n = ring_dim
    for q in moduli:
        if q >= 1 << 31 or q % (2 * n) != 1:
            raise ValueError(f"modulus {q} not NTT-friendly for N={n} "
                             "or >= 2^31")
    tabs = [_tower_tables(q, n, None if roots is None else int(roots[i]))
            for i, q in enumerate(moduli)]
    ninv = [nbtheory.mod_inverse(n, q) for q in moduli]
    col = lambda vals: u32_tensor(np.array(vals, np.uint64).reshape(-1, 1),
                                  device)
    stack = lambda j: u32_tensor(np.stack([t[j] for t in tabs]), device)
    return Basis(q=col(moduli), ninv=col(ninv),
                 ninv_sh=col([(v << 32) // q for v, q in zip(ninv, moduli)]),
                 psi_br=stack(0), psi_br_sh=stack(1),
                 ipsi_br=stack(2), ipsi_br_sh=stack(3),
                 moduli=moduli, ring_dim=n)
