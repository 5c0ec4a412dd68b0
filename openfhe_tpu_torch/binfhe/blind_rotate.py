"""The blind rotation as one kernel: kernel m redesigned for the card.

Counterpart of the three `lax.scan` loops of `openfhe_tpu/binfhe/rgsw.py`
(`eval_acc_cggi`, `eval_acc_dm`, `eval_acc_lmkcdey_scan`) together with the
TPU kernel of their transforms (`openfhe_tpu/ops/ntt_small.py` `_mat_call`).
On a CUDA tensor each wrapper launches `csrc/blind_rotate.cu` once for the
steps [lo, hi) of every gate: one block a gate, the accumulator pair in
shared memory for all the steps, both transforms, the decomposition, the
key product and the step's epilogue inside the launch. On a CPU tensor it
runs the plain twin, the per-step loop of `rgsw.py` (`_step_digits`,
`_key_sum`, `monomial_eval`) over the same tables; on any other device it
raises. The kernel and the twin read the same per-step tables, built here:

* GINX: `idx [n, B]`, idx = ((q - a) mod q) * (2N / q), with the key
  `bskey [n, 2, d2, 2, N]`;
* AP: `row [n * dR, B]`, the row of `keys [n * dR * baseR, d2, 2, N]` that
  step j of gate b gathers: j * baseR + (base-R digit j of q - a);
* LMKCDEY: `perm_table [w + 2, N]` and `sched [L, B, 5]`
  (`rgsw.build_lmkcdey_schedule`, padded per gate with no-op steps) with
  the key bank `[1 + n + w + 1, d2, 2, N]`.

Accumulators are `[B, N]` int32 EVAL words; the results are new tensors.

`blind_rotate_cggi_wide` is GINX on the composite-Q ring of `rgsw_wide.py`
(Q = q1 q2, the STD192-class sets): the counterpart of the `lax.scan` of
`openfhe_tpu/binfhe/rgsw_wide.py` `eval_acc_cggi_wide` with kernel m inside
it. On the card one launch runs a cluster of two blocks a gate, a tower a
block; its accumulators are `[B, 2, N]` (tower, slots), its key `[n, 2,
d2, 2, 2, N]`, its table `idx [n, B]` (`cggi_idx`). On the CPU its twin is
the per-step loop of `rgsw_wide._wide_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.binfhe import rgsw, rgsw_wide

MIN_RING_DIM = 128
MAX_RING_DIM = 1 << 11
MAX_SMEM_BYTES = 232448        # 227 KB, a block's most on the H100
# the composite-Q form's 64-bit sums: d2 products of two residues, then two
# of a residue and X^+-ix - 1, stay below 2^63 for towers below 2^29
MAX_WIDE_TOWER = 1 << 29
MAX_WIDE_D2 = 16
FORMS = ("cggi", "dm", "lmkcdey")      # the narrow ring's
WIDE_FORM = "cggi_wide"                 # the composite-Q ring's GINX


def smem_bytes(ring_dim: int, d2: int, form: str) -> int:
    """Shared memory of one block: the accumulator pair, d2 digit rows,
    four twiddle tables and, for GINX, the 2N powers of psi (the composite-Q
    form: of one tower, one block of a gate's cluster)."""
    if form not in FORMS + (WIDE_FORM,):
        raise ValueError(f"unknown blind-rotation form {form!r}")
    ginx = form in ("cggi", WIDE_FORM)
    return 4 * ring_dim * (2 + d2 + 4 + (2 if ginx else 0))


def supported(params, form: str) -> bool:
    """Whether the kernel takes this ring: 128 <= N <= 2048 a power of two,
    a gadget base that is a power of two, the block's shared memory within
    227 KB, and one tower with Q < 2^31 (the composite-Q form: two towers
    below 2^29 and at most 16 gadget rows)."""
    return _unsupported(params, form) is None


def _unsupported(params, form: str) -> str | None:
    """Why the kernel does not take this ring, or None."""
    n = params.ring_dim
    wide = form == WIDE_FORM
    if params.basis.k != (2 if wide else 1):
        return (f"takes {'two towers' if wide else 'one tower'}, not "
                f"{params.basis.k}")
    if not (MIN_RING_DIM <= n <= MAX_RING_DIM and n & (n - 1) == 0):
        return f"takes 128 <= N <= 2048 (a power of 2), not N={n}"
    if wide:
        if max(params.basis.moduli) >= MAX_WIDE_TOWER:
            return (f"takes towers below 2^29, not "
                    f"{max(params.basis.moduli)}")
        if params.digits_g2 > MAX_WIDE_D2:
            return (f"takes at most {MAX_WIDE_D2} gadget rows, not "
                    f"{params.digits_g2}")
    elif params.big_q >= 1 << 31:
        return f"takes Q < 2^31, not {params.big_q}"
    if params.base_g & (params.base_g - 1):
        return f"base {params.base_g} is not a power of 2"
    smem = smem_bytes(n, params.digits_g2, form)
    if smem > MAX_SMEM_BYTES:
        return (f"needs {smem} bytes of shared memory, above the block's "
                f"{MAX_SMEM_BYTES}")
    return None


# ---------------------------------------------------------------------------
# per-step tables
# ---------------------------------------------------------------------------

def cggi_idx(params, a_lwe: torch.Tensor) -> torch.Tensor:
    """GINX monomial exponents [n, B] int32 of a_lwe [B, n] (either ring)."""
    q_lwe = params.q_lwe
    idx = torch.remainder(q_lwe - a_lwe.long(), q_lwe) \
        * (2 * params.ring_dim // q_lwe)
    return idx.t().contiguous().int()


def dm_rows(params: rgsw.RGSWParams, digits_r: int, base_r: int,
            a_lwe: torch.Tensor) -> torch.Tensor:
    """AP key rows [n * dR, B] int32 of a_lwe [B, n]."""
    q_lwe = params.q_lwe
    t = torch.remainder(q_lwe - a_lwe.long(), q_lwe)
    digs = []
    for _ in range(digits_r):
        digs.append(t % base_r)
        t = t // base_r
    digits = torch.stack(digs, dim=-1).reshape(a_lwe.shape[0], -1)
    step = torch.arange(digits.shape[1], device=digits.device) * base_r
    return (digits + step).t().contiguous().int()


def lmkcdey_sched(params: rgsw.RGSWParams, a_lwe: torch.Tensor,
                  num_auto_keys: int) -> torch.Tensor:
    """Per-gate LMKCDEY schedules of a_lwe [B, n] (a pure function of the
    public a vectors, built on the host), padded with no-op steps to the
    longest: [L, B, 5] int32 on a_lwe's device."""
    a_host = a_lwe.cpu().numpy().astype(np.int64)
    scheds = [rgsw.build_lmkcdey_schedule(params, row, num_auto_keys)
              for row in a_host]
    lmax = max(s.shape[0] for s in scheds)
    sched = np.stack([
        np.concatenate([s, np.tile(rgsw.LMK_NOOP, (lmax - s.shape[0], 1))])
        for s in scheds])                                    # [B, L, 5]
    return torch.from_numpy(np.ascontiguousarray(
        sched.transpose(1, 0, 2))).to(a_lwe.device)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def blind_rotate_cggi(params: rgsw.RGSWParams, bskey: torch.Tensor,
                      idx: torch.Tensor, acc0: torch.Tensor,
                      acc1: torch.Tensor, lo: int = 0, hi: int | None = None):
    """GINX steps [lo, hi) of every gate: acc += sum_k (sum_r NTT(digit_r)
    * bskey[i, k, r]) * (X^(+-idx[i]) - 1). Returns (acc0, acc1) [B, N]."""
    hi = bskey.shape[0] if hi is None else hi
    if acc0.device.type == "cpu":
        return _cggi_ref(params, bskey, idx, acc0, acc1, lo, hi)
    n, d2 = params.ring_dim, params.digits_g2
    steps = bskey.shape[0]
    out = _prepare(params, "cggi", acc0, acc1, lo, hi, steps, {
        "bskey": (bskey, (steps, 2, d2, 2, n)),
        "idx": (idx, (steps, acc0.shape[0]))})
    _build.launch("blind_rotate", "blind_rotate_cggi", acc0, acc1, *out,
                  bskey, idx, *_basis_args(params), params.psi_pow.int(),
                  *_shape_args(params, acc0, lo, hi))
    return out


def blind_rotate_dm(params: rgsw.RGSWParams, keys: torch.Tensor,
                    row: torch.Tensor, acc0: torch.Tensor,
                    acc1: torch.Tensor, lo: int = 0, hi: int | None = None):
    """AP steps [lo, hi): acc <- sum_r NTT(digit_r) * keys[row[j]]."""
    hi = row.shape[0] if hi is None else hi
    if acc0.device.type == "cpu":
        return _dm_ref(params, keys, row, acc0, acc1, lo, hi)
    n, d2 = params.ring_dim, params.digits_g2
    out = _prepare(params, "dm", acc0, acc1, lo, hi, row.shape[0], {
        "keys": (keys, (keys.shape[0], d2, 2, n)),
        "row": (row, (row.shape[0], acc0.shape[0]))})
    _build.launch("blind_rotate", "blind_rotate_dm", acc0, acc1, *out, keys,
                  row, *_basis_args(params),
                  *_shape_args(params, acc0, lo, hi))
    return out


def blind_rotate_lmkcdey(params: rgsw.RGSWParams, key_bank: torch.Tensor,
                         tables: tuple, acc0: torch.Tensor,
                         acc1: torch.Tensor, lo: int = 0,
                         hi: int | None = None):
    """LMKCDEY steps [lo, hi) of the masked form; tables = (perm_table,
    sched). See `rgsw.build_lmkcdey_schedule`."""
    perm_table, sched = tables
    hi = sched.shape[0] if hi is None else hi
    if acc0.device.type == "cpu":
        return _lmkcdey_ref(params, key_bank, tables, acc0, acc1, lo, hi)
    n, d2 = params.ring_dim, params.digits_g2
    out = _prepare(params, "lmkcdey", acc0, acc1, lo, hi, sched.shape[0], {
        "key_bank": (key_bank, (key_bank.shape[0], d2, 2, n)),
        "perm_table": (perm_table, (perm_table.shape[0], n)),
        "sched": (sched, (sched.shape[0], acc0.shape[0], 5))})
    _build.launch("blind_rotate", "blind_rotate_lmkcdey", acc0, acc1, *out,
                  key_bank, perm_table, sched, *_basis_args(params),
                  *_shape_args(params, acc0, lo, hi))
    return out


def blind_rotate_cggi_wide(params: rgsw_wide.RGSWWideParams,
                           bskey: torch.Tensor, idx: torch.Tensor,
                           acc0: torch.Tensor, acc1: torch.Tensor,
                           lo: int = 0, hi: int | None = None):
    """GINX steps [lo, hi) of every gate on the composite-Q ring:
    acc += sum_k (sum_r NTT(digit_r) * bskey[i, k, r]) * (X^(+-idx[i]) - 1)
    per tower, the digits cut from the Garner lift of both towers. acc0,
    acc1 [B, 2, N]; returns (acc0, acc1) [B, 2, N]. The ring is checked on
    every device, the operands off the CPU."""
    name = "blind_rotate_cggi_wide"
    why = _unsupported(params, WIDE_FORM)
    if why:
        raise ValueError(f"{name}: {why}")
    hi = bskey.shape[0] if hi is None else hi
    if acc0.device.type == "cpu":
        return _cggi_wide_ref(params, bskey, idx, acc0, acc1, lo, hi)
    n, d2 = params.ring_dim, params.digits_g2
    steps = bskey.shape[0]
    out = _prepare(params, WIDE_FORM, acc0, acc1, lo, hi, steps, {
        "bskey": (bskey, (steps, 2, d2, 2, 2, n)),
        "idx": (idx, (steps, acc0.shape[0]))})
    q1, q2 = params.moduli
    _build.launch("blind_rotate", name, acc0, acc1, *out, bskey, idx,
                  *_basis_args(params), params.psi_pow.int(),
                  pow(q1, -1, q2), *_shape_args(params, acc0, lo, hi),
                  steps)
    return out


def _basis_args(params) -> tuple:
    b = params.basis
    return (b.psi_br, b.psi_br_sh, b.ipsi_br, b.ipsi_br_sh, b.q, b.ninv,
            b.ninv_sh)


def _shape_args(params, acc0: torch.Tensor, lo: int, hi: int) -> tuple:
    return (acc0.shape[0], params.ring_dim.bit_length() - 1,
            params.digits_g2, params.base_g.bit_length() - 1, lo, hi)


def _prepare(params, form: str, acc0: torch.Tensor, acc1: torch.Tensor,
             lo: int, hi: int, steps: int, operands: dict):
    """Check a kernel call's operands (operands: name -> (tensor, shape));
    allocate its outputs."""
    name = f"blind_rotate_{form}"
    why = _unsupported(params, form)
    if why:
        raise ValueError(f"{name}: {why}")
    row = (2, params.ring_dim) if form == WIDE_FORM else (params.ring_dim,)
    batch = acc0.shape[0] if acc0.dim() == 1 + len(row) else -1
    tensors = {"acc0": (acc0, (batch, *row)), "acc1": (acc1, (batch, *row)),
               **operands}
    for label, (t, _) in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, not {t.dtype}")
    for label, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    for label, (t, _) in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not 0 <= lo <= hi <= steps:
        raise ValueError(f"{name}: steps [{lo}, {hi}) outside [0, {steps})")
    for label, (t, _) in tensors.items():
        if t.device != acc0.device:
            raise ValueError(f"{name}: {label} on {t.device}, accumulator "
                             f"on {acc0.device}")
    if params.device != acc0.device:
        raise ValueError(f"{name}: tensors on {acc0.device}, basis on "
                         f"{params.device}")
    if acc0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {acc0.device}")
    if acc0.data_ptr() % 16 or acc1.data_ptr() % 16:
        raise ValueError(f"{name}: accumulators must be 16-byte aligned")
    return torch.empty_like(acc0), torch.empty_like(acc1)


# ---------------------------------------------------------------------------
# the plain twins: the per-step loop over the same tables
# ---------------------------------------------------------------------------

def _cggi_ref(params, bskey, idx, acc0, acc1, lo: int = 0,
              hi: int | None = None):
    hi = bskey.shape[0] if hi is None else hi
    acc = torch.stack([acc0, acc1], dim=-2).long()
    idx = idx.long()
    for i in range(lo, hi):
        acc = rgsw._cggi_step(params, bskey[i], idx[i], acc)
    return acc[..., 0, :].int(), acc[..., 1, :].int()


def _cggi_wide_ref(params, bskey, idx, acc0, acc1, lo: int = 0,
                   hi: int | None = None):
    hi = bskey.shape[0] if hi is None else hi
    acc = torch.stack([acc0, acc1], dim=1).long()         # [B, 2, 2, N]
    idx = idx.long()
    for i in range(lo, hi):
        acc = rgsw_wide._wide_step(params, bskey[i].long(), idx[i], acc)
    return acc[:, 0].int(), acc[:, 1].int()


def _dm_ref(params, keys, row, acc0, acc1, lo: int = 0,
            hi: int | None = None):
    hi = row.shape[0] if hi is None else hi
    for j in range(lo, hi):
        acc0, acc1 = rgsw.external_product_replace(
            params, keys[row[j].long()], acc0, acc1)
    return acc0, acc1


def _lmkcdey_ref(params, key_bank, tables, acc0, acc1, lo: int = 0,
                 hi: int | None = None):
    perm_table, sched = tables
    hi = sched.shape[0] if hi is None else hi
    perm_table = perm_table.long()
    for step in sched[lo:hi].long():
        acc0, acc1 = rgsw._lmkcdey_step(params, key_bank, perm_table, step,
                                        acc0, acc1)
    return acc0, acc1
