"""FFT-factorized CoeffsToSlots / SlotsToCoeffs for CKKS bootstrapping.

Counterpart of `openfhe_tpu/pke/fhe/fft_transform.py`, host numpy copied
whole (reference analog: ckksrns-utils.cpp SelectLayers :55,
CoeffEncodingOneLevel :439, CoeffDecodingOneLevel :482,
CoeffEncodingCollapse :521, CoeffDecodingCollapse :616,
GetCollapsedFFTParams :703, and ckksrns-fhe.cpp EvalCoeffsToSlots :1832,
EvalSlotsToCoeffs :2041).

The homomorphic DFT of dimension `slots` factors into log2(slots) sparse
levels, each a 3-diagonal linear map (input shifted right / unshifted /
shifted left by a power of two). A level budget L collapses those levels
into L groups; group matrices have 2^(layers+1)-1 diagonals and are applied
as successive BSGS linear transforms, consuming one multiplicative level
each, in place of the dense slots x slots transform (slots diagonals, one
level). The collapse algebra is host numpy at setup time; `eval_fft_stages`
runs each stage as hoisted rotations, plaintext multiplies and giant-step
rotations through the context's key switches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _reduce_rotation(index: int, slots: int) -> int:
    """(reference ReduceRotation, ckksrns-utils.cpp:400) index mod slots in
    [0, slots)."""
    return int(index % slots)


def select_layers(log_slots: int, budget: int) -> tuple:
    """(reference SelectLayers, ckksrns-utils.cpp:55)
    -> (layers_collapse, rows_collapse, rem_collapse)."""
    layers = math.ceil(log_slots / budget)
    rows = log_slots // layers
    rem = log_slots % layers
    dim = rows + (rem != 0)
    if dim < budget:
        layers -= 1
        rows = log_slots // layers
        rem = log_slots - rows * layers
        dim = rows + (rem != 0)
        while dim > budget:
            rows -= 1
            rem = log_slots - rows * layers
            dim = rows + (rem != 0)
    return layers, rows, rem


@dataclass
class CollapsedFFTParams:
    """(reference ckks_boot_params / GetCollapsedFFTParams)."""
    lvlb: int
    layers: int
    rem: int
    num_rot: int
    b: int
    g: int
    num_rot_rem: int
    b_rem: int
    g_rem: int


def get_collapsed_fft_params(slots: int, level_budget: int,
                             dim1: int = 0) -> CollapsedFFTParams:
    log_slots = 1 if slots < 3 else int(math.log2(slots))
    layers, _rows, rem = select_layers(log_slots, level_budget)
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1
    if dim1 == 0 or dim1 > num_rot:
        g = 1 << (layers // 2 + 1 + (1 if num_rot > 7 else 0))
    else:
        g = dim1
    b = (num_rot + 1) // g
    g_rem = (1 << (rem // 2 + 1 + (1 if num_rot_rem > 7 else 0))) if rem else 0
    b_rem = (num_rot_rem + 1) // g_rem if rem else 0
    return CollapsedFFTParams(level_budget, layers, rem, num_rot, b, g,
                              num_rot_rem, b_rem, g_rem)


# ---------------------------------------------------------------------------
# per-level 3-diagonal coefficients of the special FFT
# ---------------------------------------------------------------------------

def _coeff_enc_one_level(pows: np.ndarray, rot_group: np.ndarray,
                         flag_i: bool) -> np.ndarray:
    """(reference CoeffEncodingOneLevel, ckksrns-utils.cpp:439)
    -> [3*log2(slots), slots] complex; rows [s], [s+log], [s+2log] hold the
    shifted-right / unshifted / shifted-left diagonal of FFT level 2^(s+1)."""
    dim = len(pows) - 1
    slots = len(rot_group)
    log2s = int(math.log2(slots))
    coeff = np.zeros((3 * log2s, slots), np.complex128)
    m = slots
    while m > 1:
        s = int(math.log2(m)) - 1
        b = np.exp(-0.5j * np.pi) if (flag_i and m == 2) else 1.0 + 0.0j
        lenq = m << 2
        lenh = m >> 1
        w = b * pows[(lenq - (rot_group[:lenh] % lenq)) * (dim // lenq)]
        reps = slots // m
        zeros = np.zeros(lenh, np.complex128)
        bs = np.full(lenh, b, np.complex128)
        coeff[s] = np.tile(np.concatenate([zeros, w]), reps)          # right
        coeff[s + log2s] = np.tile(np.concatenate([bs, -w]), reps)    # center
        coeff[s + 2 * log2s] = np.tile(np.concatenate([bs, zeros]), reps)
        m >>= 1
    return coeff


def _coeff_dec_one_level(pows: np.ndarray, rot_group: np.ndarray,
                         flag_i: bool) -> np.ndarray:
    """(reference CoeffDecodingOneLevel, ckksrns-utils.cpp:482)."""
    dim = len(pows) - 1
    slots = len(rot_group)
    log2s = int(math.log2(slots))
    coeff = np.zeros((3 * log2s, slots), np.complex128)
    m = 2
    while m <= slots:
        s = int(math.log2(m)) - 1
        b = np.exp(0.5j * np.pi) if (flag_i and m == 2) else 1.0 + 0.0j
        lenq = m << 2
        lenh = m >> 1
        w = b * pows[(rot_group[:lenh] % lenq) * (dim // lenq)]
        reps = slots // m
        zeros = np.zeros(lenh, np.complex128)
        bs = np.full(lenh, b, np.complex128)
        coeff[s] = np.tile(np.concatenate([zeros, bs]), reps)         # right
        coeff[s + log2s] = np.tile(np.concatenate([bs, -w]), reps)    # center
        coeff[s + 2 * log2s] = np.tile(np.concatenate([w, zeros]), reps)
        m <<= 1
    return coeff


# ---------------------------------------------------------------------------
# collapse into level-budget groups (diagonal algebra, host numpy)
# ---------------------------------------------------------------------------

def _collapse_enc_group(c1: np.ndarray, out: np.ndarray, top: int,
                        n_layers: int, log2s: int) -> None:
    """Fold layers top, top-1, ..., top-n_layers+1 into `out` (encoding
    order: composition rotates the accumulated diagonals)."""
    out[0] = c1[top]
    out[1] = c1[top + log2s]
    out[2] = c1[top + 2 * log2s]
    for l in range(1, n_layers):
        temp = out.copy()
        out[:] = 0
        sh = 1 << (top - l)
        for u in range((1 << (l + 1)) - 1):
            out[2 * u] += c1[top - l] * np.roll(temp[u], sh)
            out[2 * u + 1] += c1[top - l + log2s] * temp[u]
            out[2 * u + 2] += c1[top - l + 2 * log2s] * np.roll(temp[u], -sh)


def coeff_enc_collapse(pows: np.ndarray, rot_group: np.ndarray,
                       level_budget: int, flag_i: bool) -> list:
    """(reference CoeffEncodingCollapse, ckksrns-utils.cpp:521)
    -> list of [num_rot(_rem), slots] arrays, group 0 = remainder."""
    slots = len(rot_group)
    log2s = int(math.log2(slots))
    layers, _rows, rem = select_layers(log2s, level_budget)
    flag_rem = 1 if rem else 0
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1
    c1 = _coeff_enc_one_level(pows, rot_group, flag_i)
    coeff = [np.zeros((num_rot, slots), np.complex128)
             for _ in range(level_budget)]
    if flag_rem:
        coeff[0] = np.zeros((num_rot_rem, slots), np.complex128)
    if layers:
        for s in range(level_budget - 1, flag_rem - 1, -1):
            top = log2s - (level_budget - 1 - s) * layers - 1
            _collapse_enc_group(c1, coeff[s], top, layers, log2s)
    if flag_rem and rem:
        top = log2s - (level_budget - 1) * layers - 1
        _collapse_enc_group(c1, coeff[0], top, rem, log2s)
    return coeff


def _collapse_dec_group(c1: np.ndarray, out: np.ndarray, base: int,
                        n_layers: int, log2s: int) -> None:
    out[0] = c1[base]
    out[1] = c1[base + log2s]
    out[2] = c1[base + 2 * log2s]
    for l in range(1, n_layers):
        temp = out.copy()
        out[:] = 0
        for t, shift in enumerate((0, 1 << l, 1 << (l + 1))):
            row = c1[base + l + t * log2s]
            for u in range((1 << (l + 1)) - 1):
                out[u + shift] += row * temp[u]


def coeff_dec_collapse(pows: np.ndarray, rot_group: np.ndarray,
                       level_budget: int, flag_i: bool) -> list:
    """(reference CoeffDecodingCollapse, ckksrns-utils.cpp:616)
    -> list of [num_rot(_rem), slots] arrays, last group = remainder."""
    slots = len(rot_group)
    log2s = int(math.log2(slots))
    layers, rows, rem = select_layers(log2s, level_budget)
    flag_rem = 1 if rem else 0
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1
    c1 = _coeff_dec_one_level(pows, rot_group, flag_i)
    coeff = [np.zeros((num_rot, slots), np.complex128)
             for _ in range(level_budget)]
    if flag_rem:
        coeff[level_budget - 1] = np.zeros((num_rot_rem, slots),
                                           np.complex128)
    if layers:
        for s in range(rows):
            _collapse_dec_group(c1, coeff[s], s * layers, layers, log2s)
    if flag_rem and rem:
        _collapse_dec_group(c1, coeff[rows], rows * layers, rem, log2s)
    return coeff


# ---------------------------------------------------------------------------
# stage construction (precompute) + staged BSGS evaluation
# ---------------------------------------------------------------------------

@dataclass
class FFTStage:
    """One collapsed group, ready for hoisted-BSGS evaluation.

    diags[u] is the diagonal for rotation scale*(u - offset), pre-rotated by
    the giant step so the rotation can be applied after the inner sum
    (reference EvalCoeffsToSlotsPrecompute's `Rotate(coeff, -rotScale*(ij/g))`
    combined with EvalCoeffsToSlots' rot_out).
    """
    diags: dict = field(default_factory=dict)   # u -> np.complex128 [pt_slots]
    g: int = 0
    b: int = 0
    babies: list = field(default_factory=list)  # rotation per j in [0, g)
    giants: list = field(default_factory=list)  # rotation per i in [0, b)


def _build_stage(group: np.ndarray, g: int, b: int, num_rot: int, scale: int,
                 baby_mod: int, giant_mod: int, factor: complex | float,
                 sparse_groups: np.ndarray | None) -> FFTStage:
    offset = (num_rot + 1) // 2 - 1
    babies = [_reduce_rotation(scale * (j - offset), baby_mod)
              for j in range(g)]
    giants = [_reduce_rotation(scale * g * i, giant_mod) for i in range(b)]
    diags = {}
    for u in range(b * g):
        if u == num_rot:
            continue
        d = group[u]
        if sparse_groups is not None:
            d = np.concatenate([d, sparse_groups[u]])
        diags[u] = np.roll(d * factor, scale * g * (u // g))
    return FFTStage(diags=diags, g=g, b=b, babies=babies, giants=giants)


def build_c2s_stages(slots: int, n: int, level_budget: int, dim1: int,
                     enc_scale: float) -> tuple:
    """Build CoeffsToSlots stages in application order (s descending, then
    remainder).  Returns (stages, pt_slots).  `enc_scale` is folded into the
    last-applied group, matching the reference's scaleEnc placement."""
    p = get_collapsed_fft_params(slots, level_budget, dim1)
    m = 4 * slots
    pows = np.exp(2j * np.pi * np.arange(m + 1) / m)
    rot_group = np.array([pow(5, i, m) for i in range(slots)], np.int64)
    sparse = slots < n // 2
    m4 = n // 2

    coeff = coeff_enc_collapse(pows, rot_group, level_budget, False)
    coeffi = (coeff_enc_collapse(pows, rot_group, level_budget, True)
              if sparse else None)
    flag_rem = 1 if p.rem else 0
    stages = []
    for s in range(level_budget - 1, flag_rem - 1, -1):
        scale = 1 << ((s - flag_rem) * p.layers + p.rem)
        last = (flag_rem == 0 and s == 0)
        stages.append(_build_stage(
            coeff[s], p.g, p.b, p.num_rot, scale, baby_mod=slots,
            giant_mod=m4, factor=(enc_scale if last else 1.0),
            sparse_groups=coeffi[s] if sparse else None))
    if flag_rem:
        stages.append(_build_stage(
            coeff[0], p.g_rem, p.b_rem, p.num_rot_rem, 1, baby_mod=slots,
            giant_mod=m4, factor=enc_scale,
            sparse_groups=coeffi[0] if sparse else None))
    return stages, (2 * slots if sparse else slots)


def build_s2c_stages(slots: int, n: int, level_budget: int, dim1: int,
                     dec_scale: float) -> tuple:
    """Build SlotsToCoeffs stages in application order (s ascending, then
    remainder).  `dec_scale` is folded into the last-applied group."""
    p = get_collapsed_fft_params(slots, level_budget, dim1)
    m = 4 * slots
    pows = np.exp(2j * np.pi * np.arange(m + 1) / m)
    rot_group = np.array([pow(5, i, m) for i in range(slots)], np.int64)
    sparse = slots < n // 2
    m4 = n // 2

    coeff = coeff_dec_collapse(pows, rot_group, level_budget, False)
    coeffi = (coeff_dec_collapse(pows, rot_group, level_budget, True)
              if sparse else None)
    flag_rem = 1 if p.rem else 0
    smax = level_budget - flag_rem
    stages = []
    for s in range(smax):
        scale = 1 << (s * p.layers)
        last = (flag_rem == 0 and s + 1 == smax)
        stages.append(_build_stage(
            coeff[s], p.g, p.b, p.num_rot, scale, baby_mod=m4,
            giant_mod=m4, factor=(dec_scale if last else 1.0),
            sparse_groups=coeffi[s] if sparse else None))
    if flag_rem:
        scale = 1 << (smax * p.layers)
        stages.append(_build_stage(
            coeff[smax], p.g_rem, p.b_rem, p.num_rot_rem, scale, baby_mod=m4,
            giant_mod=m4, factor=dec_scale,
            sparse_groups=coeffi[smax] if sparse else None))
    return stages, (2 * slots if sparse else slots)


def stage_rotation_indices(stages: list) -> set:
    idx = set()
    for st in stages:
        idx.update(r for r in st.babies if r)
        idx.update(r for r in st.giants if r)
    return idx


def eval_fft_stages(cc, ct, stages: list, pt_slots: int):
    """Apply the staged linear transform with hoisted baby-step rotations
    (reference EvalCoeffsToSlots / EvalSlotsToCoeffs hoisting structure:
    one EvalFastRotationPrecompute per stage, shared by all baby steps;
    ModReduce between stages).  Output is at noise degree 2."""
    res = ct
    for si, st in enumerate(stages):
        if si:
            res = cc.ModReduce(res)
        hoisted = cc.EvalFastRotationPrecompute(res)
        babies = {}
        for j in range(st.g):
            r = st.babies[j]
            babies[j] = res if r == 0 else cc.EvalFastRotation(
                res, r, digits=hoisted)
        outer = None
        for i in range(st.b):
            inner = None
            for j in range(st.g):
                u = st.g * i + j
                if u not in st.diags:
                    continue
                pt = cc._cached_plaintext(st.diags[u], res.level, pt_slots)
                term = cc._eval_mult_plain(babies[j], pt)
                inner = term if inner is None else cc.EvalAdd(inner, term)
            if st.giants[i]:
                inner = cc.EvalRotate(inner, st.giants[i])
            outer = inner if outer is None else cc.EvalAdd(outer, inner)
        res = outer
    return res
