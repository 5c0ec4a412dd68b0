"""Drive the PyTorch port's main paths on one GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, printing no result, when there is no card or the port
is not beside it. Phases, none of which catches its own failure:

1. the card's name and power limit (nvidia-smi), then its maximum SM
   clock and SM count and the 32-bit integer rate they give (below);
2. build every kernel of `openfhe_tpu_torch/csrc` (nvcc, in parallel),
   printing each kernel's registers and spills from ptxas;
3. kernel phase: each kernel is compared word for word with its plain
   PyTorch version on the same card inputs, and both are timed with CUDA
   events (median of 20 after warm-up). The NTT and the conversion run at
   the main path's shapes. The NTT's two transforms of `csrc/ntt.cu`, the
   cluster one (`ntt_fwd` / `ntt_inv`, one launch a transform for
   2^4 <= N <= 2^17) and the staged one (`ntt_fwd_staged` /
   `ntt_inv_staged`), are each held against the plain version and so
   against each other, at [31, 2^16], [47, 2^16], 4 of the largest 31-bit
   primes, Rescale's [2, 30, 2^16] and [1, 2^16], a batch of 2 x 3 towers
   at N=2^13 and 4 31-bit towers at N=2^12, 2^14, 2^15 and 2^17 (clusters
   of 1, 1, 2, 4, 8, 8 blocks from 2^12 up); each call of `ntt_fwd` /
   `ntt_inv` must launch the cluster entry once and the staged one never.
   Their `ms` is device time with the host's launch cost taken out
   (`device_ms`), `call_ms` one call; the conversion (kernel k,
   `mod_matmul_rowmod`: `pconv` of csrc/pconv_core.cuh) at the hoisted
   rotation's digit -> complement and P -> Q shapes and at a batch of 2,
   on words below 2^31 not reduced mod the input moduli, against its plain
   version and its former form `mod_matmul_rowmod_eager`, one launch of
   the entry a call and none of the former; the seven kernels of the fused
   key switches at
   level 0 (31 Q towers), level 1 (30) and on a chain of the largest
   31-bit primes (4 Q + 2 P towers, N=2^16) in 2 digits and in 1,
   `intt_scale` also in its K4 form (ext's P rows, 2 elements) and
   `ntt_subscale` also with BGV's t = 65537 in the tables and with one and
   two addends (the final add it takes from Relinearize, KeySwitch and the
   automorphisms). K1t, K1/K4, K3, K45, K6 and K6f (`tensor_intt`,
   `intt_scale` in both forms, `ntt_keymul_acc`, `intt_conv_p`,
   `ntt_subscale`, `ntt_submul_final`, on the cluster NTT) and K2
   (`conv_digits`, y's digits read in place) are also held against their
   former forms (`tensor_intt_staged`, `intt_scale_staged`,
   `ntt_keymul_acc_staged`, `intt_conv_p_staged`, `ntt_subscale_staged`,
   `ntt_submul_final_staged` on the staged NTT passes;
   `conv_digits_rowmod` over the zero-padded digits, the pad
   included), also at levels 3, 11, 15, 23 and 30 (44 down to 17 Q_l*P
   towers, two digits and one), on the 31-bit chain at N=2^12, 2^14, 2^15
   and 2^17 in two digits and in one (clusters of 1, 2, 4, 8) and in one
   digit over 20 and 40 P towers (each of `pconv`'s column widths); each
   call must launch its entry once and the former form never, and both
   are timed as the NTT is (`ms` device time, `call_ms` a call);
4. main path at N=2^16, L=30 (31 Q + 16 P towers, 2 digits), with the
   launch counters reset just before and read just after: context,
   KeyGen, EvalMultKeyGen, rotation keys (1, -1, the EvalSum ladder of
   batch 64, conjugation), encode, Encrypt x3; then at level 0 and at
   level 1 EvalMult (one launch of each kernel of the mult chain; at level
   0 the profiler must see MULT_KERNELS device kernels, all of csrc/),
   Relinearize(EvalMultNoRelin) and EvalRotate (one launch of each kernel
   of the general chain, nothing else; at level 0 one Relinearize must run
   RELIN_KERNELS device kernels, all of csrc/: no plain-torch final add)
   and the same ops through the
   unfused chain (`dataclasses.replace(tables, fused=None)`: the NTT and
   conversion kernels); hoisted rotations (EvalFastRotationPrecompute +
   EvalFastRotation, unfused by design: each two launches of `ntt_fwd`,
   `ntt_inv` and `mod_matmul_rowmod`, none of a former form);
   EvalConjugate; EvalInnerProduct
   (EvalMult + the EvalSum ladder); Rescale; Decrypt. The fused words must
   equal the unfused ones at both levels and the port's plain path run on
   the CPU; the decryptions must be within the limits below; every kernel
   must have been launched;
5. BinFHE (the JAX repo's binfhe benchmark, `bench.py`'s binfhe rows):
   kernel m (`ntt_small_fwd` / `ntt_small_inv`) against its dense plain
   version word for word at a gate batch's shapes and at two more
   (N=2048 with 2 towers, N=128 with 4), each beside `ntt.cu`'s transform
   of the same input (equal words, timed); these small calls cost the
   host more than the card, so their `ms` is device time with the host's
   launch cost taken out (`device_ms`) and `call_ms` the time of one call
   as the other kernels are timed; the blind-rotation kernel
   (`blind_rotate_cggi` / `_dm` / `_lmkcdey`) against the per-step loop
   on the card (`rgsw._eval_acc_*_steps`: kernel m twice a step and plain
   torch around it) word for word, on random words as keys and
   accumulators, at GINX STD128 batch 256 and 1, STD128_LMKCDEY batch 1
   and 64 and STD128_AP batch 64, one launch per blind rotation, plus a
   run split at step SPLIT_STEP that must equal the whole; then, with
   the counters reset just before and read just after, GINX at STD128 over
   a batch of 256 gates with a = i % 2, b = (i // 2) % 2: context, KeyGen,
   BTKeyGen, Encrypt, EvalBinGate AND/OR/NAND/XOR/XNOR, EvalNOT, Bootstrap
   and MAJORITY, every decryption against the truth table; one AND
   launches `ntt_small_fwd` once (the test vector), `blind_rotate_cggi`
   once and `ntt_small_inv` once (the extraction) and nothing else; 4 of
   its gates equal the port's plain path on the CPU with the same keys;
   EvalFunc (x^2 mod 4, periodic) and EvalSign at batch 4; then
   STD128_LMKCDEY at batch 1 and 64 and STD128_AP at batch 64 (AND, truth
   table, the same three launches with their own blind rotation);
6. the limb-sharded path (`openfhe_tpu_torch/parallel/`), on the phase-4
   context and eval key, on meshes built from the visible cards (a card
   repeats when there are fewer cards than shards; the placement is
   printed): kernel l (`mod_matmul`: the int8 tensor cores on byte
   limbs, `mma.sync` m16n8k32 u8) against its plain version and its former
   form (`mod_matmul_simt`, the CUDA cores) at the sharded NTT's stage
   shapes (the Q basis at limb 2 and 4, the 31-bit primes) and at its
   edge (A = 2^15, D = 16, B = 8, every word 2^31 - 2 at q = 2^31 - 1,
   where its int32 limb-pair sums reach 255 * 255 * 2^15); kernels n, o
   and p against theirs on every shard of level 1 at limb 2, level 3 at
   limb 4, the 31-bit chain at limb 2 and its level of 1 Q tower padded to
   2 (whose second digit covers no row of y); n (`conv_digits_rows`: K2's
   `pconv` reading the gathered y in place), o (`conv_p_to_q_rows`: K45's
   `pconv` on the shard's weight columns, both elements over one table)
   and p (`ntt_keymul_acc_rows`: K3's `keymul_cluster` from the shard's
   first global row) also against their former forms
   (`conv_digits_rows_rowmod` over the zero-padded digits,
   `conv_p_to_q_rows_rowmod` the eager conversion,
   `ntt_keymul_acc_rows_staged` on the staged NTT passes); each kernel of
   the phase one launch of its entry a call and none of the former, timed
   as the fused kernels are (`ms` device time, `call_ms` a call); then,
   with the counters reset just before and read just after,
   the sharded NTT at limb 2 and 4 (word-equal to `ntt.cu`, 2L launches
   of `mod_matmul`, none of `mod_matmul_simt`), the sharded EvalMult at
   level 1 / limb 2 and level 3 / limb 4 (word-equal to the single-card
   fused EvalMult, each of its six kernels once per shard, the former
   forms never, nothing else), the
   portable body at level 1 / limb 2,
   the two-level chain (level 3, in-region rescale, level 4 padded to 28
   rows: real rows equal to Rescale and EvalMult, the pad row zero), a dp 2
   x limb 2 mesh with a batch of two pairs and, where two cards are
   visible, shards on distinct cards; the decryption of the rescaled level-3
   product within MULT_TOL; times beside the single-card ops;
7. one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.

bound_ms is the least time the card could take for a call: the larger of
its bytes (each input read once, each output written once) at 3.35 TB/s
and its 32-bit integer operations at the card's 32-bit integer issue
ceiling: 128 thread-instructions a clock an SM (four schedulers, one warp
instruction each a clock) x the card's SM count x the maximum SM clock
nvidia-smi reports (`clocks.max.sm`), printed beside the card's name and
power limit; about 33.5 T/s on an H100 SXM. The CUDA C++ Programming
Guide's throughput table (compute capability 9.0) gives 64 results a
clock an SM for each class of 32-bit integer instruction, but multiplies
(IMAD, IMUL, mul.hi: the FMA-heavy pipe) and adds, logic, shifts,
compares and selects (the ALU pipe) issue side by side, so a mix can
reach 128. The counts here are mixes (a Shoup product is 3 multiplies of
its 5 operations, a butterfly 3 of 10); where more than half of a count
is multiplies, the multiply pipe holds it above this bound, so the bound
is a floor, never above what the card can do. The card's tensor cores do
no 32-bit integer products. Operations count what the function needs: a
conversion counts only its nonzero weights, a key product skips the NTT
of the digit's own rows (and reads only the extended digits' other
rows). Kernel l's modular matmul runs on the int8 tensor cores, whose
products are a third term of its bound: 2 x 16 byte-limb products a term
at INT8_TC_OPS_PER_S (the H100's dense int8 rate), beside its bytes and
its epilogue's MATMUL_EPILOGUE_OPS 32-bit operations an output word; its
former form on the CUDA cores counts MATMUL_TERM_OPS a term (the 62-bit
product, two 32-bit multiplies, and its 64-bit sum, two adds). A
conversion on pconv (k, K2, K45's second launch, the sharded n and o)
counts LAZY_TERM_OPS a term (the lazy Shoup product and its 64-bit sum)
and REDUCE_WIDE_OPS an output word (its one reduction); the eager
conversion's and the key product's terms count ROWMOD_TERM_OPS.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 128   # both integer pipes, 64 a clock each
INT32_OPS_PER_S = None     # int32_rate(), from the card, before any bound
BUTTERFLY_OPS = 10     # Shoup multiply 5, add_mod 2, sub_mod 3
SHOUP_OPS = 5
ROWMOD_TERM_OPS = 7    # Shoup multiply 5 + add_mod 2
LAZY_TERM_OPS = 5      # pconv's term: mul.hi, mul, mad + 64-bit add 2
REDUCE_WIDE_OPS = 11   # a 64-bit sum reduced once: Shoup multiply 5,
                       # Barrett step 4 (mul.hi, mad, csub 2), add_mod 2
MATMUL_TERM_OPS = 4    # 62-bit product 2 + 64-bit sum 2
INT8_TC_OPS_PER_S = 1.979e15   # dense int8 tensor-core rate of an H100
LIMB_PAIRS = 16        # kernel l's byte-limb products a term
MATMUL_EPILOGUE_OPS = 141   # kernel l, an output word: 16 sums into 7
                            # groups (9 64-bit adds, 18), each group's
                            # reduce_wide (77) and lazy Shoup product into
                            # the 64-bit sum (35), the sum's reduce_wide
MULMOD_OPS = 10        # a 64-bit product reduced mod q
CENTRE_OPS = 3         # compare, select, subtract
DIGIT_OPS = 6          # a balanced digit: shift, shift, subtract, shift,
                       # the sign fix (compare and add)
WORD = 4
SLICE1 = ("ntt_fwd", "ntt_inv", "mod_matmul_rowmod")
# the former forms: the staged NTT (csrc/ntt.cu) and K1t, K1/K4, K3, K45,
# K6 and K6f on the staged NTT passes (csrc/ks_fused.cu), for rings above
# 2^17, K2 on rowmod_core.cuh over the zero-padded digits and kernel k's
# eager conversion (csrc/rowmod.cu): the yardstick the new forms are held
# against here; no launch on the main path
STAGED = ("ntt_fwd_staged", "ntt_inv_staged", "tensor_intt_staged",
          "intt_scale_staged", "ntt_keymul_acc_staged", "intt_conv_p_staged",
          "ntt_subscale_staged", "ntt_submul_final_staged",
          "conv_digits_rowmod", "mod_matmul_rowmod_eager")
# the kernels on the cluster NTT
FUSED_CLUSTER = ("tensor_intt", "intt_scale", "ntt_keymul_acc",
                 "intt_conv_p", "ntt_subscale", "ntt_submul_final",
                 "ntt_keymul_acc_rows")
# the kernels held beside their former forms (`cluster_case`,
# `rowmod_case`, `matmul_case`)
FORMER = {"tensor_intt": "tensor_intt_staged",
          "intt_scale": "intt_scale_staged",
          "ntt_keymul_acc": "ntt_keymul_acc_staged",
          "intt_conv_p": "intt_conv_p_staged",
          "ntt_subscale": "ntt_subscale_staged",
          "ntt_submul_final": "ntt_submul_final_staged",
          "conv_digits": "conv_digits_rowmod",
          "mod_matmul_rowmod": "mod_matmul_rowmod_eager",
          "mod_matmul": "mod_matmul_simt",
          "conv_digits_rows": "conv_digits_rows_rowmod",
          "conv_p_to_q_rows": "conv_p_to_q_rows_rowmod",
          "ntt_keymul_acc_rows": "ntt_keymul_acc_rows_staged"}
SMALL = ("ntt_small_fwd", "ntt_small_inv")
BLIND = ("blind_rotate_cggi", "blind_rotate_dm", "blind_rotate_lmkcdey")
FUSED = ("tensor_intt", "intt_scale", "conv_digits", "ntt_keymul_acc",
         "intt_conv_p", "ntt_subscale", "ntt_submul_final")
# the kernels of one EvalMult, and of one Relinearize or automorphism
MULT_CHAIN = ("tensor_intt", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
              "ntt_submul_final")
# device kernels of one EvalMult at N=2^16: K1t, K2, K3, K45's INTT and
# conversion, K6f; nothing else (no digit pad)
MULT_KERNELS = 6
# device kernels of one Relinearize at N=2^16: K1 (one cluster INTT), K2,
# K3, K45's INTT and conversion, K6 with the final add; nothing else
RELIN_KERNELS = 6
KS_CHAIN = ("intt_scale", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
            "ntt_subscale")
# the former forms of l (csrc/modmatmul.cu: the CUDA cores) and of the
# sharded n, o and p (csrc/sharded.cu: n and o on rowmod_core.cuh, n over
# the zero-padded digits, p on the staged NTT passes): their yardsticks
# (`matmul_case`, `shard_cases`); no launch on the path
SHARDED_STAGED = ("mod_matmul_simt", "conv_digits_rows_rowmod",
                  "conv_p_to_q_rows_rowmod", "ntt_keymul_acc_rows_staged")
SHARDED = ("mod_matmul", "conv_digits_rows", "conv_p_to_q_rows",
           "ntt_keymul_acc_rows") + SHARDED_STAGED
# the kernels of one sharded EvalMult, each once per shard
SHARDED_CHAIN = ("tensor_intt", "conv_digits_rows", "ntt_keymul_acc_rows",
                 "intt_scale", "conv_p_to_q_rows", "ntt_submul_final")
# P tower counts of the one-digit K45 cases: pconv's 2- and 1-column forms
WIDE_P = (20, 40)
LIMBS = (2, 4)
ROWS = ("limb", None)
WHERE = {
    "ntt_fwd": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_inv": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_fwd_staged": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_inv_staged": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "mod_matmul_rowmod": ("csrc/rowmod.cu",
                          "openfhe_tpu/ops/modmatmul.py:232"),
    "mod_matmul_rowmod_eager": ("csrc/rowmod.cu",
                                "openfhe_tpu/ops/modmatmul.py:232"),
    "tensor_intt": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:366"),
    "tensor_intt_staged": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:366"),
    "intt_scale": ("csrc/ks_fused.cu",
                   "openfhe_tpu/pke/keyswitch/ks_fused.py:422, "
                   "openfhe_tpu/pke/keyswitch/ks_fused.py:476"),
    "intt_scale_staged": ("csrc/ks_fused.cu",
                          "openfhe_tpu/pke/keyswitch/ks_fused.py:422, "
                          "openfhe_tpu/pke/keyswitch/ks_fused.py:476"),
    "conv_digits": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:513"),
    "ntt_keymul_acc": ("csrc/ks_fused.cu",
                       "openfhe_tpu/pke/keyswitch/ks_fused.py:690"),
    "intt_conv_p": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:618"),
    "ntt_keymul_acc_staged": ("csrc/ks_fused.cu",
                              "openfhe_tpu/pke/keyswitch/ks_fused.py:690"),
    "intt_conv_p_staged": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:618"),
    "ntt_submul_final_staged": ("csrc/ks_fused.cu",
                                "openfhe_tpu/pke/keyswitch/ks_fused.py:802"),
    "conv_digits_rowmod": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:513"),
    "ntt_subscale": ("csrc/ks_fused.cu",
                     "openfhe_tpu/pke/keyswitch/ks_fused.py:747"),
    "ntt_subscale_staged": ("csrc/ks_fused.cu",
                            "openfhe_tpu/pke/keyswitch/ks_fused.py:747"),
    "ntt_submul_final": ("csrc/ks_fused.cu",
                         "openfhe_tpu/pke/keyswitch/ks_fused.py:802"),
    "ntt_small_fwd": ("csrc/ntt_small.cu", "openfhe_tpu/ops/ntt_small.py:157"),
    "ntt_small_inv": ("csrc/ntt_small.cu", "openfhe_tpu/ops/ntt_small.py:157"),
    "blind_rotate_cggi": ("csrc/blind_rotate.cu",
                          "openfhe_tpu/ops/ntt_small.py:157, "
                          "openfhe_tpu/binfhe/rgsw.py:198"),
    "blind_rotate_dm": ("csrc/blind_rotate.cu",
                        "openfhe_tpu/ops/ntt_small.py:157, "
                        "openfhe_tpu/binfhe/rgsw.py:357"),
    "blind_rotate_lmkcdey": ("csrc/blind_rotate.cu",
                             "openfhe_tpu/ops/ntt_small.py:157, "
                             "openfhe_tpu/binfhe/rgsw.py:571"),
    "mod_matmul": ("csrc/modmatmul.cu", "openfhe_tpu/ops/modmatmul.py:138"),
    "mod_matmul_simt": ("csrc/modmatmul.cu",
                        "openfhe_tpu/ops/modmatmul.py:138"),
    "conv_digits_rows": ("csrc/sharded.cu",
                         "openfhe_tpu/parallel/sharded_fused.py:318"),
    "conv_digits_rows_rowmod": ("csrc/sharded.cu",
                                "openfhe_tpu/parallel/sharded_fused.py:318"),
    "conv_p_to_q_rows": ("csrc/sharded.cu",
                         "openfhe_tpu/parallel/sharded_fused.py:348"),
    "conv_p_to_q_rows_rowmod": ("csrc/sharded.cu",
                                "openfhe_tpu/parallel/sharded_fused.py:348"),
    "ntt_keymul_acc_rows": ("csrc/sharded.cu",
                            "openfhe_tpu/parallel/sharded_fused.py:396"),
    "ntt_keymul_acc_rows_staged": (
        "csrc/sharded.cu", "openfhe_tpu/parallel/sharded_fused.py:396"),
}
# kernel m's cases: (N, towers, rows, what the shape is)
SMALL_CASES = ((1024, 1, 1536, "the per-step loop's digits: 256 x d2 6"),
               (1024, 1, 512, "a gate batch's extraction: 256 x 2"),
               (2048, 2, 64, "the STD192 ring's shape"),
               (128, 4, 8, "smallest ring, 4 towers"))
GINX_SET = "STD128"       # bench.py's GINX configuration
LMK_SET = "STD128_LMKCDEY"
AP_SET = "STD128_AP"
GATE_BATCH = 256          # bench.py's GINX batch
LMK_BATCHES = (1, 64)     # bench.py's LMKCDEY batches
AP_BATCH = 64
FUNC_BATCH = 4
GATE_REPS = 3
BLIND_REPS = 5
LOOP_REPS = 2             # the per-step loop takes about half a second
SPLIT_STEP = 100
SIGN_MOD = 1 << 17
# CKKS noise at 26-bit scales and N=2^16: a fresh encryption's slot error
# e has a std of about 2.5e-3 (max over the 32768 slots about 1.5e-2), and
# the product's error z*(e_a + e_b) grows with |z|; inputs |z| <= 1/4 keep
# it under TOL. The product of the two decrypted inputs carries the same
# fresh noise, so EvalMult + Rescale must land closer to it: what is left
# is mostly the rescale's rounding (tau0 + tau1*s, about 2e-4 per slot).
#
# A key switch ends in ApproxModDown, whose P -> Q conversion is approximate:
# it leaves -(Y0 + Y1*s) in the coefficients, Y = sum_i y_i / p_i over the
# 16 P towers, mean c = sum_i (p_i - 1) / (2 p_i) ~ 8 on every coefficient
# (the residues are not centred; the JAX package and the reference do the
# same). Its mean part -c(1 + (1,...,1)*s) is a low-frequency polynomial
# that, at a 2^26 scale, moves the few slots near X = 1 by up to ~1 (a
# numpy model over random secrets: 0.4-1.8), so a rotation at level 0
# cannot be held to MULT_TOL. Two checks follow from that:
#   * at the product's scale 2^52 the key switch's error vanishes in the
#     rescale: Rescale(rotate(prod)) against the rotated decryption of
#     Rescale(prod) differs by two rescale roundings, each at most
#     1.5e-3 per slot on the H100 (PERF.md), so MULT_TOL holds;
#   * at level 0 the error of rotate(ct_a) against the rotated decryption,
#     minus the mean part computed from this run's secret
#     (`modown_mean_slots`), leaves the fluctuation Y - c (per coefficient
#     std sqrt(16/12) * sqrt(2N/3) ~ 240, slot max 5e-3 to 8e-3 in the
#     model) and the key's own error e_j times the extended digits over P
#     (digit 0 is 2^-8 of P; slot max 7e-3 to 2.4e-2 in the model, which
#     cannot be predicted without e_j): ROT_RESID_TOL = 6e-2. A wrong
#     rotation leaves |z_i+1 - z_i-1|, up to 0.5.
# EvalSum of batch 64 runs at the product's scale too (EvalInnerProduct,
# then Rescale) and is held against the same ladder run in numpy on
# dec(Rescale(prod)): each of its slots sums 64 slots, each with its own
# rescale rounding (complex std ~3.3e-4), so std 8 * 3.3e-4 ~ 2.6e-3 and a
# max over 32768 slots near 4.5 std ~ 1.2e-2, plus the sum's own rescale
# rounding (<= 2.1e-3 complex): SUM_TOL = 2e-2.
Z_MAX = 0.25
TOL = 1e-2
MULT_TOL = 4e-3
ROT_RESID_TOL = 6e-2
SUM_BATCH = 64
SUM_TOL = 2e-2
REPS = 20
SPIN_CYCLES = 2_000_000   # about 1 ms at the H100's clock


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median time of fn() in ms, CUDA events around each call (the
    host's launch cost included where the card waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms with the host's launch cost taken
    out: the card first spins for about a millisecond (`torch.cuda._sleep`),
    so fn's launches are queued before its first kernel starts and the
    events time the kernels back to back. For calls whose device time is
    below their host time (kernel m at a gate's shapes); a host
    synchronisation inside fn puts its host time back in."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int32_rate() -> tuple:
    """(32-bit integer op/s, max SM clock in MHz, SMs) of card 0: 128 a
    clock an SM (the issue ceiling over both integer pipes) x the SMs x the
    maximum SM clock nvidia-smi reports. Raises if nvidia-smi cannot tell
    the clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    require(mhz > 0 and sms > 0, f"no SM clock or count: {mhz} MHz, {sms}")
    return INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6, mhz, sms


def bound(nbytes: float, ops: float, tc_ops: float = 0):
    """(ms, what bounds it): the largest of the bytes at HBM_BYTES_PER_S,
    the 32-bit integer operations at INT32_OPS_PER_S and the int8
    tensor-core operations at INT8_TC_OPS_PER_S."""
    require(INT32_OPS_PER_S is not None, "the integer rate is not set")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, tc_ops / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_residues(gen, moduli, n, lead=()):
    q = torch.tensor(moduli, dtype=torch.int64, device="cuda").view(-1, 1)
    raw = torch.randint(0, 1 << 62, tuple(lead) + (len(moduli), n),
                        generator=gen, device="cuda", dtype=torch.int64)
    x = torch.remainder(raw, q)
    x[..., 0] = q[:, 0] - 1                 # the largest residue, each tower
    return x.int()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def ntt_cases(ntt, basis, gen, label, lead=()):
    """The cluster and the staged transform of csrc/ntt.cu against the
    plain version on one basis, word for word, each timed; every call of
    ntt_fwd / ntt_inv launches the cluster entry once where
    `cluster_geometry` takes the ring (else the staged one). Returns a
    case dict per entry point."""
    n, k = basis.ring_dim, basis.k
    x = rand_residues(gen, basis.moduli, n, lead)
    shape = list(x.shape)
    geom = ntt.cluster_geometry(n)
    out = {}
    for name, kern, staged, ref in (
            ("ntt_fwd", ntt.ntt_fwd, ntt._ntt_fwd_staged_cu,
             ntt._ntt_fwd_ref),
            ("ntt_inv", ntt.ntt_inv, ntt._ntt_inv_staged_cu,
             ntt._ntt_inv_ref)):
        both = (name, name + "_staged")
        got, per = count_launches(lambda: kern(x, basis), both)
        want, by_stages = ref(x, basis), staged(x, basis)
        torch.cuda.synchronize()
        err, err_staged = max_abs_err(got, want), max_abs_err(by_stages,
                                                              want)
        require(err == 0 and err_staged == 0,
                f"{name} {label} {shape} differs from its plain version "
                f"(max abs err: cluster {err}, staged {err_staged})")
        want_per = dict(zip(both, (1, 0) if geom else (0, 1)))
        require(per == want_per, f"{name} {label} {shape} launched {per}, "
                f"expected {want_per}")
        # x and out once each, twiddles and their companions once each
        nbytes = 4 * (2 * x.numel() + 2 * k * n)
        ops = x.numel() // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
        if name == "ntt_inv":
            ops += x.numel() * SHOUP_OPS
        b_ms, b_by = bound(nbytes, ops)
        plain_ms = cuda_ms(lambda: ref(x, basis))
        staged_ms = device_ms(lambda: staged(x, basis))
        staged_call_ms = cuda_ms(lambda: staged(x, basis))
        common = dict(shape=shape, moduli=label, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
        out[name] = dict(common, max_abs_err=err,
                         ms=device_ms(lambda: kern(x, basis)),
                         call_ms=cuda_ms(lambda: kern(x, basis)),
                         staged_ms=staged_ms, staged_call_ms=staged_call_ms,
                         launches_per_call=per[name],
                         cluster=list(geom) if geom else None)
        out[name + "_staged"] = dict(common, max_abs_err=err_staged,
                                     ms=staged_ms, call_ms=staged_call_ms)
    return out


def rowmod_case(mm, tab, d_basis, gen, label, lead=()):
    """Kernel k (`mod_matmul_rowmod`) against its plain version and its
    former form `mod_matmul_rowmod_eager`, word for word, on words below
    2^31 that are not reduced mod the input moduli; each call must launch
    the entry once and the former form never. `ms` is device time
    (`device_ms`) and `call_ms` a call, each beside the former form's in
    this run. Returns the case of each entry."""
    name = "mod_matmul_rowmod"
    former = FORMER[name]
    a_dim, d_dim = tab.bhat_mod_d.shape
    n = d_basis.ring_dim
    y = rand_residues(gen, [2 ** 31 - 1] * a_dim, n, lead)
    w = (tab.bhat_mod_d, tab.bhat_mod_d_sh, d_basis.q)
    kern = lambda: mm.mod_matmul_rowmod(y, *w, d_basis.red64)
    eager = lambda: mm.mod_matmul_rowmod_eager(y, *w)
    ref = lambda: mm._mod_matmul_rowmod_ref(y, tab.bhat_mod_d, d_basis.q)
    got, per = count_launches(kern, (name, former))
    want, by_eager = ref(), eager()
    torch.cuda.synchronize()
    err, err_eager = max_abs_err(got, want), max_abs_err(by_eager, want)
    require(err == 0 and err_eager == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"{name} {err}, {former} {err_eager})")
    require(per == {name: 1, former: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    batch = y.numel() // (a_dim * n)
    # y and out once, the weights and companions, d and its red64 row
    nbytes = WORD * ((a_dim + d_dim) * n * batch + 2 * a_dim * d_dim
                     + 4 * d_dim)
    b_ms, b_by = bound(nbytes, pconv_ops(batch * n * d_dim, a_dim))
    eager_ms, eager_call_ms = device_ms(eager), cuda_ms(eager)
    common = dict(shape=list(lead) + [a_dim, d_dim, n], moduli=label,
                  plain_ms=cuda_ms(ref), bound_ms=b_ms, bound_by=b_by)
    return {name: dict(common, max_abs_err=err, ms=device_ms(kern),
                       call_ms=cuda_ms(kern), staged_ms=eager_ms,
                       staged_call_ms=eager_call_ms, former=former,
                       launches_per_call=per[name], cluster=None),
            former: dict(common, max_abs_err=err_eager, ms=eager_ms,
                         call_ms=eager_call_ms)}


def pconv_ops(outputs: int, terms: int) -> int:
    """Operations of a lazy conversion: `outputs` words of `terms` terms
    each, every word reduced once."""
    return outputs * (terms * LAZY_TERM_OPS + REDUCE_WIDE_OPS)


def fused_work(tabs, adds: int = 0) -> dict:
    """(bytes, operations) of each fused kernel at one table set: each
    input and output once, twiddles and keys included; the conversions'
    operations count their nonzero weights only. `intt_scale_p` is
    intt_scale's K4 form (2 elements of kp rows). K1t moves a1, b1, c2, y
    and the inverse twiddles once each; K6 reads `adds` addends of kql
    rows (0, 1 or 2) and adds each word of them."""
    n, kql, kp, nd = (tabs.basis_qlp.ring_dim, tabs.kql, tabs.kp, tabs.nd)
    kqlp, log_n = kql + kp, n.bit_length() - 1
    digits = [min(tabs.alpha, kql - j * tabs.alpha) for j in range(nd)]
    ntt = lambda rows: rows * n // 2 * log_n * BUTTERFLY_OPS
    t_ops = 0 if tabs.t_is_one else SHOUP_OPS
    return {
        "tensor_intt": (WORD * n * 6 * kql,
                        kql * n * (MULMOD_OPS + SHOUP_OPS) + ntt(kql)),
        "intt_scale": (WORD * n * 4 * kql, ntt(kql) + kql * n * SHOUP_OPS),
        "intt_scale_p": (WORD * n * 6 * kp,
                         ntt(2 * kp) + 2 * kp * n * SHOUP_OPS),
        "conv_digits": (WORD * n * (kql + nd * kqlp),
                        sum(pconv_ops(n * (kqlp - a), a) for a in digits)),
        # the extended digits' rows other than their own, c2, the key rows,
        # ext, the twiddles of the towers that transform at least once
        "ntt_keymul_acc": (WORD * n * (sum(kqlp - a for a in digits) + kql
                                       + 4 * nd * kqlp + 2 * kqlp
                                       + 2 * (kqlp if nd > 1
                                              else kqlp - digits[0])),
                           ntt(sum(kqlp - a for a in digits))
                           + 2 * nd * kqlp * n * ROWMOD_TERM_OPS),
        "intt_conv_p": (WORD * n * (2 * kp + 2 * kp + 2 * kql),
                        ntt(2 * kp) + 2 * kp * n * SHOUP_OPS
                        + pconv_ops(2 * kql * n, kp)),
        "ntt_subscale": (WORD * n * (8 + adds) * kql,
                         ntt(2 * kql) + 2 * kql * n * (SHOUP_OPS + 3
                                                       + t_ops)
                         + adds * kql * n * 2),
        "ntt_submul_final": (WORD * n * 12 * kql,
                             ntt(2 * kql) + kql * n * (3 * MULMOD_OPS + 12)
                             + 2 * kql * n * (SHOUP_OPS + 5)),
    }


def cluster_case(name, kern, staged, ref, args, tabs, work, label,
                 shape=None) -> dict:
    """A kernel against its plain twin and its former form `staged`
    (entry FORMER[name]), word for word; each call of kern must launch its
    entry once and the former one never. `ms` is device time (`device_ms`)
    and `call_ms` a call, each beside the former form's (`staged_ms`,
    `staged_call_ms`) in this run. Returns the case of each entry."""
    from openfhe_tpu_torch.ops.ntt import cluster_geometry
    both = (name, FORMER[name])
    got, per = count_launches(lambda: kern(*args, tabs), both)
    want, by_stages = ref(*args, tabs), staged(*args, tabs)
    torch.cuda.synchronize()
    if isinstance(got, tuple):          # K1t: (c2, y)
        got, want, by_stages = map(torch.stack, (got, want, by_stages))
    err, err_staged = max_abs_err(got, want), max_abs_err(by_stages, want)
    require(err == 0 and err_staged == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"cluster {err}, staged {err_staged})")
    require(per == {name: 1, FORMER[name]: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    b_ms, b_by = bound(*work)
    staged_ms = device_ms(lambda: staged(*args, tabs))
    staged_call_ms = cuda_ms(lambda: staged(*args, tabs))
    common = dict(shape=shape or [tabs.kql, tabs.kp, tabs.nd,
                                  tabs.basis_qlp.ring_dim],
                  moduli=label, plain_ms=cuda_ms(lambda: ref(*args, tabs)),
                  bound_ms=b_ms, bound_by=b_by)
    return {name: dict(common, max_abs_err=err,
                       ms=device_ms(lambda: kern(*args, tabs)),
                       call_ms=cuda_ms(lambda: kern(*args, tabs)),
                       staged_ms=staged_ms, staged_call_ms=staged_call_ms,
                       former=FORMER[name], launches_per_call=per[name],
                       cluster=(list(cluster_geometry(
                           tabs.basis_qlp.ring_dim))
                           if name in FUSED_CLUSTER else None)),
            FORMER[name]: dict(common, max_abs_err=err_staged,
                               ms=staged_ms, call_ms=staged_call_ms)}


def fused_cases(ksf, tabs, key, gen, label, names=FUSED) -> list:
    """Each kernel of the fused key switches (of `names`) vs its plain
    twin and its former form (`cluster_case`; K2's former form is run on
    `_pad_digits` of its input) on one table set, on random residues (and
    a random key with companions); `intt_scale` in its K1 form and its K4
    form (both elements' P rows of ext, read in place). Returns (entry,
    case) pairs."""
    n, nd = tabs.basis_qlp.ring_dim, tabs.nd
    mq, mqlp = tabs.basis_ql.moduli, tabs.basis_qlp.moduli
    a = [rand_residues(gen, mq, n) for _ in range(4)]
    y = rand_residues(gen, mq, n)
    conv = rand_residues(gen, mqlp, n, (nd,))
    ext = rand_residues(gen, mqlp, n, (2,))
    convq = rand_residues(gen, mq, n, (2,))
    keys = (key.bv, key.bv_sh, key.av, key.av_sh)
    p_rows = lambda fn: (lambda x, t: fn(x, t, p_rows=True))
    pad = lambda y, t: ksf.conv_digits_rowmod(ksf._pad_digits(y, t), t)
    work = fused_work(tabs)
    # (entry, kernel, former form, twin, inputs, work, label)
    calls = [
        ("tensor_intt", ksf.tensor_intt, ksf.tensor_intt_staged,
         ksf._tensor_intt_ref, (a[1], a[3]), work["tensor_intt"], label),
        ("intt_scale", ksf.intt_scale, ksf.intt_scale_staged,
         ksf._intt_scale_ref, (a[2],), work["intt_scale"], label),
        ("intt_scale", p_rows(ksf.intt_scale),
         p_rows(ksf.intt_scale_staged), p_rows(ksf._intt_scale_ref),
         (ext,), work["intt_scale_p"],
         f"{label}, K4 form: ext's P rows x 2"),
        ("conv_digits", ksf.conv_digits, pad, ksf._conv_digits_ref, (y,),
         work["conv_digits"], label),
        ("ntt_keymul_acc", ksf.ntt_keymul_acc, ksf.ntt_keymul_acc_staged,
         ksf._ntt_keymul_acc_ref, (conv, a[0], *keys),
         work["ntt_keymul_acc"], label),
        ("intt_conv_p", ksf.intt_conv_p, ksf.intt_conv_p_staged,
         ksf._intt_conv_p_ref, (ext,), work["intt_conv_p"], label),
        ("ntt_subscale", ksf.ntt_subscale, ksf.ntt_subscale_staged,
         ksf._ntt_subscale_ref, (convq, ext), work["ntt_subscale"], label),
        ("ntt_submul_final", ksf.ntt_submul_final,
         ksf.ntt_submul_final_staged, ksf._ntt_submul_final_ref,
         (convq, ext, *a), work["ntt_submul_final"], label),
    ]
    out = []
    for name, kern, staged, ref, args, cost, case_label in calls:
        if name in names:
            out += cluster_case(name, kern, staged, ref, args, tabs, cost,
                                case_label).items()
    return out


def rand_key(gen, moduli, n):
    """A random eval key over `moduli` (two digits) with its companions."""
    from openfhe_tpu_torch.pke.keys import EvalKey
    from openfhe_tpu_torch.pke.keyswitch import hybrid
    return hybrid.shoup_companions(EvalKey(
        bv=rand_residues(gen, moduli, n, (2,)),
        av=rand_residues(gen, moduli, n, (2,))), moduli)


def cluster_shape_cases(ksf, gen, rings, wide, n):
    """K3, K45, K6f and K2 (`cluster_case`) on 4 Q + 2 P towers of each
    (ring, moduli) of `rings`, in two digits and in one (clusters of 1 to 8
    blocks; a cluster of one syncs its block between digit transforms);
    then at ring n in one digit over 4 Q + kp P towers of `wide` for each
    kp of WIDE_P, which `pconv` takes with 2 columns a thread (up to 32
    rows) and 1 (up to 64). Yields (entry, case)."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    shapes = []
    for ring, moduli in rings:
        basis, key = (make_basis(moduli[:6], ring, device="cuda"),
                      rand_key(gen, moduli[:6], ring))
        for nd in (2, 1):
            shapes.append((ksf.make_fused_ks_tables(basis, 4, 4, nd), key,
                           f"N=2^{ring.bit_length() - 1}, largest 31-bit "
                           f"primes (4 Q + 2 P), {('one', 'two')[nd - 1]} "
                           "digit" + "s" * (nd - 1)))
    for kp in WIDE_P:
        moduli = wide[:4 + kp]
        shapes.append((ksf.make_fused_ks_tables(
            make_basis(moduli, n, device="cuda"), 4, 4, 1),
            rand_key(gen, moduli, n),
            f"largest 31-bit primes (4 Q + {kp} P), one digit"))
    for tabs, key, label in shapes:
        yield from fused_cases(ksf, tabs, key, gen, label,
                               tuple(FORMER))


def modown_mean_slots(cc, sk, scale: float) -> np.ndarray:
    """Slot values of the mean part of a key switch's ApproxModDown
    rounding, -c (1 + (1,...,1)*s) with c = sum_i (p_i - 1) / (2 p_i) over
    the P towers (see the noise note above), from this run's secret."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.ops.ntt import _ntt_inv_ref
    from openfhe_tpu_torch.pke.encoding import ckks_packed
    n, q0 = cc.ring_dim, cc.moduli_q[0]
    s = _ntt_inv_ref(sk.s_qp[:1].cpu(), make_basis(cc.moduli_q[:1], n))
    s = s[0].numpy().astype(np.int64)
    s = np.where(s > q0 // 2, s - q0, s)
    c = sum((p - 1) / (2 * p) for p in cc.moduli_p)
    ones_s = 2 * np.cumsum(s) - s.sum()       # (1,...,1) * s, negacyclic
    return ckks_packed.decode_from_coeffs(-c * (1.0 + ones_s), n, cc.slots,
                                          scale)


def count_launches(fn, names):
    """fn() and the launches it made, per kernel name."""
    from openfhe_tpu_torch import _build
    before = dict(_build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _build.LAUNCHES[k] - before.get(k, 0) for k in names}


def device_kernels(fn) -> list:
    """The names of the device kernels one call of fn runs (torch.profiler,
    after a call that warms up)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def ntt_small_cases(gen) -> dict:
    """Kernel m vs its dense plain version, and beside it ntt.cu's
    transform of the same input (equal words), each timed."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.ops import ntt, ntt_small
    out = {name: [] for name in SMALL}
    for n, k, rows, label in SMALL_CASES:
        moduli, q = [], 1 << 27
        while len(moduli) < k:
            q = nbtheory.previous_prime(q, 2 * n)
            moduli.append(q)
        basis = make_basis(moduli, n, device="cuda")
        x = rand_residues(gen, moduli, n, (rows // k,))
        log_n = n.bit_length() - 1
        for name, kern, ref, tile in (
                ("ntt_small_fwd", ntt_small.ntt_small_fwd,
                 ntt_small._ntt_small_fwd_ref, ntt._ntt_fwd_cu),
                ("ntt_small_inv", ntt_small.ntt_small_inv,
                 ntt_small._ntt_small_inv_ref, ntt._ntt_inv_cu)):
            got, want, cu = kern(x, basis), ref(x, basis), tile(x, basis)
            torch.cuda.synchronize()
            err, err_cu = max_abs_err(got, want), max_abs_err(got, cu)
            require(err == 0 and err_cu == 0,
                    f"{name} N={n} k={k} rows={rows} differs from its plain "
                    f"version (max abs err {err}) or from ntt.cu ({err_cu})")
            # each row read and written once, the tower tables once
            nbytes = WORD * 2 * x.numel() + 2 * WORD * k * n
            ops = rows * (n // 2) * log_n * BUTTERFLY_OPS
            if name == "ntt_small_inv":
                ops += x.numel() * SHOUP_OPS
            b_ms, b_by = bound(nbytes, ops)
            out[name].append(dict(
                shape=[rows, n], towers=k, moduli=label, max_abs_err=err,
                ms=device_ms(lambda: kern(x, basis)),
                call_ms=cuda_ms(lambda: kern(x, basis)),
                plain_ms=device_ms(lambda: ref(x, basis)),
                ntt_cu_ms=device_ms(lambda: tile(x, basis)),
                ntt_cu_call_ms=cuda_ms(lambda: tile(x, basis)),
                bound_ms=b_ms, bound_by=b_by))
    return out


def blind_work(form, params, batch, keys, tables, lo, hi):
    """(bytes, operations) of a blind rotation's steps [lo, hi): each key
    row these inputs read once (AP and LMKCDEY: only the rows gathered),
    the accumulators in and out, the step tables and the block's twiddle
    tables once; per gate-step that transforms, the 2 + d2 transforms, N^-1,
    the decomposition, the key product's 64-bit terms, its reductions and
    GINX's monomial products (LMKCDEY's permute-only steps do none)."""
    n, d2 = params.ring_dim, params.digits_g2
    log_n = n.bit_length() - 1
    row_bytes = WORD * d2 * 2 * n
    if form == "cggi":
        nbytes = WORD * keys[lo:hi].numel() + tables.numel() * WORD
        gate_steps = batch * (hi - lo)
    elif form == "dm":
        nbytes = row_bytes * tables[lo:hi].unique().numel() \
            + tables.numel() * WORD
        gate_steps = batch * (hi - lo)
    else:
        run = tables[1][lo:hi]
        moves = (run[..., 3] > 0) | (run[..., 2] == 0)   # not permute-only
        nbytes = (row_bytes * run[..., 1][moves].unique().numel()
                  + WORD * n * run[..., 0].unique().numel()
                  + run.numel() * WORD)
        gate_steps = int(moves.sum())
    nbytes += WORD * (4 * batch * n + (6 if form == "cggi" else 4) * n)
    step = ((2 + d2) * n // 2 * log_n * BUTTERFLY_OPS + 2 * n * SHOUP_OPS
            + 2 * n * (CENTRE_OPS + params.digits_g * DIGIT_OPS))
    if form == "cggi":
        step += n * (4 * d2 * MATMUL_TERM_OPS + 6 * MULMOD_OPS
                     + 4 * MATMUL_TERM_OPS)
    else:
        step += n * (2 * d2 * MATMUL_TERM_OPS + 2 * MULMOD_OPS)
    return nbytes, gate_steps * step


def blind_rotate_cases(gen) -> dict:
    """The blind-rotation kernel of each form against the per-step loop on
    the card (`rgsw._eval_acc_*_steps`), word for word, at the BinFHE
    phase's parameter sets and batches, on random words as keys and
    accumulators (any words are valid inputs to a blind rotation); one
    launch per blind rotation; a run split at SPLIT_STEP equals the whole.
    The kernel's `ms` is device time (`device_ms`), `call_ms` one call of
    `rgsw.eval_acc_*` (the tables built on the way), `plain_ms` the loop."""
    import math
    from openfhe_tpu_torch.binfhe import blind_rotate as br
    from openfhe_tpu_torch.binfhe import rgsw
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    out = {name: [] for name in BLIND}
    for param_set, method, batches in (
            (GINX_SET, BINFHE_METHOD.GINX, (GATE_BATCH, 1)),
            (LMK_SET, BINFHE_METHOD.LMKCDEY, LMK_BATCHES),
            (AP_SET, BINFHE_METHOD.AP, (AP_BATCH,))):
        cc = BinFHEContext(seed=13).GenerateBinFHEContext(param_set, method)
        p = cc.rgsw
        n, big_n, d2 = cc.n, cc.N, p.digits_g2
        words = lambda *shape: torch.randint(
            0, cc.Q, shape, generator=gen, device="cuda", dtype=torch.int32)
        if method == BINFHE_METHOD.GINX:
            form, keys = "cggi", words(n, 2, d2, 2, big_n)
        elif method == BINFHE_METHOD.AP:
            digits_r = math.ceil(math.log(cc.q) / math.log(cc.base_r))
            form = "dm"
            keys = words(n, digits_r, cc.base_r, d2, 2, big_n)
        else:
            w = cc.num_auto_keys
            form, keys = "lmkcdey", words(1 + n + w + 1, d2, 2, big_n)
            perm = torch.from_numpy(rgsw.lmkcdey_perm_table(p, w)).cuda()
        name = f"blind_rotate_{form}"
        for batch in batches:
            acc0, acc1 = words(batch, big_n), words(batch, big_n)
            a = torch.randint(0, cc.q, (batch, n), generator=gen,
                              device="cuda", dtype=torch.int32)
            if form == "cggi":
                flat, tables = keys, br.cggi_idx(p, a)
                fused = lambda: rgsw.eval_acc_cggi(p, keys, acc0, acc1, a)
                loop = lambda: rgsw._eval_acc_cggi_steps(p, keys, acc0,
                                                         acc1, a)
            elif form == "dm":
                flat = keys.reshape(-1, d2, 2, big_n)
                tables = br.dm_rows(p, digits_r, cc.base_r, a)
                fused = lambda: rgsw.eval_acc_dm(p, keys, digits_r,
                                                 cc.base_r, acc0, acc1, a)
                loop = lambda: rgsw._eval_acc_dm_steps(
                    p, keys, digits_r, cc.base_r, acc0, acc1, a)
            else:
                flat = keys
                tables = (perm, br.lmkcdey_sched(p, a, w))
                fused = lambda: rgsw.eval_acc_lmkcdey_scan(
                    p, keys, *tables, acc0, acc1)
                loop = lambda: rgsw._eval_acc_lmkcdey_scan_steps(
                    p, keys, *tables, acc0, acc1)
            rotate = getattr(br, name)
            kernel = lambda lo=0, hi=None: rotate(p, flat, tables, acc0,
                                                  acc1, lo, hi)
            got, per = count_launches(fused, BLIND + SMALL)
            want = loop()
            direct = kernel()
            torch.cuda.synchronize()
            err = max(max_abs_err(torch.stack(got), torch.stack(want)),
                      max_abs_err(torch.stack(got), torch.stack(direct)))
            require(err == 0, f"{name} {param_set} batch {batch} differs "
                    f"from the per-step loop (max abs err {err})")
            require(per == {k: int(k == name) for k in BLIND + SMALL},
                    f"{name}: one blind rotation launched {per}")
            steps = (tables[1] if form == "lmkcdey" else tables).shape[0]
            split = None
            if batch == GATE_BATCH:
                part = kernel(0, SPLIT_STEP)
                part = rotate(p, flat, tables, *part, SPLIT_STEP, None)
                split = all(torch.equal(x, y) for x, y in zip(part, direct))
                require(split, f"{name}: steps [0, {SPLIT_STEP}) then "
                        f"[{SPLIT_STEP}, {steps}) differ from the whole")
            b_ms, b_by = bound(*blind_work(form, p, batch, flat, tables, 0,
                                           steps))
            out[name].append(dict(
                shape=[batch, steps, d2, big_n], moduli=param_set,
                max_abs_err=err, split_equal=split,
                launches_per_call=per[name],
                ms=device_ms(kernel, BLIND_REPS, 1),
                call_ms=cuda_ms(fused, BLIND_REPS, 1),
                plain_ms=cuda_ms(loop, LOOP_REPS, 0),
                bound_ms=b_ms, bound_by=b_by))
        del cc, keys
        torch.cuda.empty_cache()
    return out


def binfhe_phase(names) -> dict:
    """The BinFHE paths (see the module docstring); raises on any fault."""
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    res = {}
    i = np.arange(GATE_BATCH)
    bits = {"a": i % 2, "b": (i // 2) % 2, "c": (i // 4) % 2}
    a, b, c = bits["a"], bits["b"], bits["c"]
    truth = {"AND": a & b, "OR": a | b, "NAND": 1 - (a & b),
             "XOR": a ^ b, "XNOR": 1 - (a ^ b)}

    # GINX at STD128, counted from the context on
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    cc = BinFHEContext(seed=11).GenerateBinFHEContext(GINX_SET)
    require(cc.device.type == "cuda", "BinFHEContext() is not on the card")
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    ct = {k: cc.Encrypt(sk, v) for k, v in bits.items()}
    torch.cuda.synchronize()
    res["ginx_keygen_encrypt_s"] = time.perf_counter() - t0
    wrong, outs = {}, {}
    for g, want in truth.items():
        outs[g], per = count_launches(
            lambda g=g: cc.EvalBinGate(BINGATE[g], ct["a"], ct["b"]), names)
        if g == "AND":
            per_gate = per
        wrong[g] = int((cc.Decrypt(sk, outs[g]) != want).sum())
    wrong["NOT"] = int((cc.Decrypt(sk, cc.EvalNOT(ct["a"])) != 1 - a).sum())
    wrong["Bootstrap"] = int((cc.Decrypt(sk, cc.Bootstrap(ct["a"]))
                              != a).sum())
    maj = cc.EvalBinGate(BINGATE.MAJORITY, [ct["a"], ct["b"], ct["c"]])
    wrong["MAJORITY"] = int((cc.Decrypt(sk, maj)
                             != (a + b + c >= 2)).sum())
    res["ginx_launches"] = {k: _build.LAUNCHES[k] for k in names}
    res["ginx_launches_per_gate"] = per_gate
    res["ginx_wrong"] = wrong
    print(f"GINX {GINX_SET} (n={cc.n}, N={cc.N}, d2={cc.rgsw.digits_g2}), "
          f"batch {GATE_BATCH}: wrong decryptions {wrong}; launches per "
          f"EvalBinGate {per_gate}; whole phase {res['ginx_launches']}")
    require(all(v == 0 for v in wrong.values()),
            f"GINX decryptions differ from the truth table: {wrong}")
    gate_kernels = SMALL + ("blind_rotate_cggi",)
    want_gate = {k: int(k in gate_kernels) for k in names}
    require(per_gate == want_gate,
            f"EvalBinGate launches {per_gate}, expected {want_gate}")
    require(all(res["ginx_launches"][k] == 0 for k in names
                if k not in gate_kernels),
            f"the BinFHE path launched another kernel: "
            f"{res['ginx_launches']}")

    # 4 gates on the port's plain path on the CPU, with the same keys
    t0 = time.perf_counter()
    cpu = BinFHEContext(seed=11, device="cpu").GenerateBinFHEContext(
        GINX_SET)
    cpu.ks_key = dataclasses.replace(cc.ks_key, a=cc.ks_key.a.cpu(),
                                     b=cc.ks_key.b.cpu())
    cpu.bt_key = cc.bt_key.cpu()
    four = lambda x: x.replace(a=x.a[:4].cpu(), b=x.b[:4].cpu())
    on_cpu = cpu.EvalBinGate(BINGATE.AND, four(ct["a"]), four(ct["b"]))
    same = (torch.equal(on_cpu.a, outs["AND"].a[:4].cpu())
            and torch.equal(on_cpu.b, outs["AND"].b[:4].cpu()))
    print(f"4 AND gates on the card == plain path on the CPU: {same} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    require(same, "GINX words on the card differ from the plain path")
    del cpu

    one = lambda x: x.replace(a=x.a[:1], b=x.b[:1])
    res["ginx_batch_ms"] = cuda_ms(
        lambda: cc.EvalBinGate(BINGATE.AND, ct["a"], ct["b"]), GATE_REPS, 1)
    res["ginx_single_ms"] = cuda_ms(
        lambda: cc.EvalBinGate(BINGATE.AND, one(ct["a"]), one(ct["b"])),
        GATE_REPS, 1)
    res["ginx_gates_per_s"] = GATE_BATCH / res["ginx_batch_ms"] * 1e3
    res["ginx_single_gates_per_s"] = 1e3 / res["ginx_single_ms"]
    print(f"GINX AND: {res['ginx_batch_ms']:.1f} ms per batch of "
          f"{GATE_BATCH} ({res['ginx_gates_per_s']:.1f} gates/s), "
          f"{res['ginx_single_ms']:.1f} ms for a batch of 1 "
          f"({res['ginx_single_gates_per_s']:.2f} gates/s); median of "
          f"{GATE_REPS}, CUDA events")

    # functional bootstraps at batch 4 on the same context
    p = 4
    x4 = np.arange(FUNC_BATCH) % p
    lut = cc.GenerateLUTviaFunction(lambda m, pp: (m * m) % pp, p)
    f_out, per_func = count_launches(
        lambda: cc.EvalFunc(cc.Encrypt(sk, x4, p=p), lut), names)
    got_f = cc.Decrypt(sk, f_out, p=p)
    # 2m at least 1/16 of the modulus from both sign boundaries (0, q/2)
    m_sign = np.array([4096, 60000, 16384, 49152])[:FUNC_BATCH]
    s_out, per_sign = count_launches(lambda: cc.EvalSign(cc.Encrypt(
        sk, m_sign, p=SIGN_MOD // 2, q=SIGN_MOD)), names)
    got_s = cc.Decrypt(sk, s_out, p=2)
    want_s = (2 * m_sign >= SIGN_MOD // 2).astype(np.int64)
    print(f"EvalFunc x^2 mod 4 on {x4.tolist()}: {got_f.tolist()} "
          f"(launches {per_func}); EvalSign at q={SIGN_MOD} on "
          f"{m_sign.tolist()}: {got_s.tolist()} (launches {per_sign})")
    require(np.array_equal(got_f, x4 * x4 % p), "EvalFunc decrypts wrong")
    require(np.array_equal(got_s, want_s), "EvalSign decrypts wrong")
    del cc, ct, outs
    torch.cuda.empty_cache()

    # LMKCDEY at batch 1 and 64, then AP at batch 64: AND
    for param_set, method, batches in (
            (LMK_SET, BINFHE_METHOD.LMKCDEY, LMK_BATCHES),
            (AP_SET, BINFHE_METHOD.AP, (AP_BATCH,))):
        t0 = time.perf_counter()
        cc = BinFHEContext(seed=12).GenerateBinFHEContext(param_set, method)
        sk = cc.KeyGen()
        cc.BTKeyGen(sk)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        for batch in batches:
            ca, cb = (cc.Encrypt(sk, bits[k][:batch]) for k in ("a", "b"))
            out, per = count_launches(
                lambda: cc.EvalBinGate(BINGATE.AND, ca, cb), names)
            bad = int((cc.Decrypt(sk, out) != truth["AND"][:batch]).sum())
            ms = cuda_ms(lambda: cc.EvalBinGate(BINGATE.AND, ca, cb),
                         GATE_REPS, 1)
            key = f"{method.value.lower()}_batch{batch}"
            res[key] = dict(ms=ms, gates_per_s=batch / ms * 1e3,
                            wrong=bad, launches=per, keygen_s=keygen_s)
            print(f"{param_set} AND, batch {batch}: wrong {bad}, {ms:.1f} "
                  f"ms ({batch / ms * 1e3:.1f} gates/s), launches {per}, "
                  f"keygen {keygen_s:.1f} s")
            require(bad == 0, f"{param_set} decryptions differ from the "
                    "truth table")
            form = "dm" if method == BINFHE_METHOD.AP else "lmkcdey"
            want = {k: int(k in SMALL + (f"blind_rotate_{form}",))
                    for k in names}
            require(per == want, f"{param_set} launches {per}, expected "
                    f"{want}")
        del cc
        torch.cuda.empty_cache()
    res["launches"] = {k: _build.LAUNCHES[k] for k in names}
    print(f"BinFHE phase launches: {res['launches']}")
    require(all(res["launches"][k] > 0 for k in SMALL + BLIND),
            f"a BinFHE kernel was not launched: {res['launches']}")
    return res


def matmul_case(mm, w, x, q, label) -> dict:
    """Kernel l (`mod_matmul`, the int8 tensor cores) against its plain
    version and its former form `mod_matmul_simt`, word for word; each
    call must launch the entry once and the former form never. `ms` is
    device time (`device_ms`) and `call_ms` a call, each beside the former
    form's in this run. l's bound takes the largest of its bytes, its
    LIMB_PAIRS byte-limb products a term on the tensor cores and its
    epilogue's MATMUL_EPILOGUE_OPS an output word; the former form's is
    its own, MATMUL_TERM_OPS 32-bit operations a term. Returns the case of
    each entry."""
    name, former = "mod_matmul", FORMER["mod_matmul"]
    kern = lambda: mm.mod_matmul(w, x, q)
    simt = lambda: mm.mod_matmul_simt(w, x, q)
    ref = lambda: mm._mod_matmul_ref(w, x, q)
    got, per = count_launches(kern, (name, former))
    want, by_simt = ref(), simt()
    torch.cuda.synchronize()
    err, err_simt = max_abs_err(got, want), max_abs_err(by_simt, want)
    require(err == 0 and err_simt == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"{name} {err}, {former} {err_simt})")
    require(per == {name: 1, former: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    k, d_dim, a_dim = w.shape
    b_dim = x.shape[2]
    nbytes = WORD * (w.numel() + x.numel() + k * d_dim * b_dim + k)
    terms = k * d_dim * a_dim * b_dim
    b_ms, b_by = bound(nbytes, k * d_dim * b_dim * MATMUL_EPILOGUE_OPS,
                       2 * LIMB_PAIRS * terms)
    s_ms, s_by = bound(nbytes, terms * MATMUL_TERM_OPS)
    simt_ms, simt_call_ms = device_ms(simt), cuda_ms(simt)
    common = dict(shape=[k, d_dim, a_dim, b_dim], moduli=label,
                  plain_ms=cuda_ms(ref))
    return {name: dict(common, max_abs_err=err, ms=device_ms(kern),
                       call_ms=cuda_ms(kern), staged_ms=simt_ms,
                       staged_call_ms=simt_call_ms, former=former,
                       launches_per_call=per[name], cluster=None,
                       bound_ms=b_ms, bound_by=b_by),
            former: dict(common, max_abs_err=err_simt, ms=simt_ms,
                         call_ms=simt_call_ms, bound_ms=s_ms,
                         bound_by=s_by)}


def own_pairs(v) -> int:
    """The (row, digit) pairs of a shard whose row is the digit's own."""
    rows = v.basis_qlp.k
    return sum(max(0, min((j + 1) * v.alpha, v.kql_real, v.tau0 + rows)
                   - max(j * v.alpha, v.tau0)) for j in range(v.nd))


def shard_work(v) -> dict:
    """(bytes, operations) of kernels n, o, p on one shard's views: the
    conversions count their nonzero weights as `pconv` computes (n: a
    digit's rows with a weight, into its output rows with one; o: the P
    rows with a weight, into the Q rows with one), the key
    product as K3's (`fused_work`): the NTTs of its non-own (row, digit)
    pairs, the own rows it reads from c2, the twiddles of the rows that
    transform at least once."""
    n = v.basis_qlp.ring_dim
    rows, nd, kp = v.basis_qlp.k, v.nd, v.pconv_w.shape[0]
    own = own_pairs(v)
    ntt = (nd * rows - own) * n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
    nz = v.conv_w != 0                          # [nd, alpha, rows]
    nzp = v.pconv_w != 0                        # [kp, kql_loc]
    tw_rows = rows if nd > 1 else rows - own
    return {
        "conv_digits_rows": (WORD * n * (v.kql + nd * rows),
                             sum(pconv_ops(n * int(nz[j].any(0).sum()),
                                           int(nz[j].any(1).sum()))
                                 for j in range(nd))),
        "conv_p_to_q_rows": (WORD * n * 2 * (kp + v.q.kql),
                             pconv_ops(2 * n * int(nzp.any(0).sum()),
                                       int(nzp.any(1).sum()))),
        "ntt_keymul_acc_rows": (WORD * n * (5 * nd * rows + 2 * rows
                                            + 2 * tw_rows),
                                ntt + 2 * nd * rows * n * ROWMOD_TERM_OPS),
    }


def shard_cases(sf, st, limb, gen, label) -> dict:
    """Kernels n, o, p vs their plain twins and their former forms
    (`cluster_case`: n's on `_pad_digits` of its input, the pad included)
    on every shard of one table set, on random words (the key is the table
    set's), one launch of the entry a call."""
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    out = {name: [] for name in SHARDED if "mod_matmul" not in name}
    f = st.fused
    n = f.basis_qlp.ring_dim
    pad = lambda y, v: sf.conv_digits_rows_rowmod(
        ks_fused._pad_digits(y, v), v)
    for idx in range(limb):
        v = sf.shard_view(st, limb, idx, f.basis_qlp.device)
        rows = v.basis_qlp.k
        y = rand_residues(gen, [2 ** 31 - 1] * f.kql, n)
        pc = rand_residues(gen, f.basis_p.moduli, n, (2,))
        conv = rand_residues(gen, v.basis_qlp.moduli, n, (f.nd,))
        c2 = rand_residues(gen, f.basis_ql.moduli, n)
        where = (f"{label}, shard {idx} of {limb} (Q_l*P rows {v.tau0}-"
                 f"{v.tau0 + rows - 1}, {own_pairs(v)} own)")
        work = shard_work(v)
        shape = [v.q.kql, rows, f.nd, n]
        for name, kern, former, ref, args in (
                ("conv_digits_rows", sf.conv_digits_rows, pad,
                 sf._conv_digits_rows_ref, (y,)),
                ("conv_p_to_q_rows", sf.conv_p_to_q_rows,
                 sf.conv_p_to_q_rows_rowmod, sf._conv_p_to_q_rows_ref,
                 (pc,)),
                ("ntt_keymul_acc_rows", sf.ntt_keymul_acc_rows,
                 sf.ntt_keymul_acc_rows_staged, sf._ntt_keymul_acc_rows_ref,
                 (conv, c2))):
            for entry, case in cluster_case(name, kern, former, ref, args, v,
                                            work[name], where,
                                            shape).items():
                out[entry].append(case)
    return out


def sharded_phase(cc, ct_a, ct_b, ct_c, sk, dec_ab, top31, gen, names,
                  card) -> dict:
    """The limb-sharded path (see the module docstring, phase 6); raises
    on any fault. dec_ab is dec(ct_a) * dec(ct_b)."""
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch import parallel as par
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.ops import modmatmul, ntt, ntt4step
    from openfhe_tpu_torch.parallel import ntt_sharded as ns
    from openfhe_tpu_torch.parallel import sharded as shd
    from openfhe_tpu_torch.parallel import sharded_fused as sf
    t_phase = time.perf_counter()
    n = cc.ring_dim
    r, c = ntt4step.split(n)
    cases = {name: [] for name in SHARDED}
    # kernel l at the sharded NTT's stage-1 shapes [k, R, R] x [k, R, C/L],
    # then at its edge: A = 2^15, every word q - 1 at q = 2^31 - 1 (prime),
    # whose bytes 254, 255, 255, 127 bring the limb-pair sums to 255^2 A
    m31 = 2 ** 31 - 1
    full = lambda *shape: torch.full(shape, m31 - 1, dtype=torch.int32,
                                     device=cc.device)
    mm_inputs = []
    for moduli, label, limbs in ((cc.moduli_q, "Q (31 towers)", LIMBS),
                                 (top31, "largest 31-bit primes", (2,))):
        t = ntt4step.dev_tables(tuple(moduli), n, str(cc.device))
        for limb in limbs:
            x = rand_residues(gen, moduli, c // limb, (r,)).transpose(0, 1)
            mm_inputs.append((t["wr"], x.contiguous(), t["q"],
                              f"{label}, stage 1 of a shard at limb {limb}"))
    mm_inputs.append((full(1, 16, 1 << 15), full(1, 1 << 15, 8),
                      torch.tensor([[m31]], dtype=torch.int32,
                                   device=cc.device),
                      "edge: A = 2^15, every word 2^31 - 2 (q = 2^31 - 1)"))
    for args in mm_inputs:
        for name, case in matmul_case(modmatmul, *args).items():
            cases[name].append(case)
    del mm_inputs
    # kernels n, o, p on every shard of four table sets; the last a padded
    # level whose second digit covers no rows of y (n writes it as zeros)
    key31 = rand_key(gen, top31, n)
    st = {lvl: sf.make_sharded_fused_tables(cc, cc.size_ql(lvl))
          for lvl in (1, 3)}
    b31q = make_basis(top31[:4], n, device=cc.device)
    b31p = make_basis(top31[4:], n, device=cc.device)
    st31 = sf.make_sharded_fused_tables_basis(b31q, b31p, 4, 2, key31)
    st31_pad = sf.make_sharded_fused_tables_basis(b31q, b31p, 1, 2, key31,
                                                  pad_to=2)
    for tabs, limb, label in (
            (st[1], 2, "level 1 (30 Q + 16 P)"),
            (st[3], 4, "level 3 (28 Q + 16 P)"),
            (st31, 2, "largest 31-bit primes (4 Q + 2 P)"),
            (st31_pad, 2, "largest 31-bit primes, 1 Q padded to 2 + 2 P, "
                          "digit 1 empty")):
        for name, rows in shard_cases(sf, tabs, limb, gen, label).items():
            cases[name] += rows
    del key31, st31, st31_pad
    kernel_s = time.perf_counter() - t_phase

    # the path, counted
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    mesh = {limb: par.make_mesh(limb) for limb in LIMBS}
    mesh["2x2"] = par.make_mesh(2, dp=2)
    for name, m in mesh.items():
        print(f"mesh {name}: {m}")
    same = {}
    # the sharded NTT on the Q basis
    x = rand_residues(gen, cc.moduli_q, n)
    y = ntt._ntt_fwd_cu(x, cc.basis_q)
    per_ntt = {}
    for limb in LIMBS:
        fwd, per_ntt[limb] = count_launches(
            lambda: ns.ntt_fwd_sharded(x, cc.basis_q, mesh[limb]), names)
        inv = ns.ntt_inv_sharded(y, cc.basis_q, mesh[limb])
        same[f"sharded NTT fwd, limb {limb}"] = torch.equal(fwd, y)
        same[f"sharded NTT inv, limb {limb}"] = (
            torch.equal(inv, ntt._ntt_inv_cu(y, cc.basis_q))
            and torch.equal(inv, x))
    # the sharded EvalMult, against the single-card fused one
    lvl = {l: (cc.LevelReduce(ct_a, l), cc.LevelReduce(ct_b, l))
           for l in (1, 3)}
    want = {l: cc.EvalMult(*lvl[l]) for l in (1, 3)}
    ins = {l: [e for ct in lvl[l] for e in par.shard_ciphertext(
        ct, mesh[limb]).elements] for l, limb in ((1, 2), (3, 4))}
    gather = lambda parts, m: [par.unshard(p, m, ROWS) for p in parts]
    equal = lambda got, ref: all(torch.equal(g, w)
                                 for g, w in zip(got, ref))
    out1, per1 = count_launches(
        lambda: sf.mult_relin_sharded(*ins[1], st[1], mesh[2]), names)
    out3, per3 = count_launches(
        lambda: sf.mult_relin_sharded(*ins[3], st[3], mesh[4]), names)
    same["EvalMult level 1, limb 2"] = equal(gather(out1, mesh[2]),
                                             want[1].elements)
    g3 = gather(out3, mesh[4])
    same["EvalMult level 3, limb 4"] = equal(g3, want[3].elements)
    same["portable body, level 1, limb 2"] = equal(gather(
        shd.mult_relin_sharded(*ins[1], st[1], mesh[2]), mesh[2]),
        want[1].elements)
    # the two-level chain: level 3, in-region rescale, level 4 padded
    k3, k4 = cc.size_ql(3), cc.size_ql(4)
    dt3 = shd.make_sharded_drop_tables(cc, k3)
    resc = [shd.drop_last_and_scale_sharded(p, dt3, k3 - 1, mesh[4])
            for p in out3]
    st4 = sf.make_sharded_fused_tables(cc, k4, pad_to=k3)
    out4 = sf.mult_relin_sharded(*resc, *resc, st4, mesh[4])
    want_r = cc.Rescale(want[3])
    want4 = cc.EvalMult(want_r, want_r)
    padded = lambda got, ref: all(torch.equal(g[:k4], w) and not g[k4:].any()
                                  for g, w in zip(got, ref))
    same["in-region rescale, level 3 -> 4"] = padded(gather(resc, mesh[4]),
                                                     want_r.elements)
    same[f"EvalMult level 4 ({k4} rows padded to {k3}), limb 4"] = padded(
        gather(out4, mesh[4]), want4.elements)
    # dp 2 x limb 2: the pairs (a, b) and (c, b) at level 1
    c1 = cc.LevelReduce(ct_c, 1)
    spec = ("dp", "limb", None)
    pairs = [par.shard(torch.stack([u, v]), mesh["2x2"], spec)
             for u, v in zip(lvl[1][0].elements + lvl[1][1].elements,
                             c1.elements + lvl[1][1].elements)]
    outb = sf.mult_relin_sharded(*pairs, st[1], mesh["2x2"])
    want_c = cc.EvalMult(c1, lvl[1][1])
    gb = [par.unshard(p, mesh["2x2"], spec) for p in outb]
    same["dp 2 x limb 2, two pairs"] = all(
        torch.equal(g[0], w0) and torch.equal(g[1], w1)
        for g, w0, w1 in zip(gb, want[1].elements, want_c.elements))
    if torch.cuda.device_count() >= 2:
        two = par.Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]])
        ab = [e for ct in lvl[1] for e in par.shard_ciphertext(
            ct, two).elements]
        same["two cards, level 1, limb 2"] = equal(
            gather(sf.mult_relin_sharded(*ab, st[1], two), two),
            want[1].elements)
    else:
        print("multi-card check not run: 1 card visible")
    launches = {k: _build.LAUNCHES[k] for k in names}
    path_s = time.perf_counter() - t0
    # decryption of the rescaled level-3 product
    prod3 = dataclasses.replace(want[3], elements=tuple(g3))
    dec3 = np.asarray(cc.Decrypt(sk, cc.Rescale(prod3)).values).real
    mult_err = float(np.abs(dec3 - dec_ab).max())
    print(f"sharded path: {path_s:.2f} s; launches {launches}")
    print(f"per sharded EvalMult limb 2 {per1}; limb 4 {per3}; per sharded "
          f"NTT {per_ntt}")
    print(f"sharded == single card: {same}")
    print(f"Rescale(sharded level-3 product): max |dec - dec(a)*dec(b)| = "
          f"{mult_err:.3e} (limit {MULT_TOL})")
    require(all(same.values()), f"the sharded path differs: {same}")
    require(mult_err <= MULT_TOL, f"sharded EvalMult+Rescale error "
            f"{mult_err} above {MULT_TOL}")
    for limb, got in ((2, per1), (4, per3)):
        want_l = {k: limb * (k in SHARDED_CHAIN) for k in names}
        require(got == want_l, f"sharded EvalMult launches {got}, expected "
                f"{want_l}")
    for limb, got in per_ntt.items():
        want_l = {k: 2 * limb * (k == "mod_matmul") for k in names}
        require(got == want_l, f"sharded NTT launches {got}, expected "
                f"{want_l}")
    require(all(launches[k] > 0 for k in SHARDED
                if k not in SHARDED_STAGED),
            f"a kernel was not launched on the sharded path: {launches}")
    require(not any(launches[k] for k in SHARDED_STAGED),
            f"the sharded path ran a former form: {launches}")

    b = cc.basis_q
    times = {
        "sharded_evalmult_level1_limb2_ms": cuda_ms(
            lambda: sf.mult_relin_sharded(*ins[1], st[1], mesh[2]), reps=10),
        "evalmult_level1_ms": cuda_ms(lambda: cc.EvalMult(*lvl[1]), reps=10),
        "sharded_evalmult_level3_limb4_ms": cuda_ms(
            lambda: sf.mult_relin_sharded(*ins[3], st[3], mesh[4]), reps=10),
        "evalmult_level3_ms": cuda_ms(lambda: cc.EvalMult(*lvl[3]), reps=10),
        "portable_evalmult_level1_limb2_ms": cuda_ms(
            lambda: shd.mult_relin_sharded(*ins[1], st[1], mesh[2]), reps=10),
        "ntt_cu_fwd_ms": cuda_ms(lambda: ntt._ntt_fwd_cu(x, b), reps=10),
        "ntt_cu_inv_ms": cuda_ms(lambda: ntt._ntt_inv_cu(y, b), reps=10),
        "ntt_fwd_4step_ms": cuda_ms(lambda: ntt4step.ntt_fwd_4step(x, b),
                                    reps=10),
        "ntt_inv_4step_ms": cuda_ms(lambda: ntt4step.ntt_inv_4step(y, b),
                                    reps=10),
    }
    for limb in LIMBS:
        times[f"ntt_fwd_sharded_limb{limb}_ms"] = cuda_ms(
            lambda: ns.ntt_fwd_sharded(x, b, mesh[limb]), reps=10)
        times[f"ntt_inv_sharded_limb{limb}_ms"] = cuda_ms(
            lambda: ns.ntt_inv_sharded(y, b, mesh[limb]), reps=10)
    print(f"sharded op times (median of 10, CUDA events, {card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    for name, rows in cases.items():
        for case in rows:
            extra = "" if "staged_ms" not in case else (
                f"(call {case['call_ms']:.4f})  {case['former']} "
                f"{case['staged_ms']:.4f} ms (call "
                f"{case['staged_call_ms']:.4f})  ")
            print(f"  {name:20s} {str(case['shape']):22s} {case['moduli']} "
                  f"kernel {case['ms']:.4f} ms  {extra}plain "
                  f"{case['plain_ms']:.4f} ms  bound {case['bound_ms']:.4f}"
                  f" ms ({case['bound_by']})  max_abs_err "
                  f"{case['max_abs_err']}")
    phase_s = time.perf_counter() - t_phase
    print(f"sharded phase: {phase_s:.1f} s ({kernel_s:.1f} s kernel cases)")
    return dict(cases=cases, launches=launches, per_mult=per3,
                per_mult_limb2=per1, per_ntt=per_ntt[4], same=same,
                mult_err=mult_err, times=times, seconds=phase_s)


def same_words(x, y) -> bool:
    return len(x.elements) == len(y.elements) and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(x.elements, y.elements))


def main() -> int:
    global INT32_OPS_PER_S
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.lattice.automorph import (
        eval_indices, rotation_automorphism_index)
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.ops import modmatmul, ntt
    from openfhe_tpu_torch.pke import context
    from openfhe_tpu_torch.pke.keys import EvalKey
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    from openfhe_tpu_torch.pke.parameters import main_path_params

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    INT32_OPS_PER_S, mhz, sms = int32_rate()
    print(f"{card}: max SM clock {mhz:g} MHz x {sms} SMs x "
          f"{INT32_OPS_PER_CLOCK_PER_SM} a clock = {INT32_OPS_PER_S:.4g} "
          "32-bit integer op/s (the operations bound's rate)")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # 2. build
    built = _build.build()
    print(f"build: {built.seconds:.1f} s for {len(built.libs)} libraries")
    for name, log in built.log.items():
        entry = ""
        for line in log.splitlines():
            found = re.search(r"entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            elif ("registers" in line or "spill" in line
                  or "error" in line.lower()):
                print(f"  nvcc[{name}] {entry}: {line.strip()}")

    params = main_path_params()
    t0 = time.perf_counter()
    cc = fhe.GenCryptoContext(params, seed=7)
    top = cc.hybrid_tables(cc.size_ql(0))
    print(f"context: {len(cc.moduli_q)} Q + {len(cc.moduli_p)} P towers, "
          f"N={cc.ring_dim}, {len(top.parts)} digits, device {cc.device}, "
          f"{time.perf_counter() - t0:.1f} s")
    require((len(cc.moduli_q), len(cc.moduli_p), len(top.parts))
            == (31, 16, 2), "unexpected main-path parameters")
    require(top.fused is not None, "the CUDA context has no fused tables")

    # 3. kernel phase: kernel vs plain version at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = cc.ring_dim
    top31 = []
    q = 1 << 31
    while len(top31) < 6:
        q = nbtheory.previous_prime(q, 2 * n)
        top31.append(q)
    cases = {name: [] for name in SLICE1 + FUSED}
    staged = {name: [] for name in STAGED}
    # Rescale's two shapes (the 30 kept towers of both elements, the
    # dropped tower), a batch at N=2^13 (clusters of one block) and, where
    # cluster_geometry takes it, N=2^17 (clusters of 8)
    big = 1 << 17
    top31_big = [nbtheory.previous_prime(1 << 31, 2 * big)]
    while len(top31_big) < 6:
        top31_big.append(nbtheory.previous_prime(top31_big[-1], 2 * big))
    ntt_shapes = [
        (cc.basis_q, "Q (31 towers)", ()),
        (cc.basis_qp, "QP (47 towers)", ()),
        (make_basis(top31[:4], n, device="cuda"), "largest 31-bit primes",
         ()),
        (cc.basis_q.slice(0, 30), "Rescale: 30 kept towers x 2", (2,)),
        (cc.basis_q.slice(30, 31), "Rescale: the dropped tower", ()),
        (make_basis(cc.moduli_q[:3], 1 << 13, device="cuda"),
         "N=2^13, batch of 2", (2,))]
    # every other ring the kernel is compiled for at N >= 2^12: one block a
    # tower (2^12), clusters of 2 (2^14) and 4 (2^15)
    for log_n in (12, 14, 15):
        ntt_shapes.append((make_basis(top31[:4], 1 << log_n, device="cuda"),
                           f"N=2^{log_n}, 31-bit primes", ()))
    if ntt.cluster_geometry(big):
        ntt_shapes.append((make_basis(top31_big[:4], big, device="cuda"),
                           "N=2^17, 31-bit primes", ()))
    for basis, label, lead in ntt_shapes:
        for name, case in ntt_cases(ntt, basis, gen, label, lead).items():
            (staged if name in STAGED else cases)[name].append(case)
    # kernel k at the hoisted rotation's shapes (digit -> complement, 16 ->
    # 31 and 15 -> 32, and the mod-down's P -> Q, 16 -> 31), and a batch
    rowmod_shapes = [(part.switch, part.compl_basis,
                      f"digit {part.start}:{part.end} -> complement", ())
                     for part in top.parts]
    rowmod_shapes += [
        (top.moddown.switch, top.basis_ql, "P -> Q mod-down", ()),
        (top.moddown.switch, top.basis_ql, "P -> Q mod-down, batch 2", (2,))]
    for tab, d_basis, label, lead in rowmod_shapes:
        for name, case in rowmod_case(modmatmul, tab, d_basis, gen, label,
                                      lead).items():
            (staged if name in STAGED else cases)[name].append(case)
    # the fused kernels: level 0, level 1 (digit 1 has 14 towers) and a
    # 31-bit chain in two digits and in one, each with a random key over
    # its own QP moduli
    key_main = rand_key(gen, list(cc.moduli_q) + list(cc.moduli_p), n)
    basis31 = make_basis(top31, n, device="cuda")
    key31 = rand_key(gen, top31, n)
    for tabs, key, label in (
            (top.fused, key_main, "level 0 (31 Q + 16 P)"),
            (cc.hybrid_tables(cc.size_ql(1)).fused, key_main,
             "level 1 (30 Q + 16 P)"),
            (ks_fused.make_fused_ks_tables(basis31, 4, 4, 2), key31,
             "largest 31-bit primes (4 Q + 2 P)"),
            (ks_fused.make_fused_ks_tables(basis31, 4, 4, 1), key31,
             "largest 31-bit primes (4 Q + 2 P), one digit")):
        for name, case in fused_cases(ks_fused, tabs, key, gen, label):
            (staged if name in STAGED else cases)[name].append(case)
    # K1/K4, K3, K45, K6f and K2 (and K1t, K6) by level, 44 down to 17
    # Q_l*P towers in two digits and in one: their time against the
    # clusters a wave places
    for lvl in (3, 11, 15, 23, 30):
        tabs = cc.hybrid_tables(cc.size_ql(lvl)).fused
        for name, case in fused_cases(
                ks_fused, tabs, key_main, gen,
                f"level {lvl} ({tabs.kql} Q + {tabs.kp} P)",
                tuple(FORMER)):
            (staged if name in STAGED else cases)[name].append(case)
    rings = [(1 << log_n, top31) for log_n in (12, 14, 15)]
    if ntt.cluster_geometry(big):
        rings.append((big, top31_big))
    wide31 = list(top31)
    while len(wide31) < 4 + max(WIDE_P):
        wide31.append(nbtheory.previous_prime(wide31[-1], 2 * n))
    for name, case in cluster_shape_cases(ks_fused, gen, rings, wide31, n):
        (staged if name in STAGED else cases)[name].append(case)
    del key_main, key31
    # ntt_subscale with BGV's t = 65537 (K6's t multiply) and with one and
    # two addends (the final add of an automorphism or KeySwitch, and of
    # Relinearize), each beside its staged form, at level 0
    ext = rand_residues(gen, top.basis_qlp.moduli, n, (2,))
    tabs_t = ks_fused.make_fused_ks_tables(top.basis_qlp, cc.size_ql(0),
                                           len(cc.moduli_q), 2,
                                           ns_int=65537)
    convq = rand_residues(gen, top.basis_ql.moduli, n, (2,))
    adds = [rand_residues(gen, top.basis_ql.moduli, n) for _ in range(2)]
    with_adds = lambda fn: (lambda cq, x, a0, a1, t: fn(cq, x, t, a0, a1))
    for tabs, given, label in (
            (tabs_t, (None, None), "level 0, t = 65537"),
            (top.fused, (adds[0], None), "level 0, addend to element 0"),
            (top.fused, tuple(adds), "level 0, both addends")):
        for name, case in cluster_case(
                "ntt_subscale", with_adds(ks_fused.ntt_subscale),
                with_adds(ks_fused.ntt_subscale_staged),
                with_adds(ks_fused._ntt_subscale_ref),
                (convq, ext, *given), tabs,
                fused_work(tabs, sum(a is not None for a in given))[
                    "ntt_subscale"], label).items():
            (staged if name in STAGED else cases)[name].append(case)
    del convq, adds
    del ext
    small = ntt_small_cases(gen)
    blind = blind_rotate_cases(gen)
    for name, rows in blind.items():
        for c in rows:
            print(f"  {name:20s} {str(c['shape']):24s} {c['moduli']:15s} "
                  f"kernel {c['ms']:.3f} ms (call {c['call_ms']:.3f})  "
                  f"per-step loop {c['plain_ms']:.1f} ms  bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']})  max_abs_err "
                  f"{c['max_abs_err']}"
                  + ("" if c["split_equal"] is None else
                     f"  split at step {SPLIT_STEP} == whole: "
                     f"{c['split_equal']}"))
    for name, rows in small.items():
        for c in rows:
            print(f"  {name:18s} {str(c['shape']):18s} k={c['towers']} "
                  f"{c['moduli']:45s} kernel {c['ms']:.4f} ms (call "
                  f"{c['call_ms']:.4f})  ntt.cu {c['ntt_cu_ms']:.4f} ms "
                  f"(call {c['ntt_cu_call_ms']:.4f})  plain "
                  f"{c['plain_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']}")
    for name, rows in {**cases, **staged}.items():
        for c in rows:
            extra = "" if "staged_ms" not in c else (
                f"(call {c['call_ms']:.4f})  {c.get('former', 'staged')} "
                f"{c['staged_ms']:.4f} ms (call {c['staged_call_ms']:.4f})  ")
            print(f"  {name:18s} {str(c['shape']):18s} {c['moduli']:32s} "
                  f"kernel {c['ms']:.4f} ms  {extra}plain "
                  f"{c['plain_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']}")

    # 4. main path, counted
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    kp = cc.KeyGen()
    sk = kp.secret_key
    cc.EvalMultKeyGen(sk)
    cc.EvalRotateKeyGen(sk, [1, -1])
    cc.EvalSumKeyGen(sk, SUM_BATCH)
    cc.EvalConjugateKeyGen(sk)
    rng = np.random.default_rng(0)
    z = rng.uniform(-Z_MAX, Z_MAX, size=cc.slots)
    # complex slots for the conjugation, |w| <= Z_MAX
    w = (rng.uniform(-Z_MAX, Z_MAX, cc.slots)
         + 1j * rng.uniform(-Z_MAX, Z_MAX, cc.slots)) / np.sqrt(2)
    pt = cc.MakeCKKSPackedPlaintext(z)
    ct_a = cc.Encrypt(kp.public_key, pt)
    ct_b = cc.Encrypt(kp.public_key, pt)
    ct_c = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(w))
    ek_mult = cc.eval_mult_keys[sk.key_tag]
    auto_keys = cc.eval_automorphism_keys[sk.key_tag]

    def counted(fn):
        """fn() and the launches it made, per kernel."""
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: _build.LAUNCHES[k] - before.get(k, 0) for k in cases}

    # the unfused chain, as the JAX package builds its oracle: the same
    # level tables without the fused ones
    plain = lambda ct: dataclasses.replace(
        cc.hybrid_tables(cc.size_ql(ct.level)), fused=None)

    def relin_unfused(ct3):
        return dataclasses.replace(ct3, elements=context.relin_hybrid(
            *ct3.elements, ek_mult, plain(ct3)))

    def rotate_unfused(ct, r):
        g = rotation_automorphism_index(r, n)
        idx = torch.from_numpy(eval_indices(n, g).astype(np.int64)).cuda()
        return dataclasses.replace(ct, elements=context.automorph_hybrid(
            ct.elements, idx, auto_keys[g], plain(ct)))

    unfused = lambda x, y: relin_unfused(cc.EvalMultNoRelin(x, y))
    relin = lambda x, y: cc.Relinearize(cc.EvalMultNoRelin(x, y))
    prod, per_mult = counted(lambda: cc.EvalMult(ct_a, ct_b))
    prod_u, per_unfused = counted(lambda: unfused(ct_a, ct_b))
    prod_r, per_relin = counted(lambda: relin(ct_a, ct_b))
    rot, per_rot = {}, {}
    for r in (1, -1):
        rot[r], per_rot[r] = counted(lambda r=r: cc.EvalRotate(ct_a, r))
    conj, per_conj = counted(lambda: cc.EvalConjugate(ct_c))
    digits, per_pre = counted(lambda: cc.EvalFastRotationPrecompute(ct_a))
    fast, per_fast = {}, {}
    for r in (1, -1):
        fast[r], per_fast[r] = counted(
            lambda r=r: cc.EvalFastRotation(ct_a, r, 0, digits))
    resc = cc.Rescale(prod)
    prod1, per_mult1 = counted(lambda: cc.EvalMult(resc, resc))
    prod1_u = unfused(resc, resc)
    prod1_r, per_relin1 = counted(lambda: relin(resc, resc))
    rot1, per_rot1 = counted(lambda: cc.EvalRotate(resc, 1))
    resc1 = cc.Rescale(prod1)
    # rotations at the product's scale 2^52, then Rescale
    rot_p = {r: cc.Rescale(cc.EvalRotate(prod, r)) for r in (1, -1)}
    digits_p = cc.EvalFastRotationPrecompute(prod)
    fast_p = {r: cc.Rescale(cc.EvalFastRotation(prod, r, 0, digits_p))
              for r in (1, -1)}
    prod_c = cc.EvalMult(ct_c, ct_b)
    conj_p = cc.Rescale(cc.EvalConjugate(prod_c))
    isum = cc.Rescale(cc.EvalInnerProduct(ct_a, ct_b, SUM_BATCH))
    decv = lambda ct: np.asarray(cc.Decrypt(sk, ct).values)
    dec = cc.Decrypt(sk, resc)
    dec1 = decv(resc1).real
    dec_a, dec_b, dec_c = decv(ct_a), decv(ct_b), decv(ct_c)
    dec_resc_c = decv(cc.Rescale(prod_c))
    dec_rot = {r: decv(rot[r]) for r in rot}
    dec_fast = {r: decv(fast[r]) for r in fast}
    dec_conj = decv(conj)
    dec_rot_p = {r: decv(rot_p[r]) for r in rot_p}
    dec_fast_p = {r: decv(fast_p[r]) for r in fast_p}
    dec_conj_p, dec_isum = decv(conj_p), decv(isum)
    launches = {k: _build.LAUNCHES[k] for k in cases}
    staged_launches = {k: _build.LAUNCHES[k] for k in STAGED}
    path_s = time.perf_counter() - t0
    vals = np.asarray(dec.values)
    require(vals.shape == (cc.slots,) and bool(np.isfinite(vals).all())
            and bool(np.isfinite(dec1).all())
            and bool(np.isfinite(dec_isum).all()),
            "decrypted values are not finite or of the wrong shape")
    err = float(np.abs(vals.real - z * z).max())
    fresh_err = float(np.abs(dec_a.real - z).max())
    mult_err = float(np.abs(vals.real - dec_a.real * dec_b.real).max())
    err1 = float(np.abs(dec1 - z ** 4).max())
    mult_err1 = float(np.abs(dec1 - vals.real ** 2).max())
    print(f"main path: {path_s:.2f} s; launches {launches}; staged forms "
          f"{staged_launches}")
    print(f"per EvalMult (fused) {per_mult}; level 1 {per_mult1}; per "
          f"EvalMultNoRelin + unfused relinearization {per_unfused}")
    print(f"per Relinearize(EvalMultNoRelin) {per_relin}; level 1 "
          f"{per_relin1}; per EvalRotate +1 {per_rot[1]}, -1 {per_rot[-1]}, "
          f"level 1 {per_rot1}; per EvalConjugate {per_conj}")
    print(f"EvalFastRotationPrecompute {per_pre}; EvalFastRotation +1 "
          f"{per_fast[1]}, -1 {per_fast[-1]}")
    print(f"z ~ U(-{Z_MAX}, {Z_MAX}): max |dec(ct) - z| = {fresh_err:.3e}, "
          f"max |dec - dec(a)*dec(b)| = {mult_err:.3e} (limit {MULT_TOL}), "
          f"max |dec - z*z| = {err:.3e} (limit {TOL}); level 1: "
          f"max |dec1 - dec^2| = {mult_err1:.3e} (limit {MULT_TOL}), "
          f"max |dec1 - z^4| = {err1:.3e} (limit {TOL})")

    # words: fused == unfused on the card, at both levels
    same = {"EvalMult": same_words(prod, prod_u),
            "EvalMult, level 1": same_words(prod1, prod1_u),
            "Relinearize": same_words(prod_r, prod_u),
            "Relinearize, level 1": same_words(prod1_r, prod1_u),
            "EvalRotate +1": same_words(rot[1], rotate_unfused(ct_a, 1)),
            "EvalRotate -1": same_words(rot[-1], rotate_unfused(ct_a, -1)),
            "EvalRotate +1, level 1": same_words(rot1,
                                                 rotate_unfused(resc, 1))}
    print(f"fused == unfused chain on the card: {same}")
    require(all(same.values()),
            f"the fused chain differs from the unfused one: {same}")
    require(mult_err <= MULT_TOL and mult_err1 <= MULT_TOL,
            f"EvalMult+Rescale error {mult_err} / {mult_err1} above "
            f"{MULT_TOL}")
    require(err <= TOL and err1 <= TOL,
            f"decryption error {err} / {err1} above {TOL}")

    # decryptions of the automorphisms (see the noise note at the top)
    resc_vals = np.asarray(dec.values)
    hi = {f"EvalRotate {r:+d}": np.abs(dec_rot_p[r]
                                       - np.roll(resc_vals, -r)).max()
          for r in (1, -1)}
    hi.update({f"EvalFastRotation {r:+d}": np.abs(
        dec_fast_p[r] - np.roll(resc_vals, -r)).max() for r in (1, -1)})
    hi["EvalConjugate"] = np.abs(dec_conj_p - np.conj(dec_resc_c)).max()
    mean_slots = modown_mean_slots(cc, sk, ct_a.scale)
    lo = {f"EvalRotate {r:+d}": dec_rot[r] - np.roll(dec_a, -r)
          for r in (1, -1)}
    lo.update({f"EvalFastRotation {r:+d}": dec_fast[r] - np.roll(dec_a, -r)
               for r in (1, -1)})
    lo["EvalConjugate"] = dec_conj - np.conj(dec_c)
    raw = {k: float(np.abs(v).max()) for k, v in lo.items()}
    resid = {k: float(np.abs(v - mean_slots).max()) for k, v in lo.items()}
    ladder = resc_vals.copy()
    j = 1
    while j < SUM_BATCH:
        ladder = ladder + np.roll(ladder, -j)
        j <<= 1
    sum_err = float(np.abs(dec_isum - ladder).max())
    print(f"automorphisms at scale 2^52, then Rescale, against the "
          f"automorphism of dec(Rescale(prod)): "
          f"{ {k: float(v) for k, v in hi.items()} } (limit {MULT_TOL})")
    print(f"automorphisms at level 0 (scale 2^26) against the automorphism "
          f"of dec(ct): max error {raw}; predicted mod-down rounding mean "
          f"max {float(np.abs(mean_slots).max()):.3e}; residual after it "
          f"{resid} (limit {ROT_RESID_TOL})")
    print(f"Rescale(EvalInnerProduct(a, b, {SUM_BATCH})) against the ladder "
          f"on dec(Rescale(prod)): max error {sum_err:.3e} "
          f"(limit {SUM_TOL})")
    require(all(v <= MULT_TOL for v in hi.values()),
            f"automorphism error at scale 2^52 above {MULT_TOL}: {hi}")
    require(all(v <= ROT_RESID_TOL for v in resid.values()),
            f"automorphism error at level 0 beyond the mod-down model: "
            f"{resid}")
    require(sum_err <= SUM_TOL, f"EvalSum error {sum_err} above {SUM_TOL}")

    # launches: each op through its own chain, nothing else
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    require(not any(staged_launches.values()),
            f"the main path ran a staged form: {staged_launches}")
    launches.update(staged_launches)
    want_mult = {k: int(k in MULT_CHAIN) for k in cases}
    want_ks = {k: int(k in KS_CHAIN) for k in cases}
    require(per_mult == want_mult and per_mult1 == want_mult,
            f"EvalMult launches {per_mult} / {per_mult1}, expected "
            f"{want_mult}")
    from openfhe_tpu_torch.trace_evalmult import OWN
    prod3 = cc.EvalMultNoRelin(ct_a, ct_b)
    mult_kernels = device_kernels(lambda: cc.EvalMult(ct_a, ct_b))
    own = [k for k in mult_kernels
           if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
    short = lambda k: (re.search(r"::(\w+(?:<[^<>]*>)?)\(", k)
                       or re.search(r"^(.*)$", k)).group(1)
    print(f"EvalMult on the card: {len(mult_kernels)} device kernels, "
          f"{len(own)} of csrc/: " + ", ".join(map(short, mult_kernels)))
    require(len(mult_kernels) == MULT_KERNELS == len(own),
            f"EvalMult ran {len(mult_kernels)} device kernels ({len(own)} "
            f"of csrc/), expected {MULT_KERNELS}, all of csrc/")
    relin_kernels = device_kernels(lambda: cc.Relinearize(prod3))
    own = [k for k in relin_kernels
           if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
    print(f"Relinearize on the card: {len(relin_kernels)} device kernels, "
          f"{len(own)} of csrc/: " + ", ".join(map(short, relin_kernels)))
    require(len(relin_kernels) == RELIN_KERNELS == len(own),
            f"Relinearize ran {len(relin_kernels)} device kernels "
            f"({len(own)} of csrc/), expected {RELIN_KERNELS}, all of csrc/")
    for label, got in (("Relinearize", per_relin),
                       ("Relinearize, level 1", per_relin1),
                       ("EvalRotate +1", per_rot[1]),
                       ("EvalRotate -1", per_rot[-1]),
                       ("EvalRotate, level 1", per_rot1),
                       ("EvalConjugate", per_conj)):
        require(got == want_ks, f"{label} launches {got}, expected "
                f"{want_ks}")
    require(per_unfused == {k: 4 * (k in SLICE1) for k in cases},
            f"unfused launches {per_unfused}, expected 4 of each slice-1 "
            "kernel")
    want_hoist = {k: 2 * (k in SLICE1) for k in cases}
    require(per_pre == want_hoist and per_fast[1] == want_hoist
            and per_fast[-1] == want_hoist,
            f"hoisted rotation launches {per_pre} / {per_fast}, expected "
            f"{want_hoist} each")

    times = {
        "evalmult_ms": cuda_ms(lambda: cc.EvalMult(ct_a, ct_b), reps=10),
        "evalmult_unfused_ms": cuda_ms(lambda: unfused(ct_a, ct_b),
                                       reps=10),
        "relinearize_ms": cuda_ms(lambda: cc.Relinearize(prod3), reps=10),
        "relinearize_unfused_ms": cuda_ms(lambda: relin_unfused(prod3),
                                          reps=10),
        "evalrotate_ms": cuda_ms(lambda: cc.EvalRotate(ct_a, 1), reps=10),
        "evalfastrotation_ms": cuda_ms(
            lambda: cc.EvalFastRotation(ct_a, 1, 0, digits), reps=10),
        "evalfastrotation_precompute_ms": cuda_ms(
            lambda: cc.EvalFastRotationPrecompute(ct_a), reps=10),
        f"evalsum{SUM_BATCH}_ms": cuda_ms(
            lambda: cc.EvalSum(ct_a, SUM_BATCH), reps=10),
        "rescale_ms": cuda_ms(lambda: cc.Rescale(prod), reps=10),
        "encrypt_ms": cuda_ms(lambda: cc.Encrypt(kp.public_key, pt),
                              reps=10),
    }
    print(f"op times (median of 10, CUDA events, {card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    # the same EvalMult and one EvalRotate on the port's plain path on the
    # CPU
    t0 = time.perf_counter()
    cpu = fhe.GenCryptoContext(dataclasses.replace(params), seed=7,
                               device="cpu")
    on_cpu_key = lambda ek: EvalKey(bv=ek.bv.cpu(), av=ek.av.cpu(),
                                    key_tag=ek.key_tag)
    cpu.eval_mult_keys[ek_mult.key_tag] = on_cpu_key(ek_mult)
    g1 = rotation_automorphism_index(1, n)
    cpu.InsertEvalAutomorphismKey({g1: on_cpu_key(auto_keys[g1])},
                                  sk.key_tag)
    on_cpu = lambda ct: dataclasses.replace(
        ct, elements=tuple(e.cpu() for e in ct.elements))
    same_mult = same_words(prod, cpu.EvalMult(on_cpu(ct_a), on_cpu(ct_b)))
    same_rot = same_words(rot[1], cpu.EvalRotate(on_cpu(ct_a), 1))
    cpu_s = time.perf_counter() - t0
    print(f"on the card == plain path on the CPU: EvalMult {same_mult}, "
          f"EvalRotate +1 {same_rot} ({cpu_s:.1f} s on the CPU)")
    require(same_mult and same_rot,
            "words on the card differ from the plain path")

    # 5. BinFHE, counted from its context on
    names = tuple(cases) + STAGED + SMALL + BLIND + SHARDED
    binfhe = binfhe_phase(names)
    per_gate = binfhe["ginx_launches_per_gate"]
    launches.update({k: binfhe["launches"][k] for k in SMALL + BLIND})

    # 6. the limb-sharded path, counted from its first sharded op on
    sharded = sharded_phase(cc, ct_a, ct_b, ct_c, sk,
                            dec_a.real * dec_b.real, top31, gen, names,
                            card)
    launches.update({k: sharded["launches"][k] for k in SHARDED})

    # 7. the kernels line, then the device line
    kernels = []
    for name, rows in {**cases, **staged, **small, **blind,
                       **sharded["cases"]}.items():
        head = rows[0]        # level 0 / Q (31 towers) / digit 0
        kernels.append(dict(
            name=name, route="cuda",
            source="openfhe_tpu_torch/" + WHERE[name][0],
            replaces=WHERE[name][1], launches=launches[name],
            launches_per_evalmult=per_mult.get(name, 0),
            launches_per_unfused_mult=per_unfused.get(name, 0),
            launches_per_relinearize=per_relin.get(name, 0),
            launches_per_rotate=per_rot[1].get(name, 0),
            launches_per_ginx_gate=per_gate[name],
            launches_per_sharded_mult=sharded["per_mult"][name],
            launches_per_sharded_ntt=sharded["per_ntt"][name],
            max_abs_err=max(c["max_abs_err"] for c in rows),
            bit_exact=all(c["max_abs_err"] == 0 for c in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, shape=head["shape"],
            **({k: head[k] for k in ("call_ms", "ntt_cu_ms",
                                      "ntt_cu_call_ms")}
               if name in SMALL else {}),
            **({k: head[k] for k in ("call_ms", "staged_ms",
                                      "staged_call_ms", "launches_per_call",
                                      "cluster")}
               if name in ("ntt_fwd", "ntt_inv") + tuple(FORMER) else {}),
            **({"former": FORMER[name]} if name in FORMER else {}),
            **({"call_ms": head["call_ms"]}
               if name in STAGED + SHARDED_STAGED else {}),
            **({"call_ms": head["call_ms"]} if name in BLIND else {}),
            cases=rows))
    print(json.dumps({"kernels": kernels, "card": card, **times,
                      "decrypt_max_abs_err": err,
                      "mult_vs_decrypted_inputs_err": mult_err,
                      "level1_decrypt_max_abs_err": err1,
                      "level1_mult_err": mult_err1,
                      "automorphism_2e52_err": {k: float(v)
                                                for k, v in hi.items()},
                      "automorphism_level0_err": raw,
                      "automorphism_level0_resid": resid,
                      f"evalsum{SUM_BATCH}_err": sum_err,
                      "binfhe": binfhe,
                      "sharded": {k: sharded[k] for k in (
                          "times", "same", "mult_err", "per_mult_limb2",
                          "seconds")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
