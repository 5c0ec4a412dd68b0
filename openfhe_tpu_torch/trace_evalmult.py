"""Where an op's time goes on the card: a torch.profiler trace.

    python3 -m openfhe_tpu_torch.trace_evalmult --op relinearize

Builds the main path's context (N=2^16, 31 Q + 16 P towers, 2 digits),
warms up, then traces 5 calls of one op at level 0: `--op evalmult` (the
default; the fused mult chain of `pke/keyswitch/ks_fused.py`),
`relinearize` (of an EvalMultNoRelin product) or `rotate` (EvalRotate by
1), both through the general fused chain, `keyswitch_core_fused`;
`rescale` (ModReduce of a fresh EvalMult product: per element one inverse
NTT of the dropped tower and one forward NTT of the other 30, plain int64
torch around them, `lattice/rns_tools.drop_last_and_scale`),
`fastrotation` (EvalFastRotationPrecompute of a fresh ciphertext and one
EvalFastRotation by 1 on its digits: the hoisted rotation of
`pke/keyswitch/hybrid.py`, its conversions kernel k, its NTTs kernels a
and b, its key product and mod-down's arithmetic plain int64 torch),
`encrypt` (public-key Encrypt of an encoded plaintext) or `decrypt`
(Decrypt with the CKKS decode on the host). Several ops, comma-separated, share one
context and are traced one after another. `--op logistic` builds the
same chain under FLEXIBLEAUTO and traces EvalLogistic over [-1, 1] at
degree 32 (`examples/function_evaluation.py`'s call) of a fresh
ciphertext at level 0, `logistic119` EvalLogistic over [-8, 8] at degree
119; both also print the host's time in the encodes of constant vectors
(MakeCKKSPackedPlaintext: the FFT and CRT on the host, the upload and one
`ntt_fwd`) per call and its share of the wall. `--op
ginx` instead builds a BinFHE STD128 GINX context and traces 2 calls of
EvalBinGate(AND) over a batch of 256 gates (a = i % 2, b = (i // 2) % 2),
whose blind rotation is one launch of `csrc/blind_rotate.cu` between
kernel m's transforms of the test vector and the extraction
(`csrc/ntt_small.cu`); `--op lmkcdey` does the same on a STD128_LMKCDEY
context over a batch of 64 gates and also times the host's per-gate
schedule (`binfhe/blind_rotate.lmkcdey_sched`); `--op std192` does the
same as `ginx` on a STD192 context (the composite-Q ring of
`binfhe/rgsw_wide.py`: Q = q1 q2 of 38 bits, n = 821, N = 2048), whose
blind rotation is one launch of `blind_rotate_cggi_wide`. `--op sharded`
traces the limb-sharded EvalMult of `parallel/sharded_fused.py` at level 3
(28 Q towers) over a limb axis of 4 on the visible cards (all four shards
on one card when there is one), inputs sharded beforehand. `--op
bgvmult` builds BGV at the JAX repo's BGV benchmark (`bench.py`
`bench_bfvbgv`: N=2^15, depth 10, FLEXIBLEAUTO, t = 65537) and traces
EvalMult of two fresh ciphertexts (the fused mult chain with t in its
tables), `bgvmodreduce` ModReduce of their product (two towers: per
tower one inverse NTT of the dropped tower and one forward NTT of the
others, plain int64 torch around them), `bfvmult` EvalMult on BFV at
`bench_bfvbgv`'s N=2^14, depth 2 (the tensor product: NTTs and
conversions, plain int64 torch around them, then Relinearize on the
fused chain); the integer ops share their scheme's context. `--op
bootstrap` builds CKKS at the JAX repo's bootstrap benchmark (`bench.py`
`bench_boot16`: N=2^16, depth 24, COMPOSITESCALINGAUTO, 2^11 slots,
level budget (3, 3), seed 7) and traces one warm EvalBootstrap of a
ciphertext two levels from the end (after one warm-up that encodes and
caches the transforms' diagonals), with the host's encodes. Prints the
device time of every kernel name (summed over the calls, divided by
their number) with its launches per call, the share taken by the port's
own kernels (`csrc/`) against the plain torch ops around them (the
plain-torch time and share of the busy time), and the device's busy
share of the wall time measured with CUDA events, and the idle gaps
between the traced device kernels (their sum, count and the largest).
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
import time

import numpy as np
import torch

CALLS = {"evalmult": 5, "relinearize": 5, "rotate": 5, "rescale": 5,
         "fastrotation": 5, "encrypt": 5, "decrypt": 5, "ginx": 2,
         "lmkcdey": 2, "std192": 2, "sharded": 5, "logistic": 2,
         "logistic119": 2, "bgvmult": 5, "bgvmodreduce": 5, "bfvmult": 5,
         "bootstrap": 1}
# warm-up calls before the timed ones (3 unless named)
WARMUPS = {"bootstrap": 1}
# idle gaps listed, the largest first
TOP_GAPS = 5
# --op logistic / logistic119: (a, b, degree) of EvalLogistic
LOGISTIC = {"logistic": (-1.0, 1.0, 32), "logistic119": (-8.0, 8.0, 119)}
SHARDED_LEVEL = 3
SHARDED_LIMB = 4
GATE_BATCH = 256
LMK_BATCH = 64
# kernel function names of csrc/ (ntt_core.cuh, ntt_cluster.cuh,
# rowmod_core.cuh, pconv_core.cuh, keymul_core.cuh, ks_fused.cu,
# ntt_small.cu, modmatmul.cu, blind_rotate.cu)
OWN = ("fwd_stage", "fwd_tile", "inv_stage", "inv_tile", "fwd_cluster",
       "inv_cluster", "rowmod",
       "tensor_intt_tile", "keymul_tile", "subscale_tile", "submul_tile",
       "keymul_cluster", "pconv", "submul_cluster", "tensor_intt_cluster",
       "subscale_cluster",
       "ntt_small_group", "mod_matmul_kernel", "mod_matmul_tc",
       "blind_rotate_kernel", "blind_rotate_wide_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="evalmult",
                    help="one of " + ", ".join(CALLS) + ", or several "
                    "CKKS ops separated by commas")
    args = ap.parse_args(argv)
    ops = args.op.split(",")
    if any(op not in CALLS for op in ops):
        ap.error(f"--op {args.op}: not among {', '.join(CALLS)}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from openfhe_tpu_torch import _build

    _build.build()
    worst = 0
    for name in ops:
        op = {"ginx": lambda: _ginx_op("STD128"),
              "std192": lambda: _ginx_op("STD192"), "lmkcdey": _lmkcdey_op,
              "sharded": _sharded_op,
              "logistic": lambda: _logistic_op(name),
              "logistic119": lambda: _logistic_op(name),
              "bgvmult": lambda: _integer_op(name),
              "bgvmodreduce": lambda: _integer_op(name),
              "bfvmult": lambda: _integer_op(name),
              "bootstrap": _bootstrap_op}.get(
                  name, lambda: _ckks_op(name))()
        worst = max(worst, _trace(name, op, CALLS[name]))
    return worst


def _trace(name: str, op, calls: int) -> int:
    """Time `calls` calls of op with CUDA events, then trace as many and
    print the breakdown; 1 if the profiler saw no device time."""
    for _ in range(WARMUPS.get(name, 3)):
        op()
    torch.cuda.synchronize()

    encodes = getattr(op, "encodes", None)
    if encodes is not None:
        encodes.update(s=0.0, n=0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        op()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    host = {}
    if encodes is not None:
        host = {"encodes_per_call": encodes["n"] // calls,
                "encode_ms": encodes["s"] * 1e3 / calls,
                "host_encode_share": encodes["s"] * 1e3 / calls / wall_ms}

    prof = profile_device(op, calls)
    per_name, launches = prof["per_name"], prof["launches"]
    busy_ms = prof["busy_ms"]
    own = [n for n in per_name
           if any(f"{o}(" in n or f"{o}<" in n for o in OWN)]
    own_ms = sum(per_name[n] for n in own)
    # names cut to 60 characters; kernels sharing a cut name add up
    by_kernel = collections.Counter()
    for kname, n in launches.items():
        by_kernel[kname[:60]] += n
    print(f"{name} wall {wall_ms:.3f} ms (CUDA events, mean of {calls})")
    if host:
        print(f"  host encodes: {host['encodes_per_call']} a call, "
              f"{host['encode_ms']:.3f} ms ({host['host_encode_share']:.1%}"
              " of the wall)")
    if not per_name:
        print("the profiler recorded no device time: busy share not measured")
        return 1
    for kname, t in per_name.most_common(20):
        print(f"  {t:8.4f} ms  {launches[kname] // calls:4d} launches  "
              f"{kname[:90]}")
    print(f"  idle gaps between device kernels: {prof['idle_ms']:.3f} ms a "
          f"call in {prof['gaps']} gaps; largest "
          f"{[round(g, 3) for g in prof['largest_gaps_ms']]} ms")
    print(json.dumps({
        "op": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "own_kernels_ms": own_ms,
        "own_kernel_launches": sum(launches[n] for n in own) // calls,
        "plain_torch_ms": busy_ms - own_ms,
        "plain_torch_share": (busy_ms - own_ms) / busy_ms,
        "kernel_launches": sum(launches.values()) // calls,
        "launches_by_kernel": {k: v // calls
                               for k, v in by_kernel.most_common()},
        "idle_gaps_ms_per_call": prof["idle_ms"], "idle_gaps": prof["gaps"],
        "largest_idle_gaps_ms": prof["largest_gaps_ms"],
        **host, "device": torch.cuda.get_device_name(0)}))
    return 0


def profile_device(fn, calls: int = 1) -> dict:
    """Trace `calls` calls of fn with torch.profiler: per device kernel
    name its ms and launches a call (`per_name`, `launches` counts all
    calls), the busy ms a call, and the idle gaps between the device
    kernels (the card waiting on the host): their ms a call, number and
    the TOP_GAPS largest. The profiler's first step runs the calls once
    more, unrecorded, so that the tracing runs before the recorded step
    begins (a session that records from its first call can miss the
    kernels launched first)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=steps) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    per_name = collections.Counter()
    launches = collections.Counter()
    spans = []
    for ev in prof.events():
        # the step's own range on the device timeline is no kernel
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("ProfilerStep")):
            per_name[ev.name] += ev.time_range.elapsed_us() / 1e3 / calls
            launches[ev.name] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    gaps, last = [], None
    for start, end in sorted(spans):
        if last is not None and start > last:
            gaps.append((start - last) / 1e3)
        last = end if last is None else max(last, end)
    gaps.sort(reverse=True)
    return dict(per_name=per_name, launches=launches,
                busy_ms=sum(per_name.values()),
                idle_ms=sum(gaps) / calls, gaps=len(gaps),
                largest_gaps_ms=gaps[:TOP_GAPS])


def _ginx_op(param_set: str):
    """EvalBinGate(AND) over a batch of 256 on a GINX context of
    `param_set` (STD128, or STD192 on the composite-Q ring)."""
    from openfhe_tpu_torch.binfhe.constants import BINGATE
    from openfhe_tpu_torch.binfhe.context import BinFHEContext

    cc = BinFHEContext(seed=11).GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    i = np.arange(GATE_BATCH)
    a, b = cc.Encrypt(sk, i % 2), cc.Encrypt(sk, (i // 2) % 2)
    return lambda: cc.EvalBinGate(BINGATE.AND, a, b)


def _lmkcdey_op():
    """EvalBinGate(AND) over a batch of 64 on a STD128_LMKCDEY context;
    prints the host time of the gates' schedules first."""
    from openfhe_tpu_torch.binfhe import blind_rotate, lwe
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE
    from openfhe_tpu_torch.binfhe.context import BinFHEContext

    cc = BinFHEContext(seed=12).GenerateBinFHEContext(
        "STD128_LMKCDEY", BINFHE_METHOD.LMKCDEY)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    i = np.arange(LMK_BATCH)
    a, b = cc.Encrypt(sk, i % 2), cc.Encrypt(sk, (i // 2) % 2)
    # the gate's blind rotation runs on the a vectors of a + b
    a_lwe = lwe.eval_add(a, b).a
    t0 = time.perf_counter()
    for _ in range(5):
        sched = blind_rotate.lmkcdey_sched(cc.rgsw, a_lwe, cc.num_auto_keys)
    torch.cuda.synchronize()
    print(f"lmkcdey host schedule: {(time.perf_counter() - t0) / 5 * 1e3:.3f}"
          f" ms per batch of {LMK_BATCH} ({sched.shape[0]} steps)")
    return lambda: cc.EvalBinGate(BINGATE.AND, a, b)


def _sharded_op():
    """One limb-sharded EvalMult at level 3 of the main path's context."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import parallel as par
    from openfhe_tpu_torch.parallel import sharded_fused as sf
    from openfhe_tpu_torch.pke.parameters import main_path_params

    cc = fhe.GenCryptoContext(main_path_params(), seed=7)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    z = np.random.default_rng(0).uniform(-0.5, 0.5, size=cc.slots)
    ct = cc.LevelReduce(cc.Encrypt(kp.public_key,
                                   cc.MakeCKKSPackedPlaintext(z)),
                        SHARDED_LEVEL)
    mesh = par.make_mesh(SHARDED_LIMB)
    print(f"mesh: {mesh}")
    st = sf.make_sharded_fused_tables(cc, cc.size_ql(SHARDED_LEVEL))
    parts = par.shard_ciphertext(ct, mesh).elements
    return lambda: sf.mult_relin_sharded(*parts, *parts, st, mesh)


@functools.lru_cache(maxsize=None)
def _ckks_context():
    """The main path's context, keys and two fresh encryptions."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke.parameters import main_path_params

    cc = fhe.GenCryptoContext(main_path_params(), seed=7)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    z = np.random.default_rng(0).uniform(-0.5, 0.5, size=cc.slots)
    pt = cc.MakeCKKSPackedPlaintext(z)
    a, b = cc.Encrypt(kp.public_key, pt), cc.Encrypt(kp.public_key, pt)
    return cc, kp, pt, a, b


def _logistic_op(name: str):
    """EvalLogistic of a fresh level-0 ciphertext on the main path's
    chain under FLEXIBLEAUTO; the op carries the encodes' host time."""
    import dataclasses

    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke.parameters import main_path_params

    params = dataclasses.replace(
        main_path_params(),
        scaling_technique=fhe.ScalingTechnique.FLEXIBLEAUTO)
    cc = fhe.GenCryptoContext(params, seed=17)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    a, b, degree = LOGISTIC[name]
    x = np.random.default_rng(0).uniform(a, b, size=cc.slots)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x))
    encodes = time_encodes(cc)

    def op():
        return cc.EvalLogistic(ct, a, b, degree)

    op.encodes = encodes
    return op


def time_encodes(cc) -> dict:
    """Make cc's MakeCKKSPackedPlaintext add the host seconds of each call
    to the returned dict's "s" and one to its "n"."""
    encodes = {"s": 0.0, "n": 0}
    encode = cc.MakeCKKSPackedPlaintext

    def timed_encode(*args, **kw):
        t = time.perf_counter()
        out = encode(*args, **kw)
        encodes["s"] += time.perf_counter() - t
        encodes["n"] += 1
        return out

    cc.MakeCKKSPackedPlaintext = timed_encode
    return encodes


def _bootstrap_op():
    """EvalBootstrap at `bench_boot16`'s configuration; the op carries the
    encodes' host time."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke import parameters as prm

    cc = fhe.GenCryptoContext(prm.boot_bench_params(), seed=7)
    slots = 1 << 11
    cc.EvalBootstrapSetup(level_budget=(3, 3), slots=slots)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalBootstrapKeyGen(kp.secret_key, slots)
    z = np.random.default_rng(0).uniform(-0.5, 0.5, size=slots)
    ct = cc.LevelReduce(cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        z, slots=slots)), cc.params.mult_depth - 2)
    encodes = time_encodes(cc)

    def op():
        return cc.EvalBootstrap(ct)

    op.encodes = encodes
    return op


@functools.lru_cache(maxsize=None)
def _integer_context(scheme: str):
    """BGV or BFV at `bench_bfvbgv`'s widths, its keys and two fresh
    encryptions of arange(64) % 17 (the benchmark's values)."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke import parameters as prm

    params = (prm.bgv_bench_params() if scheme == "bgv"
              else prm.bfv_bench_params())
    cc = fhe.GenCryptoContext(params, seed=7)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    pt = cc.MakePackedPlaintext(np.arange(64) % 17)
    return cc, cc.Encrypt(kp.public_key, pt), cc.Encrypt(kp.public_key, pt)


def _integer_op(name: str):
    cc, a, b = _integer_context(name[:3])
    if name == "bgvmodreduce":
        prod = cc.EvalMult(a, b)
        return lambda: cc.ModReduce(prod)
    return lambda: cc.EvalMult(a, b)


def _ckks_op(name: str):
    """One CKKS op at level 0 of the main path's context."""
    cc, kp, pt, a, b = _ckks_context()
    if name == "evalmult":
        return lambda: cc.EvalMult(a, b)
    if name == "relinearize":
        prod3 = cc.EvalMultNoRelin(a, b)
        return lambda: cc.Relinearize(prod3)
    if name == "rescale":
        prod = cc.EvalMult(a, b)
        return lambda: cc.ModReduce(prod)
    if name == "encrypt":
        return lambda: cc.Encrypt(kp.public_key, pt)
    if name == "decrypt":
        return lambda: cc.Decrypt(kp.secret_key, a)
    cc.EvalRotateKeyGen(kp.secret_key, [1])
    if name == "fastrotation":
        return lambda: cc.EvalFastRotation(
            a, 1, 0, cc.EvalFastRotationPrecompute(a))
    return lambda: cc.EvalRotate(a, 1)


if __name__ == "__main__":
    sys.exit(main())
