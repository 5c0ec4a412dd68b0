"""Drive the PyTorch port's CKKS main path on one GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, printing no result, when there is no card or the port
is not beside it. Phases, none of which catches its own failure:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of `openfhe_tpu_torch/csrc` (nvcc, in parallel);
3. kernel phase: each kernel is compared word for word with its plain
   PyTorch version on the same card inputs, and both are timed with CUDA
   events (median of 20 after warm-up). The NTT and the conversion run at
   the main path's shapes; the five kernels of the fused key switch at
   level 0 (31 Q towers), level 1 (30) and on a chain of the largest
   31-bit primes (4 Q + 2 P towers, N=2^16);
4. main path at N=2^16, L=30 (31 Q + 16 P towers, 2 digits): context,
   KeyGen, EvalMultKeyGen, encode, Encrypt x2, EvalMult (the fused
   chain: one launch of each fused kernel, none of the others), the same
   product through EvalMultNoRelin + Relinearize (the unfused chain of the
   NTT and conversion kernels), Rescale, both products again at level 1,
   Rescale, Decrypt, decode, with the launch counters reset just before
   and read just after. The fused words must equal the unfused ones at
   both levels and the port's plain path run on the CPU; the decryptions
   must be within the limits below; every kernel must have been launched;
5. one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.

bound_ms is the least time the card could take for a call: the larger of
its bytes (each input read once, each output written once) at 3.35 TB/s
and its 32-bit integer operations at 67 T/s (the H100 SXM's published
non-tensor 32-bit rate; the card's tensor cores do no 32-bit integer
products). Operations count what the function needs: a conversion counts
only its nonzero weights.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
BUTTERFLY_OPS = 10     # Shoup multiply 5, add_mod 2, sub_mod 3
SHOUP_OPS = 5
ROWMOD_TERM_OPS = 7    # Shoup multiply 5 + add_mod 2
MULMOD_OPS = 10        # a 64-bit product reduced mod q
WORD = 4
SLICE1 = ("ntt_fwd", "ntt_inv", "mod_matmul_rowmod")
FUSED = ("tensor_intt", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
         "ntt_submul_final")
WHERE = {
    "ntt_fwd": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_inv": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "mod_matmul_rowmod": ("csrc/rowmod.cu",
                          "openfhe_tpu/ops/modmatmul.py:232"),
    "tensor_intt": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:366"),
    "conv_digits": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:513"),
    "ntt_keymul_acc": ("csrc/ks_fused.cu",
                       "openfhe_tpu/pke/keyswitch/ks_fused.py:690"),
    "intt_conv_p": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:618"),
    "ntt_submul_final": ("csrc/ks_fused.cu",
                         "openfhe_tpu/pke/keyswitch/ks_fused.py:802"),
}
# CKKS noise at 26-bit scales and N=2^16: a fresh encryption's slot error
# e has a std of about 2.5e-3 (max over the 32768 slots about 1.5e-2), and
# the product's error z*(e_a + e_b) grows with |z|; inputs |z| <= 1/4 keep
# it under TOL. The product of the two decrypted inputs carries the same
# fresh noise, so EvalMult + Rescale must land closer to it: what is left
# is mostly the rescale's rounding (tau0 + tau1*s, about 2e-4 per slot).
Z_MAX = 0.25
TOL = 1e-2
MULT_TOL = 4e-3
REPS = 20


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
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
    """fwd/inv kernel vs plain on one basis; returns two case dicts."""
    n, k = basis.ring_dim, basis.k
    x = rand_residues(gen, basis.moduli, n, lead)
    shape = list(x.shape)
    out = {}
    for name, kern, ref in (("ntt_fwd", ntt.ntt_fwd, ntt._ntt_fwd_ref),
                            ("ntt_inv", ntt.ntt_inv, ntt._ntt_inv_ref)):
        got = kern(x, basis)
        want = ref(x, basis)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{name} {label} {shape} differs from its "
                f"plain version (max abs err {err})")
        # x and out once each, twiddles and their companions once each
        nbytes = 4 * (2 * x.numel() + 2 * k * n)
        ops = x.numel() // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
        if name == "ntt_inv":
            ops += x.numel() * SHOUP_OPS
        b_ms, b_by = bound(nbytes, ops)
        out[name] = dict(shape=shape, moduli=label, max_abs_err=err,
                         ms=cuda_ms(lambda: kern(x, basis)),
                         plain_ms=cuda_ms(lambda: ref(x, basis)),
                         bound_ms=b_ms, bound_by=b_by)
    return out


def rowmod_case(mm, tab, d_basis, gen, label):
    a_dim, d_dim = tab.bhat_mod_d.shape
    n = d_basis.ring_dim
    y = rand_residues(gen, [2 ** 31 - 1] * a_dim, n)      # any words < 2^31
    args = (y, tab.bhat_mod_d, tab.bhat_mod_d_sh, d_basis.q)
    got = mm.mod_matmul_rowmod(*args)
    want = mm._mod_matmul_rowmod_ref(y, tab.bhat_mod_d, d_basis.q)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0, f"mod_matmul_rowmod {label} differs from its plain "
            f"version (max abs err {err})")
    nbytes = 4 * ((a_dim + d_dim) * n + 2 * a_dim * d_dim + d_dim)
    b_ms, b_by = bound(nbytes, n * a_dim * d_dim * ROWMOD_TERM_OPS)
    return dict(shape=[a_dim, d_dim, n], moduli=label, max_abs_err=err,
                ms=cuda_ms(lambda: mm.mod_matmul_rowmod(*args)),
                plain_ms=cuda_ms(lambda: mm._mod_matmul_rowmod_ref(
                    y, tab.bhat_mod_d, d_basis.q)),
                bound_ms=b_ms, bound_by=b_by)


def fused_work(tabs) -> dict:
    """(bytes, operations) of each fused kernel at one table set: each
    input and output once, twiddles and keys included; the conversions'
    operations count their nonzero weights only."""
    n, kql, kp, nd = (tabs.basis_qlp.ring_dim, tabs.kql, tabs.kp, tabs.nd)
    kqlp, log_n = kql + kp, n.bit_length() - 1
    digits = [min(tabs.alpha, kql - j * tabs.alpha) for j in range(nd)]
    ntt = lambda rows: rows * n // 2 * log_n * BUTTERFLY_OPS
    return {
        "tensor_intt": (WORD * n * 6 * kql,
                        kql * n * (MULMOD_OPS + SHOUP_OPS) + ntt(kql)),
        "conv_digits": (WORD * n * nd * (tabs.alpha + kqlp),
                        n * ROWMOD_TERM_OPS * sum(a * (kqlp - a)
                                                  for a in digits)),
        "ntt_keymul_acc": (WORD * n * (nd * kqlp + kql + 4 * nd * kqlp
                                       + 2 * kqlp + 2 * kqlp),
                           ntt(sum(kqlp - a for a in digits))
                           + 2 * nd * kqlp * n * ROWMOD_TERM_OPS),
        "intt_conv_p": (WORD * n * (2 * kp + 2 * kp + 2 * kql),
                        ntt(2 * kp) + 2 * kp * n * SHOUP_OPS
                        + 2 * kp * kql * n * ROWMOD_TERM_OPS),
        "ntt_submul_final": (WORD * n * 12 * kql,
                             ntt(2 * kql) + kql * n * (3 * MULMOD_OPS + 12)
                             + 2 * kql * n * (SHOUP_OPS + 5)),
    }


def fused_cases(ksf, tabs, key, gen, label) -> dict:
    """Each kernel of the fused key switch vs its plain twin on one table
    set, on random residues (and a random key with companions)."""
    n, kql, nd = tabs.basis_qlp.ring_dim, tabs.kql, tabs.nd
    mq, mqlp = tabs.basis_ql.moduli, tabs.basis_qlp.moduli
    a = [rand_residues(gen, mq, n) for _ in range(4)]
    y_pad = ksf._pad_digits(rand_residues(gen, mq, n), tabs)
    conv = rand_residues(gen, mqlp, n, (nd,))
    ext = rand_residues(gen, mqlp, n, (2,))
    convq = rand_residues(gen, mq, n, (2,))
    keys = (key.bv, key.bv_sh, key.av, key.av_sh)
    calls = {
        "tensor_intt": (ksf.tensor_intt, ksf._tensor_intt_ref,
                        (a[1], a[3])),
        "conv_digits": (ksf.conv_digits, ksf._conv_digits_ref, (y_pad,)),
        "ntt_keymul_acc": (ksf.ntt_keymul_acc, ksf._ntt_keymul_acc_ref,
                           (conv, a[0], *keys)),
        "intt_conv_p": (ksf.intt_conv_p, ksf._intt_conv_p_ref, (ext,)),
        "ntt_submul_final": (ksf.ntt_submul_final,
                             ksf._ntt_submul_final_ref, (convq, ext, *a)),
    }
    work = fused_work(tabs)
    out = {}
    for name, (kern, ref, args) in calls.items():
        got, want = kern(*args, tabs), ref(*args, tabs)
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            got, want = torch.stack(got), torch.stack(want)
        err = max_abs_err(got, want)
        require(err == 0, f"{name} {label} differs from its plain version "
                f"(max abs err {err})")
        b_ms, b_by = bound(*work[name])
        out[name] = dict(shape=[kql, tabs.kp, nd, n], moduli=label,
                         max_abs_err=err,
                         ms=cuda_ms(lambda: kern(*args, tabs)),
                         plain_ms=cuda_ms(lambda: ref(*args, tabs)),
                         bound_ms=b_ms, bound_by=b_by)
    return out


def same_words(x, y) -> bool:
    return len(x.elements) == len(y.elements) and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(x.elements, y.elements))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.ops import modmatmul, ntt
    from openfhe_tpu_torch.pke.keys import EvalKey
    from openfhe_tpu_torch.pke.keyswitch import hybrid
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    from openfhe_tpu_torch.pke.parameters import main_path_params

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # 2. build
    built = _build.build()
    print(f"build: {built.seconds:.1f} s for {len(built.libs)} libraries")
    for name, log in built.log.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  nvcc[{name}] {line.strip()}")

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
    # the last case runs only the shared-memory pass (N <= 8192), with a
    # batch axis in front of the towers
    for basis, label, lead in (
            (cc.basis_q, "Q (31 towers)", ()),
            (cc.basis_qp, "QP (47 towers)", ()),
            (make_basis(top31[:4], n, device="cuda"),
             "largest 31-bit primes", ()),
            (make_basis(cc.moduli_q[:3], 1 << 13, device="cuda"),
             "N=2^13, batch of 2", (2,))):
        for name, case in ntt_cases(ntt, basis, gen, label, lead).items():
            cases[name].append(case)
    for part in top.parts:
        cases["mod_matmul_rowmod"].append(rowmod_case(
            modmatmul, part.switch, part.compl_basis, gen,
            f"digit {part.start}:{part.end} -> complement"))
    cases["mod_matmul_rowmod"].append(rowmod_case(
        modmatmul, top.moddown.switch, top.basis_ql, gen, "P -> Q mod-down"))
    # the fused kernels: level 0, level 1 (digit 1 has 14 towers) and a
    # 31-bit chain, each with a random key over its own QP moduli
    qp = list(cc.moduli_q) + list(cc.moduli_p)
    key_main = hybrid.shoup_companions(EvalKey(
        bv=rand_residues(gen, qp, n, (2,)),
        av=rand_residues(gen, qp, n, (2,))), qp)
    basis31 = make_basis(top31, n, device="cuda")
    key31 = hybrid.shoup_companions(EvalKey(
        bv=rand_residues(gen, top31, n, (2,)),
        av=rand_residues(gen, top31, n, (2,))), top31)
    for tabs, key, label in (
            (top.fused, key_main, "level 0 (31 Q + 16 P)"),
            (cc.hybrid_tables(cc.size_ql(1)).fused, key_main,
             "level 1 (30 Q + 16 P)"),
            (ks_fused.make_fused_ks_tables(basis31, 4, 4, 2), key31,
             "largest 31-bit primes (4 Q + 2 P)")):
        for name, case in fused_cases(ks_fused, tabs, key, gen,
                                      label).items():
            cases[name].append(case)
    del key_main, key31
    for name, rows in cases.items():
        for c in rows:
            print(f"  {name:18s} {str(c['shape']):18s} {c['moduli']:28s} "
                  f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})  "
                  f"max_abs_err {c['max_abs_err']}")

    # 4. main path, counted
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    z = np.random.default_rng(0).uniform(-Z_MAX, Z_MAX, size=cc.slots)
    pt = cc.MakeCKKSPackedPlaintext(z)
    ct_a = cc.Encrypt(kp.public_key, pt)
    ct_b = cc.Encrypt(kp.public_key, pt)

    def counted(fn):
        """fn() and the launches it made, per kernel."""
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: _build.LAUNCHES[k] - before.get(k, 0) for k in cases}

    unfused = lambda x, y: cc.Relinearize(cc.EvalMultNoRelin(x, y))
    prod, per_mult = counted(lambda: cc.EvalMult(ct_a, ct_b))
    prod_u, per_unfused = counted(lambda: unfused(ct_a, ct_b))
    resc = cc.Rescale(prod)
    prod1, per_mult1 = counted(lambda: cc.EvalMult(resc, resc))
    prod1_u = unfused(resc, resc)
    resc1 = cc.Rescale(prod1)
    dec = cc.Decrypt(kp.secret_key, resc)
    dec1 = np.asarray(cc.Decrypt(kp.secret_key, resc1).values).real
    dec_a = np.asarray(cc.Decrypt(kp.secret_key, ct_a).values).real
    dec_b = np.asarray(cc.Decrypt(kp.secret_key, ct_b).values).real
    launches = {k: _build.LAUNCHES[k] for k in cases}
    path_s = time.perf_counter() - t0
    vals = np.asarray(dec.values)
    require(vals.shape == (cc.slots,) and bool(np.isfinite(vals).all())
            and bool(np.isfinite(dec1).all()),
            "decrypted values are not finite or of the wrong shape")
    err = float(np.abs(vals.real - z * z).max())
    fresh_err = float(np.abs(dec_a - z).max())
    mult_err = float(np.abs(vals.real - dec_a * dec_b).max())
    err1 = float(np.abs(dec1 - z ** 4).max())
    mult_err1 = float(np.abs(dec1 - vals.real ** 2).max())
    print(f"main path: {path_s:.2f} s; launches {launches}")
    print(f"per EvalMult (fused) {per_mult}; level 1 {per_mult1}; per "
          f"EvalMultNoRelin + Relinearize (unfused) {per_unfused}")
    print(f"z ~ U(-{Z_MAX}, {Z_MAX}): max |dec(ct) - z| = {fresh_err:.3e}, "
          f"max |dec - dec(a)*dec(b)| = {mult_err:.3e} (limit {MULT_TOL}), "
          f"max |dec - z*z| = {err:.3e} (limit {TOL}); level 1: "
          f"max |dec1 - dec^2| = {mult_err1:.3e} (limit {MULT_TOL}), "
          f"max |dec1 - z^4| = {err1:.3e} (limit {TOL})")
    same0, same1 = same_words(prod, prod_u), same_words(prod1, prod1_u)
    print(f"fused EvalMult == unfused chain on the card: level 0 {same0}, "
          f"level 1 {same1}")
    require(same0 and same1, "the fused EvalMult differs from the unfused "
            "chain on the card")
    require(mult_err <= MULT_TOL and mult_err1 <= MULT_TOL,
            f"EvalMult+Rescale error {mult_err} / {mult_err1} above "
            f"{MULT_TOL}")
    require(err <= TOL and err1 <= TOL,
            f"decryption error {err} / {err1} above {TOL}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    want = {k: int(k in FUSED) for k in cases}
    require(per_mult == want and per_mult1 == want,
            f"EvalMult launches {per_mult} / {per_mult1}, expected {want}")
    require(per_unfused == {k: 4 * (k in SLICE1) for k in cases},
            f"unfused launches {per_unfused}, expected 4 of each slice-1 "
            "kernel")
    mult_ms = cuda_ms(lambda: cc.EvalMult(ct_a, ct_b), reps=10)
    unfused_ms = cuda_ms(lambda: unfused(ct_a, ct_b), reps=10)
    resc_ms = cuda_ms(lambda: cc.Rescale(prod), reps=10)
    print(f"EvalMult fused {mult_ms:.3f} ms, unfused (EvalMultNoRelin + "
          f"Relinearize) {unfused_ms:.3f} ms, Rescale {resc_ms:.3f} ms "
          f"(median of 10, CUDA events, {card})")

    # the same EvalMult on the port's plain path on the CPU
    t0 = time.perf_counter()
    cpu = fhe.GenCryptoContext(dataclasses.replace(params), seed=7,
                               device="cpu")
    ek = cc.eval_mult_keys[kp.secret_key.key_tag]
    cpu.eval_mult_keys[ek.key_tag] = EvalKey(bv=ek.bv.cpu(), av=ek.av.cpu(),
                                             key_tag=ek.key_tag)
    on_cpu = lambda ct: dataclasses.replace(
        ct, elements=tuple(e.cpu() for e in ct.elements))
    ref = cpu.EvalMult(on_cpu(ct_a), on_cpu(ct_b))
    cpu_s = time.perf_counter() - t0
    same = same_words(prod, ref)
    print(f"EvalMult on the card == plain path on the CPU: {same} "
          f"({cpu_s:.1f} s on the CPU)")
    require(same, "EvalMult words on the card differ from the plain path")

    # 5. the kernels line, then the device line
    kernels = []
    for name, rows in cases.items():
        head = rows[0]        # level 0 / Q (31 towers) / digit 0
        kernels.append(dict(
            name=name, route="cuda",
            source="openfhe_tpu_torch/" + WHERE[name][0],
            replaces=WHERE[name][1], launches=launches[name],
            launches_per_evalmult=per_mult[name],
            launches_per_unfused_mult=per_unfused[name],
            max_abs_err=max(c["max_abs_err"] for c in rows),
            bit_exact=all(c["max_abs_err"] == 0 for c in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, shape=head["shape"], cases=rows))
    print(json.dumps({"kernels": kernels, "card": card,
                      "evalmult_ms": mult_ms,
                      "evalmult_unfused_ms": unfused_ms,
                      "rescale_ms": resc_ms,
                      "decrypt_max_abs_err": err,
                      "mult_vs_decrypted_inputs_err": mult_err,
                      "level1_decrypt_max_abs_err": err1,
                      "level1_mult_err": mult_err1}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
