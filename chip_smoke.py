"""Drive the PyTorch port's CKKS main path on one GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, printing no result, when there is no card or the port
is not beside it. Phases, none of which catches its own failure:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of `openfhe_tpu_torch/csrc` (nvcc, in parallel);
3. kernel phase: at the main path's shapes each kernel is compared word
   for word with its plain PyTorch version on the same card inputs, and
   both are timed with CUDA events (median of 20 after warm-up);
4. main path at N=2^16, L=30 (31 Q + 16 P towers, 2 digits): context,
   KeyGen, EvalMultKeyGen, encode, Encrypt x2, EvalMult, Rescale,
   Decrypt, decode, with the launch counters reset just before and read
   just after; the decryption must be within 1e-2 of z*z, every kernel
   must have been launched, and the EvalMult words must equal the port's
   plain path run on the CPU from the same inputs and key;
5. one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.

bound_ms is the least time the card could take for a call: the larger of
its bytes (each input read once, each output written once) at 3.35 TB/s
and its 32-bit integer operations at 67 T/s (the H100 SXM's published
non-tensor 32-bit rate; the card's tensor cores do no 32-bit integer
products).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.math.modops import to_u32
    from openfhe_tpu_torch.ops import modmatmul, ntt
    from openfhe_tpu_torch.pke.keys import EvalKey
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

    # 3. kernel phase: kernel vs plain version at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = cc.ring_dim
    top31 = []
    q = 1 << 31
    while len(top31) < 4:
        q = nbtheory.previous_prime(q, 2 * n)
        top31.append(q)
    cases = {"ntt_fwd": [], "ntt_inv": [], "mod_matmul_rowmod": []}
    # the last case runs only the shared-memory pass (N <= 8192), with a
    # batch axis in front of the towers
    for basis, label, lead in (
            (cc.basis_q, "Q (31 towers)", ()),
            (cc.basis_qp, "QP (47 towers)", ()),
            (make_basis(top31, n, device="cuda"), "largest 31-bit primes",
             ()),
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
    before = dict(_build.LAUNCHES)
    prod = cc.EvalMult(ct_a, ct_b)
    torch.cuda.synchronize()
    per_mult = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in cases}
    resc = cc.Rescale(prod)
    dec = cc.Decrypt(kp.secret_key, resc)
    dec_a = np.asarray(cc.Decrypt(kp.secret_key, ct_a).values).real
    dec_b = np.asarray(cc.Decrypt(kp.secret_key, ct_b).values).real
    launches = {k: _build.LAUNCHES[k] for k in cases}
    path_s = time.perf_counter() - t0
    vals = np.asarray(dec.values)
    require(vals.shape == (cc.slots,) and bool(np.isfinite(vals).all()),
            "decrypted values are not finite or of the wrong shape")
    err = float(np.abs(vals.real - z * z).max())
    fresh_err = float(np.abs(dec_a - z).max())
    mult_err = float(np.abs(vals.real - dec_a * dec_b).max())
    print(f"main path: {path_s:.2f} s; launches {launches}; "
          f"per EvalMult {per_mult}")
    print(f"z ~ U(-{Z_MAX}, {Z_MAX}): max |dec(ct) - z| = {fresh_err:.3e}, "
          f"max |dec - dec(a)*dec(b)| = {mult_err:.3e} (limit {MULT_TOL}), "
          f"max |dec - z*z| = {err:.3e} (limit {TOL})")
    require(mult_err <= MULT_TOL,
            f"EvalMult+Rescale error {mult_err} above {MULT_TOL}")
    require(err <= TOL, f"decryption error {err} above {TOL}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    require(per_mult == {k: 4 for k in cases},
            f"EvalMult launches {per_mult}, expected 4 of each")
    mult_ms = cuda_ms(lambda: cc.EvalMult(ct_a, ct_b), reps=10)
    resc_ms = cuda_ms(lambda: cc.Rescale(prod), reps=10)
    print(f"EvalMult {mult_ms:.3f} ms, Rescale {resc_ms:.3f} ms "
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
    same = all(np.array_equal(to_u32(g), to_u32(w))
               for g, w in zip(prod.elements, ref.elements))
    print(f"EvalMult on the card == plain path on the CPU: {same} "
          f"({cpu_s:.1f} s on the CPU)")
    require(same, "EvalMult words on the card differ from the plain path")

    # 5. the kernels line, then the device line
    where = {
        "ntt_fwd": ("openfhe_tpu_torch/csrc/ntt.cu",
                    "openfhe_tpu/ops/ntt_fused.py:205"),
        "ntt_inv": ("openfhe_tpu_torch/csrc/ntt.cu",
                    "openfhe_tpu/ops/ntt_fused.py:205"),
        "mod_matmul_rowmod": ("openfhe_tpu_torch/csrc/rowmod.cu",
                              "openfhe_tpu/ops/modmatmul.py:232"),
    }
    kernels = []
    for name, rows in cases.items():
        head = rows[0]        # Q (31 towers) / the first digit's conversion
        kernels.append(dict(
            name=name, route="cuda", source=where[name][0],
            replaces=where[name][1], launches=launches[name],
            launches_per_evalmult=per_mult[name],
            max_abs_err=max(c["max_abs_err"] for c in rows),
            bit_exact=all(c["max_abs_err"] == 0 for c in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, shape=head["shape"], cases=rows))
    print(json.dumps({"kernels": kernels, "card": card,
                      "evalmult_ms": mult_ms, "rescale_ms": resc_ms,
                      "decrypt_max_abs_err": err,
                      "mult_vs_decrypted_inputs_err": mult_err}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
