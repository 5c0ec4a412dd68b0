"""The harness's contract: BENCHMARK.json's names, files and readers, the
import check, and the refusal to run without a card."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import run
from harness import guard

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_files_and_readers():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert e2e == {"gates_per_s", "p95_ms.binfhe", "setup_s"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith(
            "benchmark/")
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and callable(run.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    # readers kept for the CKKS cells that a later change adds back
    for name in ("ckks_requests_per_s", "p95_ms.ckks", "issue_ms.ckks",
                 "roofline_pct.ckks"):
        assert callable(run.reader(name))
    for name in ("ckks_n16_d30", "binfhe_std128"):
        assert (HERE / "configs" / f"{name}.json").exists()
    for cell in cells:
        got = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert run.cell_metrics(BENCH, cell, True)


def test_the_forbidden_names_are_whole_top_level_names():
    names = ["openfhe_tpu_torch", "openfhe_tpu_torch.ops", "jaxtyping",
             "openfhe_tpu.ops", "jax", "flax.linen", "jaxlib"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jaxlib", "openfhe_tpu.ops"]


def _imports(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_nothing_the_harness_loads_imports_jax():
    code = ("import sys; sys.path.insert(0, '..'); import run, control; "
            "import harness.systems.ckks, harness.systems.binfhe; "
            "from harness import guard; "
            "[run.reader(m) for m in ('p95_ms.ckks', 'roofline_pct.ckks')]; "
            "print(' '.join(guard.forbidden_modules()) or 'none')")
    assert _imports(code) == ["none"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import reference.ckks, reference.binfhe; "
            "print(' '.join(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('openfhe_tpu_torch', 'openfhe_tpu', "
            "'jax', 'harness'))) or 'none')")
    assert _imports(code) == ["none"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "5", "--seconds", "2", "--trace",
                          "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


def test_kernel_names_from_the_trace():
    from harness import trace
    own = trace.own_kernel_names(ROOT / "openfhe_tpu_torch" / "csrc")
    assert {"keymul_cluster", "pconv", "blind_rotate_kernel",
            "ntt_small_group"} <= own
    names = {
        "void (anonymous namespace)::keymul_cluster<16>(unsigned int "
        "const*, unsigned int*, int)": "keymul_cluster",
        "void (anonymous namespace)::blind_rotate_kernel<0>((anonymous "
        "namespace)::Args)": "blind_rotate_kernel",
        "void at::native::vectorized_elementwise_kernel<2, at::native::"
        "CUDAFunctor_add<long> >(int)": "vectorized_elementwise_kernel",
        "Memset (Device)": "Memset",
        "fwd_cluster": "fwd_cluster"}
    for name, base in names.items():
        assert trace.kernel_base(name) == base
    dev = [("void (anonymous namespace)::pconv<16, 4>(int)", 0, 4000),
           ("void at::native::reduce_kernel<128, 4>(int)", 3000, 5000),
           ("Memset (Device)", 9000, 10000)]
    host = [("issue", 4500, 9500)]
    got = trace.summarize(dev, host, own, 1e-5)
    assert abs(got["busy_s"] - 6e-6) < 1e-12
    assert abs(got["own_s"] - 4e-6) < 1e-12
    assert abs(got["plain_s"] - 3e-6) < 1e-12
    [(span, gap)] = got["idle_gaps"]
    assert span == "issue" and abs(gap - 4e-6) < 1e-12
