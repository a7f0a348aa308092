"""The command's contract: the result line's keys and order, no JAX in a
run's process, and no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from conftest import REPO, SEED

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line_keys(tiny_root):
    result, detail = harness.run_cell("tiny_export", SEED, 0.5, False, "cpu", tiny_root)
    assert list(result) == KEYS  # checks last
    assert set(result["metrics"]) == {"export_images_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"] == {"code_gap": {"value": result["checks"]["code_gap"]["value"],
                                             "limit": result["checks"]["code_gap"]["limit"]}}
    assert "setup" in detail
    json.dumps(result)


def test_traced_line_has_per_layer_metrics_and_breakdown(tiny_root):
    result, _ = harness.run_cell("tiny_export", SEED, 0.5, True, "cpu", tiny_root)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in result["metrics"]  # a traced run reports the per-layer metrics only


def test_metrics_for_each_cell():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(spec, w["name"], False)}
        layer = harness.metrics_for(spec, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in layer:
            assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()


def test_fresh_process_loads_no_jax(tiny_root):
    code = f"""
import runpy, sys
sys.path.insert(0, {str(REPO)!r})
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path({str(REPO / "benchmark/run.py")!r}, run_name="__main__")
except SystemExit:
    pass
from benchmark import harness
for cell in ("tiny_ar", "tiny_export", "tiny_vqgan"):
    harness.run_cell(cell, 3, 0.2, cell == "tiny_export", "cpu", {str(tiny_root)!r})
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                                   "vector_quantization_tpu")))
print("PORT", "vector_quantization_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
    assert "PORT True" in out.stdout
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "vector_quantization_tpu_torch_extra", sys)
    assert "jaxtyping_like" not in harness.forbidden_modules()
    assert "vector_quantization_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vector_quantization_tpu.ops", sys)
    assert "vector_quantization_tpu.ops" in harness.forbidden_modules()


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(REPO, "--workload", "vqgan_tencrop_export", "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "vqgan_tencrop_export", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
