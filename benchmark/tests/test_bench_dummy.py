"""A later cell, traffic mix, configuration and per-layer metric come as
new files and new entries of BENCHMARK.json; no file of the benchmark is
edited, and the harness finds them by name."""

import hashlib
import json

from benchmark import harness
from conftest import SEED


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_dummy_cell_and_metric_are_new_files(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    b = root / "benchmark"
    (b / "configs/dummy_cfg.json").write_text((b / "configs/tiny_gpt2.json").read_text())
    (b / "traffic/dummy_mix.json").write_text(json.dumps(
        {"batch": 2, "image_size": 32, "classes": 10, "items_per_second": 20, "extra_items": 3}))
    w = json.loads((b / "workloads/tiny_ar.json").read_text())
    w.update(config="dummy_cfg", traffic="dummy_mix")
    (b / "workloads/dummy_cell.json").write_text(json.dumps(w))
    (b / "metrics/dummy_images_a_step.py").write_text(
        '"""Images a step, from the counters."""\n\n\ndef read(run):\n'
        '    return run.counters["images"] / run.counters["steps"]\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy_cfg.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("dummy_cell")
    spec["per_layer"].append({"name": "dummy_images_a_step", "unit": "images", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "train_tokens_per_s",
                              "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, _ = harness.run_cell("dummy_cell", SEED, 0.3, False, "cpu", root)
    assert result["correct"] and set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    traced, _ = harness.run_cell("dummy_cell", SEED, 0.3, True, "cpu", root)
    assert traced["metrics"]["dummy_images_a_step"]["value"] == 2.0
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
