"""``AccuracyMetric`` and the AR ``Validator`` through the port against the
JAX package, on the CPU.

- The same memos give exactly the same ``AccuracyMetric`` summary in both
  packages.
- ``configs/regression/ar_anchor.py``'s ``Validator`` (its two metrics,
  ``LossMetric`` on ``loss`` and ``AccuracyMetric``), from the JAX
  runner's ``init_state`` weights bridged into the port: the eval loss
  within 1e-5 relative of JAX's (4.317490577697754); the accuracy within
  0.05 of JAX's, as ``tests/test_torch_ar_train.py`` holds ``iter_800``'s:
  the accuracy samples, and the port draws from its own generator.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vector_quantization_tpu.algorithms.ar  # noqa: F401  (registers the JAX algorithm)
import vector_quantization_tpu.models  # noqa: F401
import vector_quantization_tpu.tasks  # noqa: F401
import vector_quantization_tpu.training.metrics as jax_metrics
from vector_quantization_tpu.training.runner import build_runner as jax_build_runner
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.registries import MetricRegistry
from vector_quantization_tpu_torch.training.runner import build_runner
from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax
from vector_quantization_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
AR = str(REPO / "configs/regression/ar_anchor.py")
JAX_LOSS = 4.317490577697754


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("key", ["accuracy", "top1"])
def test_accuracy_metric_matches_jax_exactly(key):
    values = np.random.default_rng(0).uniform(0, 1, 7).astype(np.float32)
    metric = MetricRegistry.build(dict(type="AccuracyMetric", key=key))
    jmetric = jax_metrics.AccuracyMetric(key=key)
    for v in values:
        metric.update({key: torch.tensor(v)})
        jmetric.update({key: np.asarray(v)})
    assert metric.summary("acc") == jmetric.summary("acc")
    assert type(MetricRegistry.build(dict(type="AccuracyMetric"))).__name__ == "AccuracyMetric"


def test_ar_anchor_validator_matches_jax(tmp_path):
    jv = jax_build_runner(jax_load_config(AR), "validator")
    jv.work_dir = str(tmp_path / "jax")
    jstate = jv.init_state()
    want = jv.run(jstate)
    assert set(want) == {"loss", "accuracy"} and abs(want["loss"] - JAX_LOSS) <= 1e-5 * JAX_LOSS
    validator = build_runner(load_config(AR), "validator", device="cpu", work_dir=str(tmp_path / "port"))
    state = validator.init_state()
    load_ar_from_flax(validator.algorithm, jax.tree_util.tree_map(np.asarray, dict(jstate.params)),
                      jax.tree_util.tree_map(np.asarray, jstate.extra["ir_params"]))
    got = validator.run(state)
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"], (got, want)
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.05, (got, want)
