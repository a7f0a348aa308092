"""Reducing a trace: overlapping device operations count once, idle gaps
are labelled by the benchmark's host range open at their start, device
time is classed by the operator that launched it, and the metric readers
read what they should from a small synthetic trace."""

from types import SimpleNamespace

import pytest

from benchmark import harness, readers, trace as tr
from conftest import REPO


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def synthetic():
    return tr.from_events([
        X("user_annotation", "window", 0, 100),
        X("user_annotation", "stage", 0, 5),
        X("user_annotation", "step", 5, 60),
        X("user_annotation", "k1", 10, 4),
        X("cpu_op", "aten::mm", 6, 2),
        X("cpu_op", "aten::convolution", 20, 5),
        X("cuda_runtime", "cudaLaunchKernel", 6.5, 1, correlation=1),
        X("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=2),
        X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=3),
        X("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=4),
        X("user_annotation", "readback", 80, 20),
        X("kernel", "gemm", 10, 20, tid=7, correlation=1),  # 10-30
        X("kernel", "lookup_a", 25, 10, tid=8, correlation=2),  # 25-35, overlaps the gemm
        X("kernel", "lookup_b", 35, 5, tid=7, correlation=3),  # 35-40
        X("kernel", "conv", 60, 30, tid=7, correlation=4),  # 60-90
        X("gpu_memcpy", "Memcpy DtoH", 95, 10, tid=9),  # 95-105, clipped at 100
    ])


def test_overlapping_operations_count_once():
    t = synthetic()
    assert (t.t0, t.t1) == (0, 100)
    assert tr.busy_us(t) == pytest.approx(30 + 30 + 5)  # 10-40, 60-90, 95-100


def test_gaps_are_labelled_by_the_host_range_open_at_their_start():
    t = synthetic()
    assert tr.idle_gaps(t) == [(0, 10), (40, 20), (90, 5)]
    b = tr.breakdown(t)
    assert [n for n, _ in b["idle_gaps"]] == ["step", "stage", "readback"]
    assert [s for _, s in b["idle_gaps"]] == pytest.approx([20e-6, 10e-6, 5e-6])
    assert b["device_ops"][0] == ["conv", pytest.approx(30e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_operations_are_classed_by_what_launched_them():
    t = synthetic()
    assert [n for n, _, _ in tr.ops_under(t, ["k1"])] == ["lookup_a", "lookup_b"]
    assert [n for n, _, _ in tr.ops_under(t, ["aten::mm"])] == ["gemm"]
    run = SimpleNamespace(trace=t)
    assert readers.device_ms(run, ["k1"]) == pytest.approx(15e-3)
    assert readers.device_ms(run, ["k1", "aten::mm"]) == pytest.approx(30e-3)  # 10-40 once
    assert readers.device_ms(run, ["step"], exclude=["aten::convolution"]) == pytest.approx(30e-3)
    assert readers.idle_pct(run) == pytest.approx(35.0)


def _reader(name):
    return harness.load_module(REPO / "benchmark/metrics" / f"{name}.py", f"test_metric_{name}")


def test_readers_on_the_synthetic_trace():
    t = synthetic()
    cell = SimpleNamespace(calls={"k1": [[(2560, 8), (16384, 8)]] * 2}, config={"codebook_size": 16384,
                           "enc_width_mults": [1, 1, 2, 2, 4]}, traffic={"crop": 256})
    run = SimpleNamespace(trace=t, cell=cell, counters={"images": 2, "crops": 20, "steps": 2, "peak_bytes": 2 ** 31},
                          window_s=1e-4, setup_s=3.0)
    least = 2 * 671_088_640 / 989e12
    assert _reader("k1_roofline.export").read(run) == pytest.approx(100 * least / 15e-6)
    assert _reader("device_idle.export").read(run) == pytest.approx(35.0)
    assert _reader("encoder_conv_ms").read(run) == pytest.approx(30e-3 / 2)
    assert _reader("peak_gib.train").read(run) == 2.0
    assert _reader("export_images_per_s").read(run) == pytest.approx(2 / 1e-4)
    assert _reader("setup_s").read(run) == 3.0


def test_readers_find_nothing_without_a_device_trace():
    empty = tr.from_events([X("user_annotation", "window", 0, 100)])
    run = SimpleNamespace(trace=empty, cell=SimpleNamespace(calls={}, config={}, traffic={"crop": 256}),
                          counters={"images": 2, "steps": 2}, window_s=1.0)
    for name in ("device_idle.export", "k1_roofline.export", "encoder_conv_ms", "export_mfu", "gpt2_matmul_ms"):
        assert _reader(name).read(run) is None, name
