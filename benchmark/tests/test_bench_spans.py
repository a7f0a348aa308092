"""The program's ``vq.`` spans in a traced window (``benchmark/spans.py``):
a backward's launches from autograd's engine thread take the span of the
launch they follow, device time is read by span, idle gaps inside the step
are split by the innermost span open at their start, and the new readers
find nothing in a trace without the program's spans. On the card (marked
``cuda``; skipped without one): correlation ids rise in the order of the
runtime calls of all threads, and every kernel takes the span that was
open on the calling thread when it was launched."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, readers, spans, trace as tr
from conftest import REPO

S = 100.0  # microseconds a unit of the synthetic timeline
MAIN, ENGINE = 1, 2  # the calling thread, autograd's engine thread


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts * S, "dur": dur * S, "pid": 1, "tid": tid, "args": args}


def launch(ts, corr, tid=MAIN):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 0.1, tid=tid, correlation=corr)


def kernel(name, ts, dur, corr):
    return X("kernel", name, ts, dur, tid=7, correlation=corr)


def backward(ts, dur):
    return X("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", ts, dur, tid=ENGINE)


def synthetic(with_spans=True):
    """A GAN step's phases on the calling thread, the backward passes'
    launches on the engine's thread (one of them outside any frame)."""
    program = [
        X("user_annotation", "vq.train_step", 6, 134),
        X("user_annotation", "vq.vqgan.aglw", 10, 30),
        X("user_annotation", "vq.backward", 50, 30),
        X("user_annotation", "vq.optimizer", 85, 15),
        X("user_annotation", "vq.vqgan.discrimination", 100, 35),
        X("user_annotation", "vq.optimizer", 120, 10),
    ]
    return tr.from_events((program if with_spans else []) + [
        X("user_annotation", "window", 0, 200),
        X("user_annotation", "stage", 0, 5),
        X("user_annotation", "step", 5, 145),
        backward(12.5, 17.5), backward(52.5, 21.5), backward(102.5, 15.5), backward(146, 1),
        launch(2, 1), launch(11, 2), launch(13, 3, ENGINE), launch(20, 4, ENGINE),
        launch(51, 5), launch(53, 6, ENGINE), launch(76, 7, ENGINE),  # 7: the engine, outside any frame
        launch(86, 8), launch(101, 9), launch(103, 10, ENGINE), launch(121, 11),
        launch(145, 12), launch(146.5, 13, ENGINE),  # after the step: a launch outside every span, then the engine
        kernel("copy", 3, 5, 1),
        kernel("fill_a", 12, 1, 2), kernel("bwd_a", 14, 10, 3), kernel("bwd_b", 24, 6, 4),
        kernel("fill_b", 52, 1, 5), kernel("bwd_c", 55, 20, 6), kernel("memset_c", 75, 2, 7),
        kernel("adam", 87, 10, 8),
        kernel("disc", 102, 5, 9), kernel("disc_bwd", 107, 8, 10), kernel("adam_d", 122, 6, 11),
        kernel("tail", 146, 2, 12), kernel("tail_bwd", 149, 1, 13),
    ])


def _run(t):
    return SimpleNamespace(trace=t, counters={"steps": 1})


def test_engine_launches_take_the_span_of_the_launch_they_follow():
    chain = spans.chains(synthetic())
    step = "vq.train_step"
    assert chain[1] == ()
    assert chain[2] == chain[3] == chain[4] == (step, "vq.vqgan.aglw")
    assert chain[5] == chain[6] == chain[7] == (step, "vq.backward")
    assert chain[8] == (step, "vq.optimizer")
    assert chain[9] == chain[10] == (step, "vq.vqgan.discrimination")
    assert chain[11] == (step, "vq.vqgan.discrimination", "vq.optimizer")
    assert chain[12] == chain[13] == ()


def test_a_launch_on_the_calling_thread_inside_the_engine_keeps_its_own_span():
    # on the CPU the engine runs on the calling thread: the frames and the span share it
    t = tr.from_events([X("user_annotation", "window", 0, 10), X("user_annotation", "vq.backward", 1, 5),
                        X("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, 2),
                        launch(3, 1), launch(8, 2, ENGINE)])
    assert spans.chains(t) == {1: ("vq.backward",), 2: ("vq.backward",)}


def test_device_time_by_span_includes_the_backward():
    t = synthetic()
    run = _run(t)
    assert spans.device_ms(run, "vq.vqgan.aglw") == pytest.approx(17 * S * 1e-3)  # 12-13, 14-30
    assert spans.device_ms(run, "vq.backward") == pytest.approx(23 * S * 1e-3)  # 52-53, 55-77
    assert spans.device_ms(run, "vq.optimizer") == pytest.approx(16 * S * 1e-3)  # G's and D's
    assert spans.device_ms(run, "vq.vqgan.discrimination") == pytest.approx(19 * S * 1e-3)  # 102-115, 122-128
    assert spans.device_ms(run, "vq.train_step") == pytest.approx(69 * S * 1e-3)
    assert spans.device_ms(run, "vq.ema") is None
    # classed by the launching thread's frames alone, the aglw keeps its seed's fill only
    assert readers.device_ms(run, ("vq.vqgan.aglw",)) == pytest.approx(1 * S * 1e-3)


def test_stalls_are_split_by_the_innermost_span_at_the_gap():
    t = synthetic()
    split = spans.stalls(t)
    assert {k: (pytest.approx(v[0]), v[1], v[2]) for k, v in split.items()} == {
        "none": (4 * S, 1, 0), "vq.vqgan.aglw": (23 * S, 2, 1), "vq.backward": (12 * S, 2, 1),
        "vq.optimizer": (23 * S, 2, 1), "vq.vqgan.discrimination": (7 * S, 1, 0)}
    # the benchmark's labels of the same gaps ignore the program's spans
    assert tr.host_label(t, 30 * S) == "step"


def _reader(name):
    return harness.load_module(REPO / "benchmark/metrics" / f"{name}.py", f"test_metric_{name}")


def test_readers(capsys):
    run = _run(synthetic())
    run.counters["steps"] = 2
    assert _reader("aglw_ms.vqgan_train").read(run) == pytest.approx(17 * S * 1e-3 / 2)
    assert _reader("discrimination_ms.vqgan_train").read(run) == pytest.approx(19 * S * 1e-3 / 2)
    assert _reader("optimizer_ms.train").read(run) == pytest.approx(16 * S * 1e-3 / 2)
    assert _reader("tokenize_ms.train").read(run) is None
    assert _reader("host_stall_ms.vqgan_train").read(run) == pytest.approx(69 * S * 1e-3 / 2)
    line = capsys.readouterr().err
    assert line.startswith("host_stall_ms.vqgan_train by span (ms a step over 2 steps): vq.vqgan.aglw 1.150")
    assert "none 0.200 (1 gaps, 0 of 1 ms or more)" in line


def test_readers_find_nothing_without_the_programs_spans():
    run = _run(synthetic(with_spans=False))
    for name in ("aglw_ms.vqgan_train", "discrimination_ms.vqgan_train", "optimizer_ms.train", "tokenize_ms.train",
                 "host_stall_ms.vqgan_train"):
        assert _reader(name).read(run) is None, name


@pytest.mark.cuda
def test_the_engine_rule_on_the_card(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: only there does autograd's engine launch from its own thread")
    dev = torch.device("cuda")
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.ReLU(),
                              torch.nn.Conv2d(16, 16, 3, padding=1)).to(dev)
    params = list(net.parameters())
    x = torch.randn(4, 3, 32, 32, device=dev)

    def step():
        with record_function("vq.forward"):
            loss = net(x).square().mean()
        with record_function("vq.grad"):
            grads = torch.autograd.grad(loss, params)
        with record_function("vq.update"), torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-3)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            for _ in range(3):
                step()
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    calls = sorted((e["args"]["correlation"], float(e["ts"]), e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in (e.get("args") or {}))
    assert len({tid for _, _, tid in calls}) >= 2  # the backward's launches come from the engine's thread
    assert all(b[1] >= a[1] for a, b in zip(calls, calls[1:]))  # correlation order is launch order
    t = tr.from_events(events)
    chain = spans.chains(t)
    by_time = sorted((ts, corr) for corr, ts, _ in calls)
    opened = dict(zip((c for _, c in by_time), spans.open_at(t.ranges, [ts for ts, _ in by_time])))
    kernels = [corr for _, ts, _, corr in t.ops if t.t0 <= ts <= t.t1]
    assert kernels and all(chain[c] == opened[c] for c in kernels)
    assert len(spans.ops_in(t, "vq.grad")) > len(tr.ops_under(t, ["vq.grad"]))
