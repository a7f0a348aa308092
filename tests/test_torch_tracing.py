"""The port's spans (``utils/debug.py`` ``span``) on the CPU.

- A GAN-on VQGAN step and an AR step from images, run under
  ``torch.profiler``, open exactly the documented spans, nested as
  documented; K1's CUDA entry opens ``vq.nearest_codes``; the ``Trainer``'s
  pulls from its loader show as ``vq.data_wait`` in ``ProfileCallback``'s
  ``work_dir/profile/trace.json``.
- With no profiler recording, ``span`` is one shared no-op context and no
  ``record_function`` is entered.
- Every span name starts with ``vq.``, but for the f32 GEMM's product
  ranges (``gpt2.gemm`` of ``ops/f32_gemm.py``, the DeepSeek-V3 prior's
  ``*.gemm``) and the backward ranges (``*.backward``,
  ``utils/debug.BackwardRange``), which must not: the benchmark's
  ``spans.chains`` hands a ``vq.`` span opened on autograd's engine thread
  to every later engine launch. None is one of the benchmark's own range
  names (``benchmark/trace.py``, ``benchmark/harness.py``).
- A ``nearest_codes`` set on its module, as the benchmark's traced runs
  set one, is the one the quantizer calls, and it keeps ``launches``.
"""

import contextlib
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vector_quantization_tpu_torch.algorithms.ar  # noqa: F401  (registers the classes built below)
import vector_quantization_tpu_torch.algorithms.vqgan  # noqa: F401
import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: F401
import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: F401
import vector_quantization_tpu_torch.models.transformers.gpt2  # noqa: F401
import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: F401
from vector_quantization_tpu_torch.ops import vq_lookup
from vector_quantization_tpu_torch.registries import AlgorithmRegistry
from vector_quantization_tpu_torch.training.runner import build_runner
from vector_quantization_tpu_torch.utils import debug
from vector_quantization_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")

# the spans of the port's layer boundaries (PERF.md section 3)
SPANS = {"vq.train_step", "vq.ar.tokens", "vq.ar.forward", "vq.backward", "vq.optimizer", "vq.codebook_update",
         "vq.ema", "vq.vqgan.generation", "vq.vqgan.aglw", "vq.vqgan.discrimination", "vq.nearest_codes",
         "vq.data_wait", "vq.ar.after_step", "vq.mla", "vq.moe.route", "vq.moe.balance", "vq.moe.dispatch",
         "vq.moe.experts", "vq.moe.combine", "vq.moe.shared"}
# the products' ranges of ops/f32_gemm.py and the backward ranges, opened in backward too: not phases
PRODUCT_RANGES = {"gpt2.gemm", "mla.gemm", "ffn.gemm", "moe.router.gemm", "moe.expert.gemm", "moe.shared.gemm",
                  "head.gemm"}
BACKWARD_RANGES = {"mla.backward", "moe.backward", "moe.experts.backward", "moe.shared.backward"}
# the benchmark's own range names: its window, the ranges its idle gaps are labelled by, its entry ranges
BENCHMARK_RANGES = {"window", "traffic", "stage", "step", "encode", "readback", "k1"}

IR = {"type": "AutoencoderModel",
      "encoder": {"type": "VQGANEncoder", "width": 16, "out_channels": 4, "width_mults": [1, 2], "depth_mult": 1},
      "quantizer": {"type": "VectorQuantizer", "codebook_size": 16, "embedding_dim": 4, "normalize_inputs": True,
                    "losses": {"vqgan": {"beta": 0.25}}},
      "decoder": {"type": "VQGANDecoder", "width": 16, "in_channels": 4, "width_mults": [2, 1], "depth_mult": 1}}
VQGAN = {"type": "VQGANAlgorithm", "model": IR,
         "discriminator": {"type": "PatchGANDiscriminator", "width": 8, "depth": 2}, "recon_losses": {"l1": {}},
         "aglw_gain": 0.8, "codebook_update": {"type": "normalize"}, "ema_decay": 0.999}
AR = {"type": "ARAlgorithm", "transformer": {"type": "GPT2Transformer", "hidden_size": 32, "num_layers": 1,
                                             "num_heads": 2, "dtype": "float32"},
      "ir": IR, "num_categories": 10, "image_size": 16,
      "optimizer": {"type": "adamw", "lr": 1e-4, "weight_decay": 0.05, "grad_clip": 1.0}}

VQGAN_SPANS = [("vq.train_step", None), ("vq.vqgan.generation", "vq.train_step"), ("vq.vqgan.aglw", "vq.train_step"),
               ("vq.backward", "vq.train_step"), ("vq.optimizer", "vq.train_step"),
               ("vq.codebook_update", "vq.train_step"), ("vq.vqgan.discrimination", "vq.train_step"),
               ("vq.optimizer", "vq.vqgan.discrimination"), ("vq.ema", "vq.train_step")]
AR_SPANS = [("vq.train_step", None), ("vq.ar.tokens", "vq.train_step"), ("vq.ar.forward", "vq.train_step"),
            ("vq.backward", "vq.train_step"), ("vq.optimizer", "vq.train_step")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread: they are small, and beside
    other test processes a full intra-op pool mostly waits for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step(kind):
    """(the algorithm, its state, a batch): a GAN-on VQGAN or an AR step from images."""
    torch.manual_seed(0)
    algo = AlgorithmRegistry.build(dict(VQGAN if kind == "vqgan" else AR), device="cpu")
    state = algo.init_state(0)
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1, "category": torch.tensor([1, 2])}
    return algo, state, batch


def _vq_spans(events):
    """The ``vq.`` annotations of Chrome trace events in start order, each
    with the innermost ``vq.`` annotation around it (None: none)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("vq."))
    out = []
    for i, (a, b, name) in enumerate(spans):
        around = [s for s in spans[:i] if s[0] <= a and b <= s[1]]
        out.append((name, around[-1][2] if around else None))
    return out


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("kind, expected", [("vqgan", VQGAN_SPANS), ("ar", AR_SPANS)])
def test_a_profiled_step_opens_the_documented_spans(kind, expected, tmp_path):
    algo, state, batch = _step(kind)
    if kind == "vqgan":
        state.step = algo.d_start  # the discriminator and the adaptive weight on
    events = _profiled(lambda: algo.train_step(state, batch), tmp_path)
    assert _vq_spans(events) == expected


def test_k1_cuda_entry_opens_its_span(monkeypatch, tmp_path):
    # the CUDA branch with its launch stubbed: a CPU run takes the plain version, outside any span
    monkeypatch.setattr(vq_lookup, "_prepare", lambda x, codebook, metric: (x, codebook))
    monkeypatch.setattr(vq_lookup, "_launch", lambda x, codebook: "codes")
    on_card = SimpleNamespace(is_cuda=True)
    got = []
    events = _profiled(lambda: got.append(vq_lookup.nearest_codes(on_card, None)), tmp_path)
    assert got == ["codes"]
    assert _vq_spans(events) == [("vq.nearest_codes", None)]
    events = _profiled(lambda: vq_lookup.nearest_codes(torch.randn(4, 2), torch.randn(3, 2)), tmp_path)
    assert _vq_spans(events) == []


def test_the_trainers_profile_holds_its_loader_wait(tmp_path):
    cfg = load_config(SMOKE)
    cfg.override({"trainer.max_iters": 3, "trainer.callbacks": [dict(type="ProfileCallback", start=1, steps=1)]})
    trainer = build_runner(cfg, "trainer", device="cpu", work_dir=str(tmp_path))
    assert trainer.run().step == 3
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    assert [s for s in _vq_spans(events) if s[1] is None] == [("vq.data_wait", None), ("vq.train_step", None)]


def test_without_a_profiler_span_is_one_shared_noop(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert debug.span("vq.a") is debug.span("vq.b")
    entered = []

    def record_function(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    for kind in ("vqgan", "ar"):
        algo, state, batch = _step(kind)
        state.step = getattr(algo, "d_start", 0)
        algo.train_step(state, batch)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.span("vq.a"):
            pass
    assert entered == ["vq.a"]


def test_span_names_are_the_ports_and_none_is_the_benchmarks():
    package = REPO / "vector_quantization_tpu_torch"
    sources = [f.read_text() for f in package.rglob("*.py")]
    names = {m for text in sources for m in re.findall(r'\bspan\("([\w.]+)"\)', text)}
    assert names == SPANS
    ranges = {m for text in sources for m in re.findall(r'"([\w.]+\.gemm)"', text)}
    backward = {m for text in sources for m in re.findall(r'BackwardRange\("([\w.]+)"\)', text)}
    assert ranges == PRODUCT_RANGES and backward == BACKWARD_RANGES
    assert all(n.startswith("vq.") for n in SPANS)
    assert not any(n.startswith("vq.") for n in PRODUCT_RANGES | BACKWARD_RANGES)
    assert not (names | ranges | backward) & BENCHMARK_RANGES


def test_a_nearest_codes_set_on_its_module_is_the_one_the_quantizer_calls(monkeypatch):
    # as the benchmark's entry ranges do: a wrapper with the function's attributes, copied back after
    orig = vq_lookup.nearest_codes
    assert isinstance(orig.launches, int) and not hasattr(orig, "__wrapped__")
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return orig(*args, **kwargs)

    wrapper.__dict__.update(orig.__dict__)
    monkeypatch.setattr(vq_lookup, "nearest_codes", wrapper)
    algo, state, batch = _step("vqgan")
    algo.train_step(state, batch)
    assert calls == [(2 * 8 * 8, 4)]
    wrapper.launches += 2
    orig.__dict__.update({k: v for k, v in wrapper.__dict__.items() if k in orig.__dict__})
    monkeypatch.undo()
    assert vq_lookup.nearest_codes is orig and orig.launches == wrapper.launches
    orig.launches -= 2
