"""The port's golden harness and ``record_published`` on the CPU, held
against the JAX tools and ``BASELINE.json``.

- ``tools/_taming.py``'s ``TamingVQGAN`` under ``torch.manual_seed(0)``
  gives the state dict of the repo's taming fixture (``_TmVQGAN`` of
  ``test_parity_torch.py``), tensor for tensor.
- ``golden_eval`` on that checkpoint through ``configs/regression/
  golden_synthetic.py``, as ``tests/test_golden_eval.py`` drives the JAX
  harness: exit 1 against the built-in table (``fid`` and ``lpips``
  missing, shown as NaN), exit 0 against its own measured numbers; the
  metric dict equal to the JAX harness's within 1e-4 relative (1e-6 for
  the codebook numbers, which count codes); the grafted weights equal to
  the JAX graft's, bridged; ``--publish`` writing ``<work_dir>/
  published.json`` and leaving ``BASELINE.json`` as it was; a
  ``width`` that is not the checkpoint's refused; ``compare``'s cases.
- ``record_published --check`` against ``BASELINE.json["published"]`` with
  ``CHECK_TOL``: ``synthetic_taming_vqgan`` as it runs;
  ``self_trained_smoke`` from the JAX runner's initial weights (bridged),
  which the record was trained from; ``self_trained_ar`` with the recorded
  ``iter_800`` weights in place of the 800 steps (its validation and
  greedy decode: ``decode_hash`` 134239 exactly), and retrained from the
  port's own draws (loss and accuracy within ``CHECK_TOL``; the greedy
  stream of a retrained model is another, see ``PERF.md``).
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_parity_torch import _TmVQGAN
from tests.test_torch_ar_train import _restore_iter_800
from vector_quantization_tpu.training.runner import build_runner as jax_build_runner
from vector_quantization_tpu.utils.config import load_config as jax_load_config
from vector_quantization_tpu_torch.tools import _taming, golden_eval
from vector_quantization_tpu_torch.tools import record_published as rp
from vector_quantization_tpu_torch.utils.bridge import load_ar_from_flax, state_dict_from_flax

REPO = Path(__file__).resolve().parents[1]
GOLDEN_CONFIG = str(REPO / "configs/regression/golden_synthetic.py")
SMOKE = str(REPO / "configs/regression/smoke_anchor.py")
CONVERTER = ["--converter-options", "width=32", "enc_width_mults=(1, 2)", "enc_depth=2", "dec_depth=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops of this module on one thread (small ops beside other test
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _taming.synthetic_checkpoint(str(tmp_path_factory.mktemp("golden") / "tiny_taming.pth"))


def _run(ckpt, work, extra=()):
    return golden_eval.main(["taming_vqgan", "--checkpoint", ckpt, "--config", GOLDEN_CONFIG,
                             "--work-dir", str(work), "--device", "cpu", *CONVERTER, *extra])


def _measured(out: str) -> dict:
    return json.loads(out[out.index("{"): out.index("}") + 1])


def test_taming_copy_draws_the_fixtures_state_dict():
    torch.manual_seed(0)
    want = _TmVQGAN().state_dict()
    torch.manual_seed(0)
    got = _taming.TamingVQGAN().state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fails_against_reference_golden(ckpt, tmp_path, capsys):
    rc = _run(ckpt, tmp_path)
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL" in out
    rows = {line.split()[0]: line for line in out.splitlines() if line.endswith(("PASS", "FAIL"))}
    assert set(rows) == set(golden_eval.GOLDEN["taming_vqgan"])
    assert "nan" in rows["fid"] and "nan" in rows["lpips"]  # not in this config: missing, not a crash


def test_passes_against_measured_golden(ckpt, tmp_path, capsys):
    _run(ckpt, tmp_path)
    measured = _measured(capsys.readouterr().out)
    golden = {k: v for k, v in measured.items() if k in golden_eval.DEFAULT_TOL}
    rc = _run(ckpt, tmp_path, ["--golden", json.dumps(golden)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAIL" not in out and out.count("PASS") == len(golden)


def test_metrics_and_graft_match_the_jax_harness(ckpt, tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_golden_eval", REPO / "tools/golden_eval.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    rc_jax = jax_tool.main(["taming_vqgan", "--checkpoint", ckpt, "--config", GOLDEN_CONFIG,
                            "--work-dir", str(tmp_path / "jax"), *CONVERTER])
    want = _measured(capsys.readouterr().out)
    rc = _run(ckpt, tmp_path / "port")
    got = _measured(capsys.readouterr().out)
    assert rc == rc_jax == 1 and set(got) == set(want)
    for k in want:
        tol = 1e-6 if k.startswith("codebook") else 1e-4
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1.0), (k, got[k], want[k])
    # the grafted generator against the JAX graft's tree
    jval = jax_build_runner(jax_load_config(GOLDEN_CONFIG), "validator")
    jval.work_dir = str(tmp_path / "jax2")
    jval.init_state()
    jstate = jax_tool.graft(jval.state, jax_tool.convert("taming_vqgan", ckpt, {
        "width": 32, "enc_width_mults": (1, 2), "enc_depth": 2, "dec_depth": 3}))
    from vector_quantization_tpu_torch.training.runner import build_runner
    from vector_quantization_tpu_torch.utils.config import load_config

    val = build_runner(load_config(GOLDEN_CONFIG), "validator", device="cpu", work_dir=str(tmp_path / "p2"))
    val.init_state()
    golden_eval.graft(val, golden_eval.convert("taming_vqgan", ckpt, {"enc_width_mults": (1, 2), "enc_depth": 2,
                                                                     "dec_depth": 3}))
    model = val.state.model
    ref = state_dict_from_flax(model, jax.tree_util.tree_map(np.asarray, jstate.params["generator"]))
    for name, t in model.state_dict().items():
        assert torch.equal(t, ref[name]), name


def test_publish_writes_the_work_dir_not_baseline(ckpt, tmp_path, capsys):
    baseline = (REPO / "BASELINE.json").read_bytes()
    _run(ckpt, tmp_path, ["--publish"])
    out = capsys.readouterr().out
    data = json.loads((tmp_path / "published.json").read_text())
    entry = data["published"]["taming_vqgan"]
    assert entry["checkpoint"] == "tiny_taming.pth" and entry["config"] == GOLDEN_CONFIG
    assert entry["metrics"] == _measured(out)
    assert (REPO / "BASELINE.json").read_bytes() == baseline


def test_converter_width_is_checked_against_the_checkpoint(ckpt, tmp_path):
    with pytest.raises(SystemExit, match="conv_in has 32 output channels"):
        golden_eval.main(["taming_vqgan", "--checkpoint", ckpt, "--config", GOLDEN_CONFIG, "--work-dir",
                          str(tmp_path), "--device", "cpu", "--converter-options", "width=64"])


@pytest.mark.parametrize("results,golden,tols,want", [
    ({"l1/l1": 0.5, "fid": 3.0}, {"l1": 0.5005, "fid": 3.05}, {}, [True, True]),  # namespaced + within tol
    ({"l1": 0.5}, {"l1": 0.503}, {}, [False]),  # 2e-3 is l1's tolerance
    ({"ssim": 0.5}, {"ssim": 0.5, "fid": 1.0}, {}, [True, False]),  # a missing metric fails, as NaN
    ({"psnr": 20.0}, {"psnr": 20.2}, {"psnr": 0.5}, [True]),  # --tol over the defaults
    ({"x/novel": 1.0}, {"novel": 1.02}, {}, [False]),  # unknown metrics take 0.01
])
def test_compare_matches_jax(results, golden, tols, want):
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_golden_eval", REPO / "tools/golden_eval.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    merged = {**golden_eval.DEFAULT_TOL, **tols}
    got = golden_eval.compare(results, golden, merged)
    ref = jax_tool.compare(results, golden, {**jax_tool.DEFAULT_TOL, **tols})
    assert [r[4] for r in got] == want
    assert json.dumps(got) == json.dumps(ref)
    assert golden_eval.GOLDEN == jax_tool.GOLDEN and golden_eval.DEFAULT_TOL == jax_tool.DEFAULT_TOL


# -- record_published --check ----------------------------------------------

def _published():
    return json.loads((REPO / "BASELINE.json").read_text())["published"]


def test_tables_match_the_jax_tool():
    # read off the JAX tool's source: importing it would reconfigure JAX's platform
    tree = ast.parse((REPO / "tools/record_published.py").read_text())
    tables = {t.id: ast.literal_eval(node.value) for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name) and t.id in ("CHECK_TOL", "PROVENANCE")}
    assert rp.CHECK_TOL == tables["CHECK_TOL"] and rp.PROVENANCE == tables["PROVENANCE"]
    assert set(rp.RUNNERS) == set(rp.PROVENANCE)


def test_check_synthetic_taming_vqgan(tmp_path, capsys):
    baseline = (REPO / "BASELINE.json").read_bytes()
    rc = rp.main(["--check", "--families", "synthetic_taming_vqgan", "--work-dir", str(tmp_path),
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count(" ok") == len(_published()["synthetic_taming_vqgan"]["metrics"])
    assert (REPO / "BASELINE.json").read_bytes() == baseline


def _with_jax_init(monkeypatch):
    """``record_published``'s runners start from the JAX trainer's initial
    weights for the smoke anchor (``init_state(PRNGKey(3407), first
    batch)``, bridged), the weights the record was trained from."""
    jt = jax_build_runner(jax_load_config(SMOKE), "trainer")
    first = {k: v for k, v in next(iter(jt.dataloader)).items() if k != "id_"}
    key = jax.random.PRNGKey(3407)
    init = jax.jit(jt.algorithm.init_state).lower(key, first).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    jstate = init(key, first)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.extra["d_batch_stats"])
    real = rp.build_runner

    def build(config, kind, **kw):
        runner = real(config, kind, **kw)
        if kind == "trainer":
            init_state = runner.init_state

            def bridged():
                state = init_state()
                algo = runner.algorithm
                algo.model.load_state_dict(state_dict_from_flax(algo.model, params["generator"]))
                algo.discriminator.load_state_dict(state_dict_from_flax(algo.discriminator,
                                                                        params["discriminator"], stats))
                return state
            runner.init_state = bridged
        return runner

    monkeypatch.setattr(rp, "build_runner", build)


def test_check_self_trained_smoke_from_the_records_initial_weights(tmp_path, monkeypatch, capsys):
    _with_jax_init(monkeypatch)
    rc = rp.main(["--check", "--families", "self_trained_smoke", "--work-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out


def test_check_self_trained_ar_with_the_recorded_weights(tmp_path, monkeypatch, capsys):
    """The AR anchor's validation, greedy decode and gate, with the
    recorded ``iter_800`` weights in place of its 800 training steps."""
    restored = _restore_iter_800()
    params = jax.tree_util.tree_map(np.asarray, dict(restored["params"]))
    ir = jax.tree_util.tree_map(np.asarray, restored["extra"]["ir_params"])
    def recorded(work_dir, config_name, tag, device=None):
        assert config_name == "ar_anchor.py"
        config = rp.load_config(str(rp.REGRESSION / config_name))
        trainer = rp.build_runner(config, "trainer", device=device, work_dir=str(tmp_path / "t"))
        state = trainer.init_state()
        load_ar_from_flax(trainer.algorithm, params, ir)
        validator = rp.build_runner(config, "validator", device=device, work_dir=str(tmp_path / "v"))
        validator.init_state()
        load_ar_from_flax(validator.algorithm, params, ir)  # its frozen tokenizer encodes the eval images
        return trainer, state, validator.run(state)

    monkeypatch.setattr(rp, "_train", recorded)
    rc = rp.main(["--check", "--families", "self_trained_ar", "--work-dir", str(tmp_path), "--device", "cpu",
                  "--record"])
    out = capsys.readouterr().out
    assert rc == 0, out
    got = json.loads((tmp_path / "published_torch.json").read_text())["self_trained_ar"]
    assert got["metrics"]["decode_hash"] == 134239.0 and got["metrics"]["decode_mean"] == 32.2265625
    assert got["provenance"] == rp.PROVENANCE["self_trained_ar"] and got["platform"].startswith("cpu:cpu")


def test_check_self_trained_ar_retrained_holds_loss_and_accuracy(tmp_path, capsys):
    """800 steps from the port's own draws (weights, frozen tokenizer, CFG
    drops): the teacher-forced loss and accuracy within ``CHECK_TOL`` of
    the record. The greedy stream is another model's (``PERF.md``,
    open questions): its rows are printed, not held here."""
    measured = {"self_trained_ar": rp.self_trained_ar(str(tmp_path), "cpu")}
    _, rows = rp.check(measured, _published(), rp.platform_tag("cpu"))
    capsys.readouterr()
    by = {r["metric"]: r for r in rows}
    assert set(by) == {"loss", "accuracy", "decode_hash", "decode_mean"}
    assert by["loss"]["ok"] and by["accuracy"]["ok"], rows
    assert float(by["decode_hash"]["measured"]).is_integer() and 0 <= by["decode_hash"]["measured"] < 10**6
