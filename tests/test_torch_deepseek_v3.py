"""The DeepSeek-V3 prior (``models/transformers/deepseek_v3.py``) against the
benchmark's plain reference (``benchmark/reference/deepseek_v3.py``) on the
CPU, at a small size on seeded weights: hidden 64, 4 heads of 16 + 8 (RoPE)
query/key and 16 value dimensions, latent rank 32, 16 routed experts of
which the rank holds 4, 3 a token, 1 dense + 4 MoE layers, 2 x 17 tokens.

- logits, the loss with the balance term, every leaf's gradient and the
  chosen experts; three ``ARAlgorithm.train_step``s against the reference's
  three steps (losses, routes, each leaf's change, the balancing bias);
- the share of expert parallelism: the four ranks' partial outputs of a MoE
  layer, the shared experts counted once, add up to the uncut layer's;
- a forced imbalance that sends every token to one held expert: no row is
  dropped, and the result is still the reference's;
- a layer that holds part of the experts passes its router no gradient
  through their outputs, only through the balance loss;
- the configuration's JSON builds through ``ARAlgorithm`` (at a small width,
  and its prior on the meta device at full width: 957,426,176 parameters).
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import weights as wt  # noqa: E402
from benchmark.reference import codes_steps as cs  # noqa: E402
from benchmark.reference import deepseek_v3 as ref  # noqa: E402

import vector_quantization_tpu_torch.algorithms.ar  # noqa: E402,F401  (registers the classes built below)
import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: E402,F401
import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: E402,F401
import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: E402,F401
from vector_quantization_tpu_torch.models.transformers.deepseek_v3 import DeepseekV3Transformer  # noqa: E402
from vector_quantization_tpu_torch.registries import AlgorithmRegistry  # noqa: E402
from vector_quantization_tpu_torch.tasks.sequence_modeling import next_token_ce  # noqa: E402

CONFIG = REPO / "benchmark/configs/moonlight_16b_a3b_c2i.json"
# the reference's keys (HF's names); n_routed_experts: the experts held
REF = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
       "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 24, "n_routed_experts": 4,
       "router_experts": 16, "num_experts_per_tok": 3, "n_shared_experts": 2, "first_k_dense_replace": 1,
       "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5, "rope_theta": 50000.0, "num_hidden_layers": 5,
       "vocab_size": 74, "expert_rank": 1, "balance_alpha": 1e-4, "bias_gamma": 1e-3, "model_type": "deepseek_v3",
       "num_categories": 10, "optimizer": {"lr": 1e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.05,
                                           "grad_clip": 1.0}}
# the program's keys
PROG = {"hidden_size": 64, "num_layers": 5, "num_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 24,
        "n_routed_experts": 16, "num_experts_per_tok": 3, "n_shared_experts": 2, "experts_held": 4, "expert_rank": 1}
SEED = 2 ** 31 + 2717


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(rank: int = 1, held: int = 4):
    """The program and the reference on the same seeded weights (rank
    ``rank`` holding ``held`` of the 16 experts)."""
    c = dict(REF, n_routed_experts=held, expert_rank=rank)
    w = cs.weights(dict(c, n_routed_experts=16, expert_rank=0), SEED, "cpu")  # every expert's weights
    model = DeepseekV3Transformer(74, 17, **dict(PROG, experts_held=held, expert_rank=rank))
    wt.load(model, w, "deepseek.")
    reference = cs.build(cs.factory(c), "cpu", w, "deepseek.")
    return model, reference


def _tokens(seed: int = 3, b: int = 2):
    return torch.randint(0, 74, (b, 17), generator=torch.Generator().manual_seed(seed))


def test_logits_loss_gradients_and_routes_equal_the_reference():
    model, reference = _pair()
    routes = []
    for moe in model.moe_layers():
        def logged(x, _route=moe.route):
            out = _route(x)
            routes.append(out[0])
            return out

        moe.route = logged
    tok = _tokens()
    logits, aux = model(tok, return_aux=True)
    want, raux = reference(tok)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    loss = next_token_ce(logits, tok) + aux["balance"]
    ref_loss = ref.next_token_ce(want, tok) + raux["balance"]
    assert float(aux["balance"].detach()) > 0
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0)
    for got, r in zip(routes, raux["routes"]):
        assert torch.equal(got.sort(-1).values, r.sort(-1).values)
    for got, r in zip(aux["loads"], raux["loads"]):
        assert torch.equal(got, r) and int(got.sum()) == 2 * 17 * 3
    names = [n for n, _ in model.named_parameters()]
    assert names == [n for n, _ in reference.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)
    ref_grads = torch.autograd.grad(ref_loss, list(reference.parameters()), allow_unused=True, materialize_grads=True)
    for name, g, r in zip(names, grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-7, msg=name)
    rows = model.counters["expert_rows"]
    assert [sum(layer) for layer in rows] == [int(((r >= 4) & (r < 8)).sum()) for r in raux["routes"]]
    assert model.counters["count_reads"] == 4 and model.counters["kernel_products"] == 0


def _algorithm(held: int = 4, rank: int = 1):
    cfg = json.loads(CONFIG.read_text())["algorithm"]
    cfg["transformer"].update(PROG, experts_held=held, expert_rank=rank)
    cfg.update(num_categories=10, image_size=16, ir={
        "type": "AutoencoderModel",
        "encoder": {"type": "VQGANEncoder", "width": 16, "out_channels": 8, "width_mults": [1, 1, 2],
                    "depth_mult": 1},
        "quantizer": {"type": "VectorQuantizer", "codebook_size": 64, "embedding_dim": 8,
                      "normalize_inputs": True, "losses": {"vqgan": {"beta": 0.25}}},
        "decoder": {"type": "VQGANDecoder", "width": 16, "in_channels": 8, "width_mults": [2, 1, 1],
                    "depth_mult": 1}})
    return AlgorithmRegistry.build(cfg, device="cpu")


def test_three_train_steps_through_the_algorithm_equal_the_reference():
    algo = _algorithm()
    assert isinstance(algo.model, DeepseekV3Transformer) and algo.model.max_length == 17
    w = cs.weights(REF, SEED, "cpu")
    wt.load(algo.model, w, "deepseek.")
    state = algo.init_state(0)
    gen = torch.Generator().manual_seed(4)
    items = [(torch.randint(0, 64, (2, 4, 4), generator=gen), torch.randint(0, 10, (2,), generator=gen))
             for _ in range(3)]
    routes, step = [], []
    for moe in algo.model.moe_layers():
        def logged(x, _route=moe.route):
            out = _route(x)
            step.append(out[0].to(torch.uint8))
            return out

        moe.route = logged
    losses = []
    for codes, labels in items:
        state, m = algo.train_step(state, {"codes": codes, "category": labels})
        losses.append(float(m["loss"]))
        routes.append(list(step))
        step.clear()
    want = cs.run(REF, SEED, "cpu", items)
    assert losses == pytest.approx(want["losses"], rel=1e-6)
    for got_step, want_step in zip(routes, want["routes"]):
        for got, r in zip(got_step, want_step):
            assert torch.equal(got.sort(-1).values, r.sort(-1).values)
    for got, r in zip([m.gate.e_score_correction_bias for m in algo.model.moe_layers()], want["bias"]):
        assert torch.equal(got, r)
        assert float(got.abs().max()) > 0
    for name, p in algo.model.named_parameters():
        change = float((p.detach() - w["deepseek." + name]).norm())
        assert change == pytest.approx(want["update_norms"][name], rel=1e-3, abs=1e-9), name


def _layer_input(seed: int = 5):
    return torch.randn(2, 17, 64, generator=torch.Generator().manual_seed(seed))


def test_the_ranks_shares_add_up_to_the_uncut_layer():
    _, uncut = _pair(rank=0, held=16)
    x = _layer_input()
    want, _, _, _, _ = uncut.moe_layers()[1](x)
    shared = uncut.moe_layers()[1].shared_experts(x)
    total = torch.zeros_like(want)
    for rank in range(4):
        model, _ = _pair(rank=rank, held=4)
        part, _, _ = model.moe_layers()[1](x)
        total = total + part - shared
        assert model.moe_layers()[1].held == range(4 * rank, 4 * rank + 4)
    torch.testing.assert_close(total + shared, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("held", [4, 16])
def test_a_cut_layers_router_learns_from_the_balance_loss_alone(held):
    """A layer that holds 4 of the 16 experts passes its router no gradient
    through the experts' outputs (a rank's part of it alone would teach the
    router to avoid its experts); the uncut layer does, as the reference's."""
    model, reference = _pair(rank=0, held=held)
    x = _layer_input(8)
    for moe in (model.moe_layers()[0], reference.moe_layers()[0]):
        out = moe(x)
        (g,) = torch.autograd.grad(out[0].square().sum(), moe.gate.weight, retain_graph=True, allow_unused=True,
                                   materialize_grads=True)
        (b,) = torch.autograd.grad(out[1], moe.gate.weight)
        assert float(b.abs().max()) > 0
        assert (float(g.abs().max()) == 0) == (held < 16)

def test_a_forced_imbalance_drops_nothing():
    """Experts 4, 0 and 9 lead every token's scores by far: each of the 34
    tokens sends one choice to held expert 4 and none to 5-7."""
    model, reference = _pair()
    for moe in model.moe_layers() + reference.moe_layers():
        moe.gate.e_score_correction_bias.zero_()[[4, 0, 9]] = 10.0
    before = copy.deepcopy(model.counters)
    x = _layer_input(6)
    got, _, load = model.moe_layers()[0](x)
    want, _, ref_load, idx, _ = reference.moe_layers()[0](x)
    rows = [a - b for a, b in zip(model.counters["expert_rows"][0], before["expert_rows"][0])]
    assert rows == [34, 0, 0, 0] and torch.equal(load, ref_load) and int(load[4]) == 34
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    tok = _tokens(7)
    logits, _ = model(tok, return_aux=True)
    torch.testing.assert_close(logits, reference(tok)[0], rtol=1e-5, atol=1e-5)


def test_the_configuration_builds_at_full_width_and_refuses_a_cache():
    cfg = json.loads(CONFIG.read_text())
    t = {k: v for k, v in cfg["algorithm"]["transformer"].items() if k != "type"}
    assert t["n_routed_experts"] == cfg["router_experts"] == 64 and t["experts_held"] == cfg["n_routed_experts"] == 8
    with torch.device("meta"):
        model = DeepseekV3Transformer(cfg["vocab_size"], cfg["max_position_embeddings"], **t)
        reference = ref.DeepseekV3(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(p.numel() for p in reference.parameters()) == 957_426_176
    assert [n for n, _ in model.named_parameters()] == [n for n, _ in reference.named_parameters()]
    assert sorted(model.layers[1].mlp.experts) == [str(e) for e in range(8)]
    with pytest.raises(NotImplementedError, match="latent cache"):
        model.init_cache(2)
    small = DeepseekV3Transformer(74, 17, **PROG)
    with pytest.raises(NotImplementedError, match="latent cache"):
        small(_tokens(), cache=object())
