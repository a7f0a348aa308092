"""Operations and bytes of a training step on code grids (the code-grid
cells), on the yardstick of ``benchmark/flops.py`` (its peaks and
``least_s``).

GPT-2's step is counted as ``flops.py`` counts steps: by
``FlopCounterMode`` over the plain reference (``reference/gpt2.py``) on the
meta device at the cell's shapes, forward and backward. The DeepSeek-V3
step's routed experts do as much work as the rows routed to them, which
only the run knows: :func:`deepseek_step` counts it by hand from the
configuration's shapes and the held experts' rows (the program's
counters), every matrix product of the forward, the input gradient and the
weight gradient (3x the forward's), two operations a multiply-add; a CPU
test holds it to ``FlopCounterMode`` over the reference.
"""

from __future__ import annotations

import functools
import json

import torch

from . import flops
from .reference import codes_steps as ref


def _params(module) -> int:
    return sum(p.numel() for p in module.parameters())


@functools.lru_cache(maxsize=None)
def _gpt2_step(cfg_key: str, b: int, t: int) -> tuple[int, int]:
    cfg = json.loads(cfg_key)
    model = ref.build(ref.factory(cfg), "meta")
    tok = torch.zeros((b, t), dtype=torch.long, device="meta")

    def step():
        loss = ref.g2.next_token_ce(model(tok), tok)
        torch.autograd.grad(loss, list(model.parameters()))

    # AdamW: the weights and both moments read and written, the gradient read; the tokens
    return flops.counted(step), 28 * _params(model) + 4 * b * t


def gpt2_step(cfg: dict, b: int, t: int) -> tuple[int, int]:
    """One GPT-2 step on b sequences of t tokens: (operations, bytes)."""
    return _gpt2_step(json.dumps(cfg, sort_keys=True), b, t)


def deepseek_forward_macs(cfg: dict, t: int) -> tuple[int, int]:
    """Multiply-adds of one token's forward outside the routed experts, and
    of one row through one routed expert."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope, pe, v = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    mla = d * h * (nope + pe) + d * (r + pe) + r * h * (nope + v) + h * v * d + h * t * (nope + pe + v)
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["router_experts"] + 3 * d * cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    layers, first = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    token = layers * mla + first * dense + (layers - first) * moe + d * cfg["vocab_size"]
    return token, 3 * d * cfg["moe_intermediate_size"]


def deepseek_step(cfg: dict, b: int, t: int, expert_rows: int) -> tuple[int, int]:
    """One DeepSeek-V3 step on b sequences of t tokens whose MoE layers
    routed ``expert_rows`` rows in all to the held experts: (operations,
    bytes), the bytes AdamW's over the held parameters and the tokens."""
    token, row = deepseek_forward_macs(cfg, t)
    params = _params(ref.build(ref.factory(cfg), "meta"))
    return 3 * 2 * (b * t * token + expert_rows * row), 28 * params + 4 * b * t
