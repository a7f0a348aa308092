"""The reference's side of the code-grid cells: the same seeded weights and
the same items as the program's run, trained again by the plain modules.

An item is B code grids and B labels: [class | codes + classes] -> the
prior -> next-token CE (+ the MoE's balance loss) -> AdamW with the
global-norm clip, for the checked steps. :func:`run` trains the
configuration's prior: GPT-2 (``reference/gpt2.py``) or DeepSeek-V3
(``reference/deepseek_v3.py``), which also follows the program's routes
within ``tol`` and moves its balancing bias after each step.
``tf32=True`` computes in TF32 (the check's control); ``half=True`` leaves
half of each batch out (one of the faults the check has to catch).
"""

from __future__ import annotations

import torch

from .. import weights as wt
from . import deepseek_v3 as ds
from . import gpt2 as g2
from .optim import Adam


def build(factory, device, weights: dict | None = None, prefix: str = ""):
    """A reference module made on the meta device, then on ``device`` with
    ``weights`` (or with empty parameters, for counting). Its buffers
    (the balancing biases) start at zero."""
    with torch.device("meta"):
        m = factory()
    if str(device) == "meta":
        return m
    m = m.to_empty(device=device)
    for b in m.buffers():
        b.zero_()
    if weights is not None:
        wt.load(m, weights, prefix)
    return m


def is_deepseek(cfg: dict) -> bool:
    return cfg.get("model_type") == "deepseek_v3"


def factory(cfg: dict):
    """The configuration's reference prior, unbuilt."""
    if is_deepseek(cfg):
        return lambda: ds.DeepseekV3(cfg)
    return lambda: g2.GPT2(cfg["vocab_size"], cfg["n_embd"], cfg["n_layer"], cfg["n_head"], cfg["n_positions"])


def prefix(cfg: dict) -> str:
    return "deepseek." if is_deepseek(cfg) else "gpt2."


def rule(cfg: dict):
    r, n = (ds.init_rule, len("deepseek.")) if is_deepseek(cfg) else (g2.init_rule, len("gpt2."))
    return lambda name, shape: r(name[n:], shape)


def shapes(cfg: dict) -> list:
    return wt.leaves(build(factory(cfg), "meta"), prefix(cfg))


def weights(cfg: dict, seed: int, device) -> dict:
    """The prior's seeded weights, under ``gpt2.`` or ``deepseek.``."""
    return wt.make(shapes(cfg), rule(cfg), seed, device)


def tokens(codes, labels, num_categories: int):
    return g2.c2i_tokens(labels, codes, num_categories)


def run(cfg: dict, seed: int, device, items, routes=None, tol: float = 0.0, force: bool = False,
        tf32: bool = False, half: bool = False) -> dict:
    """``items``: the checked steps' (codes (B, h, w), labels (B,)), in
    order; ``routes``: for the DeepSeek prior, the program's chosen experts
    of each step and MoE layer. Returns each step's loss, each leaf's
    gradient norm as the first step's moments took it, each leaf's change
    over all the steps; for the DeepSeek prior also each MoE layer's bias
    after the steps, the routes taken and the widest ``route_gap``."""
    w = weights(cfg, seed, device)
    model = build(factory(cfg), device, w, prefix(cfg))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = cfg["optimizer"]
    adam = Adam(params, opt["lr"], opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["grad_clip"])
    losses, grad_norms, taken_routes, route_gap = [], None, [], 0.0
    deep = is_deepseek(cfg)
    with ds.precision(tf32):
        for s, (codes, labels) in enumerate(items):
            tok = tokens(codes.to(device), labels.to(device), cfg["num_categories"])
            if half:
                tok = tok[: tok.shape[0] // 2]
            if deep:
                step_routes = None if routes is None else routes[s]
                logits, aux = model(tok, step_routes, tol, force)
                loss = ds.next_token_ce(logits, tok) + aux["balance"]
                taken_routes.append([r.to(torch.uint8) for r in aux["routes"]])
                route_gap = max(route_gap, aux["route_gap"])
            else:
                loss = g2.next_token_ce(model(tok), tok)
            # a held expert no token chose takes a zero gradient
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
            taken = adam.step(grads)
            if deep:
                model.after_step(aux["loads"])
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {n: float(g.norm()) for n, g in zip(names, taken)}
            del grads, taken, loss
    pre = prefix(cfg)
    out = {"losses": losses, "grad_norms": grad_norms,
           "update_norms": {n: float((p.detach() - w[pre + n]).norm()) for n, p in zip(names, params)}}
    if deep:
        out.update(bias=[m.gate.e_score_correction_bias.detach().cpu() for m in model.moe_layers()],
                   routes=taken_routes, route_gap=route_gap)
    return out
