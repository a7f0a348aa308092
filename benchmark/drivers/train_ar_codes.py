"""Driver ``train_ar_codes``: class-conditional AR training on pre-exported
code grids, steps back to back.

Each step takes one item of a code-grid traffic (``benchmark/codes.py``: B
grids of codes and B labels), staged on the device two ahead; the step is
the program's ``ARAlgorithm.train_step`` on ``{"codes", "category"}``, so
the tokenizer is skipped: [class | codes], the prior's forward, the
next-token CE (+ the MoE's balance loss), its gradients, AdamW and, for the
DeepSeek-V3 prior, the balancing bias's move. The prior is the
configuration's ``algorithm.transformer``: GPT-2 or DeepSeek-V3. No step
waits for the device; the losses are read once the window has closed.

Set-up builds the algorithm once, loads the seeded weights into it and
drives it through ``check_steps`` steps with the window's own call and
feed, on the first items: they warm every shape the window uses (every
group of rows of an expert is a new shape only to the host), and the
reference follows them. After the window the program is freed and the
reference trains those steps again from the same weights and items.

Checked: ``token_gap``, the tokens of every step of the run that differ
from the items' [class | codes] (0: the step trained on what it was fed);
``loss_gap``, ``grad_gap``, ``update_gap`` as ``train_ar`` checks them;
for DeepSeek-V3 ``route_gap`` (the router's choices of each checked step
and MoE layer, logged where the program makes them, against the
reference's float64 scores: how far a chosen expert's biased score fell
below the reference's 6th) and ``bias_gap`` (each layer's balancing bias
after the checked steps, in units of its step ``bias_gamma``).
"""

from __future__ import annotations

import copy
import importlib

import torch

from benchmark import codes as cd
from benchmark import compare, loop, spans, trace as tr, traffic as tf, weights as wt
from benchmark.reference import codes_steps as ref

# the program's module of each prior, imported for its registration
PRIORS = {"GPT2Transformer": "gpt2", "DeepseekV3Transformer": "deepseek_v3"}
# the step's phases (vq. spans of algorithms/ar.py); the DeepSeek prior's own spans
PHASES = ("vq.ar.tokens", "vq.ar.forward", "vq.backward", "vq.optimizer", "vq.ar.after_step")
MOE_SPANS = ("vq.mla", "vq.moe.route", "vq.moe.balance", "vq.moe.dispatch", "vq.moe.experts", "vq.moe.combine",
             "vq.moe.shared")
# its backward ranges (utils/debug.py BackwardRange), on autograd's thread
MOE_BACKWARD = ("mla.backward", "moe.backward", "moe.experts.backward", "moe.shared.backward")


def build(cell):
    import vector_quantization_tpu_torch.algorithms.ar  # noqa: F401  (registers the classes it builds)
    import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: F401
    import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: F401
    import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: F401
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry

    kind = cell.config["algorithm"]["transformer"]["type"]
    importlib.import_module(f"vector_quantization_tpu_torch.models.transformers.{PRIORS[kind]}")
    algo = AlgorithmRegistry.build(dict(cell.config["algorithm"]), device=cell.device)
    w = ref.weights(cell.config, cell.seed, cell.device)
    wt.load(algo.model, w, ref.prefix(cell.config))
    return algo


def checks(program: dict, reference: dict, cfg: dict) -> tuple[dict, dict]:
    """The numbers compared, and what produced the widest of them."""
    grads = compare.leaf_gaps(program["grad_norms"], reference["grad_norms"])
    updates = compare.leaf_gaps(program["update_norms"], reference["update_norms"],
                                compare.moved(reference["grad_norms"]))
    out = {"token_gap": float(program["token_gap"]),
           "loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
           "grad_gap": max(grads.values()), "update_gap": max(updates.values())}
    detail = {"losses": f"program {program['losses']} reference {reference['losses']}",
              "grad": compare.worst(grads), "update": compare.worst(updates)}
    if ref.is_deepseek(cfg):
        out["route_gap"] = float(reference["route_gap"])
        gaps = [float((p - r).abs().max()) / cfg["bias_gamma"] if p.shape == r.shape else float("inf")
                for p, r in zip(program["bias"], reference["bias"])]
        out["bias_gap"] = max(gaps, default=float("inf")) if len(gaps) == len(reference["bias"]) else float("inf")
        detail["bias"] = " ".join(f"{g:.3g}" for g in gaps)
    return out, detail


def token_gap(done: list, pool, num_categories: int) -> int:
    """Tokens of the run's steps that differ from their items' [class | codes]
    (all of a step's where its shape differs)."""
    gap = 0
    for i, got in done:
        want = ref.tokens(pool.images[i], pool.labels[i], num_categories)
        got = got.cpu()
        gap += int((got.long() != want).sum()) if got.shape == want.shape else want.numel()
    return gap


def moe_counters(before: dict, after: dict) -> dict:
    """The DeepSeek prior's counters over the window."""
    rows = [[a - b for a, b in zip(ra, rb)] for ra, rb in zip(after["expert_rows"], before["expert_rows"])]
    return {"expert_rows": rows, **{k: after[k] - before[k] for k in ("kernel_products", "plain_products",
                                                                      "count_reads")}}


def phases(run_trace, steps: int) -> dict:
    """For the run's standard error: each phase's and each of the DeepSeek
    prior's spans' device ms a step (forward launches) and its backward
    ranges', and the share of busy time the phases cover."""
    chain = spans.chains(run_trace)
    per, union = {}, []
    for name in PHASES + MOE_SPANS + MOE_BACKWARD:
        ops = tr.ops_under(run_trace, (name,)) if name in MOE_BACKWARD else spans.ops_in(run_trace, name, chain)
        if ops:
            per[name] = tr.union_us([(a, b) for _, a, b in ops]) * 1e-3 / max(steps, 1)
            if name in PHASES:
                union += [(a, b) for _, a, b in ops]
    busy = tr.busy_us(run_trace)
    cover = 100.0 * tr.union_us(union) / busy if busy else 0.0
    return {"phases": ", ".join(f"{k} {v:.3f}" for k, v in per.items()) + f"; cover {cover:.4f}% of busy"}


def run(cell) -> dict:
    dev, cfg, n_check = cell.device, cell.config, int(cell.workload["check_steps"])
    cell.mark("imports")
    algo = build(cell)
    cell.mark("program and weights")
    state = algo.init_state(wt.derive(cell.seed, "state"))
    pool = cd.make_pool(cell.traffic, cell.seed, cell.seconds, pin=dev.type == "cuda")
    feed = tf.Feed(pool, dev)
    cell.mark("traffic")
    deep = ref.is_deepseek(cfg)
    model = algo.model

    tokens_of, fed = algo._tokens, []

    def tokens_logged(state, batch, train):
        t = tokens_of(state, batch, train)
        fed.append(t)
        return t

    algo._tokens = tokens_logged
    routes, step_routes, logging = [], [], [True]  # the checked steps' routes, logged in set-up only
    if deep:
        for moe in model.moe_layers():
            def routed(x, _route=moe.route):
                out = _route(x)
                if logging[0]:
                    step_routes.append(out[0].to(torch.uint8))
                return out

            moe.route = routed
    done = []  # (pool index, the tokens the step trained on) of every step

    def step():
        nonlocal state
        with cell.range("stage"):
            i, codes, lab = feed.next()
        with cell.range("step"):
            state, m = algo.train_step(state, {"codes": codes, "category": lab})
        done.append((i, fed.pop()))
        if logging[0]:
            routes.append(list(step_routes))
            step_routes.clear()
        return m["loss"]

    names = [n for n, _ in model.named_parameters()]
    params = state.params()
    p0 = [p.detach().clone() for p in params]
    losses, grad_norms = [], None
    for s in range(n_check):
        losses.append(step())
        if s == 0:
            grad_norms = torch.stack(torch._foreach_norm(state.opt_state["mu"])) / (1.0 - algo.tx().b1)
    update_norms = torch.stack(torch._foreach_norm(torch._foreach_sub(params, p0)))
    del p0
    bias = [m.gate.e_score_correction_bias.detach().clone().cpu() for m in model.moe_layers()] if deep else []
    before = copy.deepcopy(model.counters) if deep else None
    logging[0] = False
    setup_s = loop.start(cell)
    cell.mark("checked steps")

    window_losses, window_s, trace = loop.window(cell, step)

    peak = loop.peak_bytes(dev)
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    counters = {"steps": steps, "tokens": steps * int(cell.traffic["batch"]) * (1 + int(cell.traffic["grid"]) ** 2),
                "peak_bytes": peak}
    if deep:
        counters.update(moe_counters(before, model.counters))
    program = {"losses": [float(x) for x in losses], "grad_norms": dict(zip(names, grad_norms.tolist())),
               "update_norms": dict(zip(names, update_norms.tolist())), "bias": bias,
               "token_gap": token_gap(done, pool, cfg["num_categories"])}
    items = [(pool.images[i], pool.labels[i]) for i, _ in done[:n_check]]
    checked_routes = routes if deep else None
    del algo, state, feed, model, params, window_losses, done
    loop.release(dev)

    limit = float(cell.workload["limits"].get("route_gap", 0.0))
    reference = ref.run(cfg, cell.seed, dev, items, checked_routes, tol=limit)
    detail = phases(trace, steps) if trace is not None and trace.ops else {}
    if deep:
        rows = [r for layer in counters["expert_rows"] for r in layer]
        detail["experts"] = (f"rows a step per held expert and layer {[round(r / max(steps, 1)) for r in rows]}; "
                             f"a step: kernel products {counters['kernel_products'] / max(steps, 1):g}, "
                             f"torch.matmul {counters['plain_products'] / max(steps, 1):g}, "
                             f"host reads {counters['count_reads'] / max(steps, 1):g}")
    got, why = checks(program, reference, cfg)
    return {"setup_s": setup_s, "window_s": window_s, "trace": trace, "memory_peak_bytes": peak,
            "attempted": steps, "failed": failed, "counters": counters, "checks": got, "detail": {**why, **detail}}
