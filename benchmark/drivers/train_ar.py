"""Driver ``train_ar``: class-conditional AR training from images, steps
back to back.

Each step takes one item of the traffic (B uint8 images of 256 px and B
labels), staged on the device two ahead; the step is the program's
``ARAlgorithm.train_step``: the frozen tokenizer's ``encode_to_quant``
(encoder, then the nearest-code kernel) under ``no_grad``, [class | codes],
GPT-2's forward, the next-token CE, its gradients and AdamW. No step waits
for the device; the losses are read once the window has closed.

Set-up builds the algorithm once, loads the seeded weights into it, and
drives it through ``check_steps`` steps with the window's own call and
feed, on the first items: they warm every shape the window uses, and the
reference follows them. After the window the program is freed and the
reference runs those steps again from the same weights and items.
"""

from __future__ import annotations

import random

import torch

from benchmark import compare, loop, traffic as tf, weights as wt
from benchmark.reference import steps as ref


def build(cell):
    import vector_quantization_tpu_torch.algorithms.ar  # noqa: F401  (registers the classes it builds)
    import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: F401
    import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: F401
    import vector_quantization_tpu_torch.models.transformers.gpt2  # noqa: F401
    import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: F401
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry

    algo = AlgorithmRegistry.build(dict(cell.config["algorithm"]), device=cell.device)
    w = ref.ar_weights(cell.config, cell.seed, cell.device)
    wt.load(algo.model, w, "gpt2.")
    wt.load(algo.ir_model.encoder, w, "ir.encoder.")
    wt.load(algo.ir_model.quantizer, w, "ir.quantizer.")
    return algo


def checks(program: dict, reference: dict, codes: list) -> tuple[dict, dict]:
    """The numbers compared, and what produced the widest of them:
    ``codes`` are the program's, one per entry of the reference's ``feats``."""
    codes_gaps = [compare.code_gap(f, reference["codebook"], c) for f, c in zip(reference["feats"], codes)]
    grads = compare.leaf_gaps(program["grad_norms"], reference["grad_norms"])
    updates = compare.leaf_gaps(program["update_norms"], reference["update_norms"],
                                compare.moved(reference["grad_norms"]))
    return ({"code_gap": max(codes_gaps, default=float("inf")),
             "loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
             "grad_gap": max(grads.values()), "update_gap": max(updates.values())},
            {"code_gaps": " ".join(f"{g:.3g}" for g in codes_gaps),
             "losses": f"program {program['losses']} reference {reference['losses']}",
             "grad": compare.worst(grads), "update": compare.worst(updates)})


def run(cell) -> dict:
    dev, cfg, n_check = cell.device, cell.config, int(cell.workload["check_steps"])
    cell.mark("imports")
    algo = build(cell)
    cell.mark("program and weights")
    state = algo.init_state(wt.derive(cell.seed, "state"))
    pool = tf.make_pool(cell.traffic, cell.seed, cell.seconds, pin=dev.type == "cuda")
    feed = tf.Feed(pool, dev)
    cell.mark("traffic")
    encode, produced = algo.ir_model.encode_to_quant, []

    def encode_logged(x):
        codes = encode(x)
        produced.append(codes)
        return codes

    algo.ir_model.encode_to_quant = encode_logged
    done = []  # (pool index, codes) of every step

    def step():
        nonlocal state
        with cell.range("stage"):
            i, img, lab = feed.next()
            batch = {"image": tf.to_pixels(img), "category": lab}
        with cell.range("step"):
            state, m = algo.train_step(state, batch)
        done.append((i, produced.pop()))
        return m["loss"]

    names = [n for n, _ in algo.model.named_parameters()]
    params = state.params()
    p0 = [p.detach().clone() for p in params]
    losses, grad_norms = [], None
    for s in range(n_check):
        losses.append(step())
        if s == 0:
            grad_norms = torch.stack(torch._foreach_norm(state.opt_state["mu"])) / (1.0 - algo.tx().b1)
    update_norms = torch.stack(torch._foreach_norm(torch._foreach_sub(params, p0)))
    del p0
    setup_s = loop.start(cell)
    cell.mark("checked steps")

    window_losses, window_s, trace = loop.window(cell, step)

    peak = loop.peak_bytes(dev)
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    program = {"losses": [float(x) for x in losses],
               "grad_norms": dict(zip(names, grad_norms.tolist())),
               "update_norms": dict(zip(names, update_norms.tolist()))}
    sample = random.Random(wt.derive(cell.seed, "sample")).sample(
        range(n_check, len(done)), min(int(cell.workload["sampled_steps"]), len(done) - n_check))
    judged = [done[j] for j in list(range(n_check)) + sample]
    codes = [c.cpu() for _, c in judged]
    del algo, state, feed, done, produced, params, window_losses
    loop.release(dev)

    items = [(pool.images[i], pool.labels[i]) for i, _ in judged[:n_check]]
    reference = ref.ar_run(cfg, cell.seed, dev, items, [pool.images[i] for i, _ in judged])
    b = int(cell.traffic["batch"])
    t = 1 + (int(cell.traffic["image_size"]) // 2 ** (len(cfg["ir"]["enc_width_mults"]) - 1)) ** 2
    return {"setup_s": setup_s, "window_s": window_s, "trace": trace, "memory_peak_bytes": peak,
            "attempted": steps, "failed": failed,
            "counters": {"steps": steps, "images": steps * b, "tokens": steps * b * t, "peak_bytes": peak},
            **dict(zip(("checks", "detail"), checks(program, reference, codes)))}
