"""Driver ``train_vqgan``: the VQGAN tokenizer's GAN-on training step,
steps back to back.

Each step takes one item of the traffic (B uint8 images, staged on the
device two ahead, mapped to [-1, 1] there); the step is the program's
``VQGANAlgorithm.train_step`` with the state at ``start_step`` (past
``discriminator_start``): encode, the nearest-code kernel, decode, L1 +
LPIPS, the PatchGAN's logits and the adaptive weight (two gradients at
the decoder's last conv), the generator's Adam step, the codebook's
re-normalisation, then the discriminator's hinge loss on the detached
reconstruction and the real images and its Adam step. No step waits for
the device; the losses are read once the window has closed.

Set-up builds the algorithm once, loads the seeded weights (generator,
discriminator, LPIPS) and drives it through ``check_steps`` steps with the
window's own call and feed; the reference follows those steps after the
window, from the same weights and items.
"""

from __future__ import annotations

import torch

from benchmark import compare, loop, traffic as tf, weights as wt
from benchmark.reference import steps as ref


def build(cell):
    import vector_quantization_tpu_torch.algorithms.vqgan  # noqa: F401  (registers the classes it builds)
    import vector_quantization_tpu_torch.models.autoencoders.vqgan  # noqa: F401
    import vector_quantization_tpu_torch.models.discriminators.patchgan  # noqa: F401
    import vector_quantization_tpu_torch.models.quantizers.vq  # noqa: F401
    import vector_quantization_tpu_torch.tasks.image_reconstruction  # noqa: F401
    from vector_quantization_tpu_torch.registries import AlgorithmRegistry

    algo = AlgorithmRegistry.build(dict(cell.config["algorithm"]), device=cell.device)
    w = ref.vqgan_weights(cell.config, cell.seed, cell.device)
    wt.load(algo.model, w, "g.")
    wt.load(algo.discriminator, w, "d.")
    wt.load(algo.lpips_module, w, "lpips.")
    return algo


def checks(program: dict, reference: dict) -> tuple[dict, dict]:
    """The numbers compared, from the first checked step (the later steps'
    readings go to standard error only: the GAN step is chaotic, and the
    order of the card's atomic sums makes the two sides part from the
    second step on), and what produced the widest of them."""
    codes_gaps = [compare.code_gap(f, e, c) for f, e, c in
                  zip(reference["feats"], reference["codebooks"], program["codes"])]
    grads = compare.leaf_gaps(program["grad_norms"], reference["grad_norms"])
    moved = compare.moved(reference["grad_norms"])
    first = compare.leaf_gaps(program["first_update_norms"], reference["first_update_norms"], moved)
    updates = compare.leaf_gaps(program["update_norms"], reference["update_norms"], moved)
    return ({"code_gap": codes_gaps[0] if codes_gaps else float("inf"),
             "loss_gap": max(compare.loss_gap(program["losses"][:1], reference["losses"][:1]),
                             compare.loss_gap(program["d_losses"][:1], reference["d_losses"][:1])),
             "grad_gap": max(grads.values()), "update_gap": max(first.values())},
            {"code_gaps by step": " ".join(f"{g:.3g}" for g in codes_gaps),
             "losses": f"program {program['losses']} reference {reference['losses']}",
             "d_losses": f"program {program['d_losses']} reference {reference['d_losses']}",
             "loss_gap over the steps": f"{max(compare.loss_gap(program['losses'], reference['losses']), compare.loss_gap(program['d_losses'], reference['d_losses'])):.3g}",
             "update_gap over the steps": f"{max(updates.values()):.3g}",
             "grad": compare.worst(grads), "first update": compare.worst(first)})


def _norms(prefix: str, names: list, tensors) -> dict:
    return {prefix + n: float(v) for n, v in zip(names, torch.stack(tensors).tolist())}


def run(cell) -> dict:
    dev, cfg, n_check = cell.device, cell.config, int(cell.workload["check_steps"])
    cell.mark("imports")
    algo = build(cell)
    cell.mark("program and weights")
    state = algo.init_state(wt.derive(cell.seed, "state"))
    state.step = int(cfg["start_step"])
    pool = tf.make_pool(cell.traffic, cell.seed, cell.seconds, pin=dev.type == "cuda")
    feed = tf.Feed(pool, dev)
    cell.mark("traffic")
    done, produced = [], []
    quantize = algo.model.quantize

    def quantize_logged(feat, train=False):
        out = quantize(feat, train=train)
        produced.append(out.codes)
        return out

    algo.model.quantize = quantize_logged

    def step():
        nonlocal state
        with cell.range("stage"):
            i, img, _ = feed.next()
            batch = {"image": tf.to_pixels(img)}
        with cell.range("step"):
            state, m = algo.train_step(state, batch)
        done.append((i, produced.pop()))
        return m["loss"], m["d_loss"]

    g_names = [n for n, _ in algo.model.named_parameters()]
    d_names = [n for n, _ in algo.discriminator.named_parameters()]
    g_params, d_params = state.params(), list(algo.discriminator.parameters())
    g0 = [p.detach().clone() for p in g_params]
    d0 = [p.detach().clone() for p in d_params]
    def changes():
        return {**_norms("g.", g_names, torch._foreach_norm(torch._foreach_sub(g_params, g0))),
                **_norms("d.", d_names, torch._foreach_norm(torch._foreach_sub(d_params, d0)))}

    losses, grads = [], {}
    for s in range(n_check):
        losses.append(step())
        if s == 0:
            grads = {**_norms("g.", g_names, [t / (1.0 - algo.tx().b1) for t in torch._foreach_norm(state.opt_state["mu"])]),
                     **_norms("d.", d_names, [t / (1.0 - algo.d_tx().b1) for t in torch._foreach_norm(state.d_opt_state["mu"])])}
            first = changes()
    updates = changes()
    del g0, d0
    setup_s = loop.start(cell)
    cell.mark("checked steps")

    window_losses, window_s, trace = loop.window(cell, step)

    peak = loop.peak_bytes(dev)
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack([torch.stack(x) for x in window_losses]).float())).any(dim=1).sum())
    program = {"losses": [float(g) for g, _ in losses], "d_losses": [float(d) for _, d in losses],
               "grad_norms": grads, "update_norms": updates, "first_update_norms": first,
               "codes": [c.cpu() for _, c in done[:n_check]]}
    items = [(pool.images[i], pool.labels[i]) for i, _ in done[:n_check]]
    del algo, state, feed, g_params, d_params, window_losses, done, produced
    loop.release(dev)

    reference = ref.vqgan_run(cfg, cell.seed, dev, items)
    b = int(cell.traffic["batch"])
    return {"setup_s": setup_s, "window_s": window_s, "trace": trace, "memory_peak_bytes": peak,
            "attempted": steps, "failed": failed,
            "counters": {"steps": steps, "images": steps * b, "peak_bytes": peak},
            **dict(zip(("checks", "detail"), checks(program, reference)))}
