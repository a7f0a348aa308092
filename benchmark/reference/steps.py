"""The reference's side of each check: the same seeded weights and the same
items as the program's run, computed again by the plain modules.

``ar_run`` follows the AR training step (frozen tokenizer -> codes ->
[class | codes] -> GPT-2 -> next-token CE -> AdamW) for the checked steps;
``encode`` gives each image's normalised features and the normalised
codebook, from which :mod:`benchmark.compare` judges the program's codes;
``vqgan_run`` follows the VQGAN's GAN-on training step. ``tf32=True``
computes them in TF32 (the check's control); ``half=True`` leaves half of
each batch out (one of the faults the check has to catch).
"""

from __future__ import annotations

import contextlib

import torch

from .. import weights as wt
from . import gpt2 as g2
from . import vqgan as vq
from .optim import Adam


@contextlib.contextmanager
def precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def to_pixels(u8):
    return u8.to(torch.float32) / 127.5 - 1.0


def autoencoder(ir: dict, decoder: bool) -> vq.Autoencoder:
    return vq.Autoencoder(ir["codebook_size"], ir["embedding_dim"], ir["width"], tuple(ir["enc_width_mults"]),
                          tuple(ir["dec_width_mults"]), ir["enc_depth"], ir["dec_depth"], decoder)


def gpt2(cfg: dict) -> g2.GPT2:
    return g2.GPT2(cfg["vocab_size"], cfg["n_embd"], cfg["n_layer"], cfg["n_head"], cfg["n_positions"])


def built(factory, device, weights=None, prefix=""):
    """A reference module made on the meta device, then on ``device`` with
    ``weights`` (or with empty parameters, for counting)."""
    with torch.device("meta"):
        m = factory()
    if device == "meta" or device == torch.device("meta"):
        return m
    m = m.to_empty(device=device)
    for mod in m.modules():  # non-persistent buffers are not in the weights
        if isinstance(mod, vq.LPIPS):
            mod.shift.copy_(torch.tensor((-0.030, -0.088, -0.188)).view(1, 3, 1, 1))
            mod.std.copy_(torch.tensor((0.458, 0.448, 0.450)).view(1, 3, 1, 1))
        if isinstance(mod, vq.BatchNorm):
            mod.mean.zero_()
            mod.var.fill_(1.0)
    if weights is not None:
        wt.load(m, weights, prefix)
    return m


# -- the AR step ---------------------------------------------------------------

def ar_shapes(cfg: dict) -> list:
    return (wt.leaves(built(lambda: gpt2(cfg), "meta"), "gpt2.")
            + wt.leaves(built(lambda: autoencoder(cfg["ir"], False), "meta"), "ir."))


def ar_rule(name: str, shape) -> tuple:
    return g2.init_rule(name[len("gpt2."):], shape) if name.startswith("gpt2.") else vq.fan_in_rule(name[3:], shape)


def ar_weights(cfg: dict, seed: int, device) -> dict:
    return wt.make(ar_shapes(cfg), ar_rule, seed, device)


def ar_loss(model, ae, image, labels, num_categories: int, half: bool = False):
    """The step's loss and the codes it trained on."""
    with torch.no_grad():
        codes = ae.encode_to_quant(image)
    tokens = g2.c2i_tokens(labels, codes, num_categories)
    if half:
        tokens = tokens[: tokens.shape[0] // 2]
    return g2.next_token_ce(model(tokens), tokens), codes


def ar_run(cfg: dict, seed: int, device, items, code_images=(), tf32: bool = False, half: bool = False) -> dict:
    """``items``: the checked steps' (uint8 images, labels), in order;
    ``code_images``: uint8 image batches whose codes are judged. Returns
    the losses, each leaf's gradient norm as the first step's moments took
    it, each leaf's change over all the steps, and for ``code_images`` the
    normalised features, their codes and the normalised codebook."""
    w = ar_weights(cfg, seed, device)
    model = built(lambda: gpt2(cfg), device, w, "gpt2.")
    ae = built(lambda: autoencoder(cfg["ir"], False), device, w, "ir.")
    ae.requires_grad_(False)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = cfg["optimizer"]
    adam = Adam(params, opt["lr"], opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["grad_clip"])
    losses, grad_norms = [], None
    with precision(tf32):
        e = vq.normalize(ae.quantizer.codebook)
        with torch.no_grad():
            feats = [ae.features(to_pixels(img.to(device))) for img in code_images]
            codes = [ae.quantizer.codes(f, e) for f in feats]
        for img, lab in items:
            loss, _ = ar_loss(model, ae, to_pixels(img.to(device)), lab.to(device), cfg["num_categories"], half)
            grads = torch.autograd.grad(loss, params)
            taken = adam.step(grads)
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {n: float(g.norm()) for n, g in zip(names, taken)}
            del grads, taken, loss
    updates = {n: float((p.detach() - w["gpt2." + n]).norm()) for n, p in zip(names, params)}
    return {"losses": losses, "grad_norms": grad_norms, "update_norms": updates,
            "feats": feats, "codes": codes, "codebook": e.detach()}


# -- the tokenizer's encode --------------------------------------------------------

def ir_weights(ir: dict, seed: int, device) -> dict:
    """The tokenizer's encoder and codebook alone, under ``ir.``."""
    shapes = wt.leaves(built(lambda: autoencoder(ir, False), "meta"), "ir.")
    return wt.make(shapes, lambda n, s: vq.fan_in_rule(n[3:], s), seed, device)


@torch.no_grad()
def encode(ir: dict, weights: dict, device, images, tf32: bool = False):
    """Normalised features (N·h·w, D) of each uint8 image batch, their
    codes (in TF32 with ``tf32``: the control's) and the normalised
    codebook."""
    ae = built(lambda: autoencoder(ir, False), device, weights, "ir.")
    e = vq.normalize(ae.quantizer.codebook)
    with precision(tf32):
        feats = [ae.features(to_pixels(img.to(device))) for img in images]
        codes = [ae.quantizer.codes(f, e) for f in feats]
    return feats, codes, e


# -- the VQGAN step -------------------------------------------------------------

def vqgan_shapes(cfg: dict) -> list:
    return (wt.leaves(built(lambda: autoencoder(cfg, True), "meta"), "g.")
            + wt.leaves(built(vq.PatchGAN, "meta"), "d.")
            + wt.leaves(built(vq.LPIPS, "meta"), "lpips."))


def vqgan_rule(name: str, shape) -> tuple:
    return vq.fan_in_rule(name.split(".", 1)[1], shape)


def vqgan_weights(cfg: dict, seed: int, device) -> dict:
    return wt.make(vqgan_shapes(cfg), vqgan_rule, seed, device)


def vqgan_losses(ae, disc, lpips, image, aglw_gain: float, half: bool = False):
    """The generation phase: the total loss, its parts, the codes and the
    reconstruction."""
    if half:
        image = image[: image.shape[0] // 2]
    pred, codes, q_loss = ae(image)
    r_loss = torch.mean(torch.abs(pred - image)) + lpips(pred, image)
    g_loss = torch.mean(-disc(pred, train=False))
    last = ae.decoder.backbone.proj_out.weight
    (r_grad,) = torch.autograd.grad(r_loss, last, retain_graph=True)
    (g_grad,) = torch.autograd.grad(g_loss, last, retain_graph=True)
    aglw = torch.clamp(r_grad.norm() / (g_grad.norm() + 1e-4), 0.0, 1e4).detach() * aglw_gain
    return q_loss + r_loss + g_loss * aglw, pred, codes


def vqgan_d_loss(disc, pred, image, half: bool = False):
    if half:
        image = image[: image.shape[0] // 2]
    return vq.hinge_d_loss(disc(pred.detach(), train=True), disc(image, train=True))


def vqgan_run(cfg: dict, seed: int, device, items, tf32: bool = False, half: bool = False) -> dict:
    """The checked GAN-on steps: each step's generator and discriminator
    losses, each leaf's first gradient norm and its change after the first
    step and over all the steps, for the generator (``g.``) and the
    discriminator (``d.``); each step's normalised features and codebook
    (before its update) and their codes."""
    w = vqgan_weights(cfg, seed, device)
    ae = built(lambda: autoencoder(cfg, True), device, w, "g.")
    disc = built(vq.PatchGAN, device, w, "d.")
    lpips = built(vq.LPIPS, device, w, "lpips.")
    lpips.requires_grad_(False)
    g_named, d_named = list(ae.named_parameters()), list(disc.named_parameters())
    g_params, d_params = [p for _, p in g_named], [p for _, p in d_named]
    opt, dopt = cfg["optimizer"], cfg["d_optimizer"]
    g_adam = Adam(g_params, opt["lr"], opt["b1"], opt["b2"], opt["eps"])
    d_adam = Adam(d_params, dopt["lr"], dopt["b1"], dopt["b2"], dopt["eps"])
    losses, d_losses, grad_norms, feats, books, codes = [], [], None, [], [], []

    def changes():
        return {**{"g." + n: float((p.detach() - w["g." + n]).norm()) for n, p in g_named},
                **{"d." + n: float((p.detach() - w["d." + n]).norm()) for n, p in d_named}}

    with precision(tf32):
        for img, _ in items:
            image = to_pixels(img.to(device))
            with torch.no_grad():
                feats.append(ae.features(image))
                books.append(vq.normalize(ae.quantizer.codebook).detach().clone())
                codes.append(ae.quantizer.codes(feats[-1], books[-1]))
            total, pred, _ = vqgan_losses(ae, disc, lpips, image, cfg["aglw_gain"], half)
            g_grads = torch.autograd.grad(total, g_params)
            g_taken = g_adam.step(g_grads)
            with torch.no_grad():
                ae.quantizer.codebook.copy_(vq.normalize(ae.quantizer.codebook))
            d_loss = vqgan_d_loss(disc, pred, image, half)
            d_taken = d_adam.step(torch.autograd.grad(d_loss, d_params))
            losses.append(float(total.detach()))
            d_losses.append(float(d_loss.detach()))
            if grad_norms is None:
                grad_norms = {**{"g." + n: float(g.norm()) for (n, _), g in zip(g_named, g_taken)},
                              **{"d." + n: float(g.norm()) for (n, _), g in zip(d_named, d_taken)}}
                first = changes()
            del total, pred, g_grads, g_taken, d_loss, d_taken
    return {"losses": losses, "d_losses": d_losses, "grad_norms": grad_norms, "update_norms": changes(),
            "first_update_norms": first, "feats": feats, "codebooks": books, "codes": codes}
