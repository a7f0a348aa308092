"""DeepSeek-V3's decoder as the class-conditional prior, plain PyTorch, float32.

DeepSeek-V2 (arXiv:2405.04434) section 2.1 and DeepSeek-V3 (arXiv:2412.19437)
section 2.1, at the widths of HF ``moonshotai/Moonlight-16B-A3B``
(``model_type`` ``deepseek_v3``): pre-norm layers (RMSNorm eps 1e-5); latent
attention without ``q_lora`` (``q_proj``; ``kv_a_proj_with_mqa`` into the
latent and the shared RoPE key; ``kv_a_layernorm``; ``kv_b_proj`` into the
heads' keys and values; RoPE of theta 50,000 on the 64 decoupled
dimensions; softmax at 1/sqrt(192); ``o_proj``); a dense SwiGLU in the
first layer, then the MoE: a sigmoid router over all experts, the top 6 of
the scores plus ``e_score_correction_bias``, weights the chosen scores over
their sum times 2.446, each held expert a SwiGLU, plus the shared experts;
a final RMSNorm and an untied head. Every matrix product is ``@`` (TF32
off where :func:`precision` is used); the experts are a loop over the held
experts; no cache, no batching of experts.

Departures from the published model, as the repository's C2I recipe and
the benchmark's cut train it:

- the vocabulary is 1000 classes + 16384 image codes and the sequence is
  [class | 256 codes] (257 positions);
- a layer holds the experts ``[r * held, (r + 1) * held)`` of its rank r
  and adds only theirs (one rank of eight-way expert parallelism): the
  router still scores all 64; holding fewer than all, the router takes no
  gradient through the weights of the experts' outputs (only through the
  balance loss), since the rank's own part of that gradient alone would
  teach it to avoid the held experts;
- RoPE in HF ``modeling_deepseek.apply_rotary_pos_emb``'s layout (each
  vector's pairs de-interleaved, then rotate-half); the causal mask is
  additive -1e9 (not ``-inf``);
- the balance loss (``alpha sum_i f_i P_i`` per sequence, averaged over
  sequences) is summed over the MoE layers; the bias moves after each
  optimizer step by ``gamma sign(mean load - load_i)`` over the step's
  whole batch;
- the router may be told which experts to take (``routes``): where the
  program's choice is within ``tol`` of the reference's own in float64
  (a near tie its rounding settled), the reference follows it, and it
  reports by how much the program's choice fell short (``route_gap``).

Names follow HF's ``modeling_deepseek`` without its ``model.`` prefix, so
one seeded state dict loads into the program and the reference alike.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

NEG_MASK = -1e9


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off (the configuration's), or TF32 (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Linear(nn.Module):
    def __init__(self, fin: int, fout: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fout, fin))

    def forward(self, x):
        return x @ self.weight.t()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


class MLP(nn.Module):
    def __init__(self, dim: int, width: int) -> None:
        super().__init__()
        self.gate_proj = Linear(dim, width)
        self.up_proj = Linear(dim, width)
        self.down_proj = Linear(width, dim)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def rope(x, t: int, theta: float):
    """x (B, T, H, d) at positions 0..T-1, HF's layout."""
    b, _, h, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=x.device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    x = x.reshape(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1) * sin


class MLA(nn.Module):
    def __init__(self, c: dict) -> None:
        super().__init__()
        d, h = c["hidden_size"], c["num_attention_heads"]
        self.h, self.r = h, c["kv_lora_rank"]
        self.nope, self.pe, self.v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        self.theta = c["rope_theta"]
        self.q_proj = Linear(d, h * (self.nope + self.pe))
        self.kv_a_proj_with_mqa = Linear(d, self.r + self.pe)
        self.kv_a_layernorm = RMSNorm(self.r, c["rms_norm_eps"])
        self.kv_b_proj = Linear(self.r, h * (self.nope + self.v))
        self.o_proj = Linear(h * self.v, d)

    def forward(self, x):
        b, t, _ = x.shape
        q = self.q_proj(x).reshape(b, t, self.h, self.nope + self.pe)
        q_nope, q_pe = q.split([self.nope, self.pe], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.r, self.pe], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).reshape(b, t, self.h, self.nope + self.v)
        k_nope, v = kv.split([self.nope, self.v], dim=-1)
        q = torch.cat([q_nope, rope(q_pe, t, self.theta)], dim=-1)
        k = torch.cat([k_nope, rope(k_pe.reshape(b, t, 1, self.pe), t, self.theta).expand(b, t, self.h, self.pe)],
                      dim=-1)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / (self.nope + self.pe) ** 0.5
        i = torch.arange(t, device=x.device)
        probs = torch.softmax(scores + torch.where(i[None, :] <= i[:, None], 0.0, NEG_MASK), dim=-1)
        return self.o_proj(torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, self.h * self.v))


class Gate(nn.Module):
    def __init__(self, dim: int, experts: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(experts, dim))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))


class MoE(nn.Module):
    def __init__(self, c: dict, held: range) -> None:
        super().__init__()
        d, width = c["hidden_size"], c["moe_intermediate_size"]
        self.k, self.e = c["num_experts_per_tok"], c["router_experts"]
        self.scale, self.alpha, self.held = c["routed_scaling_factor"], c["balance_alpha"], held
        self.gate = Gate(d, self.e)
        self.experts = nn.ModuleDict({str(e): MLP(d, width) for e in held})
        self.shared_experts = MLP(d, width * c["n_shared_experts"])

    def choose(self, x, s, program, tol: float, force: bool):
        """The experts each row takes and by how much the program's choice
        fell short of the reference's own (float64 scores; 0 where they
        agree)."""
        b = self.gate.e_score_correction_bias
        if program is None:
            return torch.topk(s.detach() + b, self.k, dim=-1).indices, 0.0
        program = program.to(x.device).long()
        if force:
            return program, 0.0
        own = torch.topk(s.detach() + b, self.k, dim=-1).indices
        if (program.shape != own.shape or int(program.min()) < 0 or int(program.max()) >= self.e
                or not bool(program.sort(-1).values.diff(dim=-1).ne(0).all())):
            return own, float("inf")
        s64 = torch.sigmoid(x.detach().double() @ self.gate.weight.detach().double().t()) + b.double()
        kth = torch.topk(s64, self.k, dim=-1).values[:, -1:]
        short = (kth - s64.gather(1, program)).clamp(min=0).amax(-1)
        take = torch.where((short <= tol)[:, None], program, own)
        return take, float(short.max())

    def forward(self, x, program=None, tol: float = 0.0, force: bool = False):
        bsz, t, d = x.shape
        flat = x.reshape(-1, d)
        s = torch.sigmoid(flat @ self.gate.weight.t())
        idx, gap = self.choose(flat, s, program, tol, force)
        w = s.gather(1, idx)
        if len(self.held) < self.e:
            w = w.detach()
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * self.scale
        y = torch.zeros_like(flat)
        for e in self.held:
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                y = y.index_add(0, tok, w[tok, slot, None] * self.experts[str(e)](flat[tok]))
        y = y + self.shared_experts(flat)
        chosen = torch.zeros((bsz, self.e), device=x.device).scatter_add_(
            1, idx.reshape(bsz, -1), torch.ones((bsz, t * self.k), device=x.device))
        p = (s / s.sum(-1, keepdim=True)).reshape(bsz, t, -1).mean(1)
        balance = self.alpha * (chosen * (self.e / (self.k * t)) * p).sum(-1).mean()
        return y.reshape(bsz, t, d), balance, torch.bincount(idx.reshape(-1), minlength=self.e), idx, gap


class Layer(nn.Module):
    def __init__(self, c: dict, moe: bool, held: range) -> None:
        super().__init__()
        d, eps = c["hidden_size"], c["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = MoE(c, held) if moe else MLP(d, c["intermediate_size"])


class DeepseekV3(nn.Module):
    """``c``: the configuration's keys (HF's names), with ``router_experts``
    (the router's outputs), ``n_routed_experts`` (the experts held here),
    ``expert_rank``, ``balance_alpha`` and ``bias_gamma``."""

    def __init__(self, c: dict) -> None:
        super().__init__()
        held = c["n_routed_experts"]
        self.held = range(c["expert_rank"] * held, (c["expert_rank"] + 1) * held)
        self.gamma = c["bias_gamma"]
        self.embed_tokens = nn.Embedding(c["vocab_size"], c["hidden_size"])
        self.layers = nn.ModuleList(Layer(c, i >= c["first_k_dense_replace"], self.held)
                                    for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.lm_head = Linear(c["hidden_size"], c["vocab_size"])

    def forward(self, tokens, routes=None, tol: float = 0.0, force: bool = False):
        """tokens (B, T) -> (logits (B, T, V), {"balance", "loads", "routes",
        "route_gap"}); ``routes``: the program's chosen experts of each MoE
        layer (N, K), or None."""
        h = self.embed_tokens(tokens.long())
        balance, loads, chosen, gaps = h.new_zeros(()), [], [], []
        for layer in self.layers:
            h = h + layer.self_attn(layer.input_layernorm(h))
            x = layer.post_attention_layernorm(h)
            if isinstance(layer.mlp, MoE):
                program = None if routes is None else routes[len(chosen)]
                y, bal, load, idx, gap = layer.mlp(x, program, tol, force)
                balance, loads, chosen, gaps = balance + bal, loads + [load], chosen + [idx], gaps + [gap]
            else:
                y = layer.mlp(x)
            h = h + y
        logits = self.lm_head(self.norm(h))
        return logits, {"balance": balance, "loads": loads, "routes": chosen, "route_gap": max(gaps, default=0.0)}

    def moe_layers(self) -> list:
        return [layer.mlp for layer in self.layers if isinstance(layer.mlp, MoE)]

    @torch.no_grad()
    def after_step(self, loads) -> None:
        for moe, load in zip(self.moe_layers(), loads):
            load = load.float()
            moe.gate.e_score_correction_bias.add_(torch.sign(load.mean() - load), alpha=self.gamma)


def init_rule(name: str, shape) -> tuple:
    """N(0, 0.02) for every matrix (projections, router, embedding, head),
    1 for the norms' weights."""
    return ("normal", 0.02) if len(shape) > 1 else ("ones",)


def next_token_ce(logits, tokens):
    """Teacher-forced cross entropy of tokens[:, 1:], mean over positions."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()
