"""GPT-2 as the class-conditional prior, plain PyTorch, float32.

Radford et al., "Language Models are Unsupervised Multitask Learners"
(2019), HF ``gpt2-medium``: learned positions ``wpe``; pre-LN blocks
(LayerNorm eps 1e-5 -> fused q/k/v projection with bias -> causal
attention -> output projection; LayerNorm -> 4x MLP with GELU, tanh form);
a final LayerNorm; the head tied to the token embedding ``wte``.

Departures, as the repository's C2I recipe trains it: the attention mask
is additive -1e9 (not ``-inf``); dropout is absent; the vocabulary is
1000 classes + 16384 image codes; the sequence is [class | 256 codes].
Projection kernels are stored (in, out), as flax stores them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_MASK = -1e9


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class Dense(nn.Module):
    def __init__(self, fin: int, fout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class Block(nn.Module):
    def __init__(self, d: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(d)
        self.c_attn = Dense(d, 3 * d)
        self.c_proj = Dense(d, d)
        self.ln_2 = LayerNorm(d)
        self.mlp_fc = Dense(d, 4 * d)
        self.mlp_proj = Dense(4 * d, d)

    def forward(self, x, mask):
        b, t, d = x.shape
        h = self.heads
        q, k, v = (a.reshape(b, t, h, d // h) for a in self.c_attn(self.ln_1(x)).split(d, dim=-1))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d // h)
        probs = torch.softmax(scores + mask, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
        x = x + self.c_proj(attn)
        return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)), approximate="tanh"))


class GPT2(nn.Module):
    def __init__(self, vocabulary_size: int, hidden_size: int, num_layers: int, num_heads: int,
                 max_length: int) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.wte = nn.Parameter(torch.zeros(vocabulary_size, hidden_size))
        self.wpe = nn.Parameter(torch.zeros(max_length, hidden_size))
        for i in range(num_layers):
            self.add_module(f"h{i}", Block(hidden_size, num_heads))
        self.ln_f = LayerNorm(hidden_size)

    def forward(self, tokens):
        t = tokens.shape[1]
        i = torch.arange(t, device=tokens.device)
        mask = torch.where(i[None, :] <= i[:, None], 0.0, NEG_MASK)
        x = self.wte[tokens.long()] + self.wpe[:t][None]
        for j in range(self.num_layers):
            x = getattr(self, f"h{j}")(x, mask)
        return self.ln_f(x) @ self.wte.t()


def init_rule(name: str, shape) -> tuple:
    """How the seeded weights of a GPT-2 leaf are drawn (GPT-2's own init:
    N(0, 0.02) for kernels and embeddings, zero biases, unit scales)."""
    if name in ("wte", "wpe") or name.endswith(".kernel"):
        return ("normal", 0.02)
    if name.endswith(".scale"):
        return ("ones",)
    return ("zeros",)


def next_token_ce(logits, tokens):
    """Teacher-forced cross entropy of tokens[:, 1:], mean over positions."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()


def c2i_tokens(category, codes, num_categories: int):
    """[category | codes + num_categories] -> (B, 1 + h*w)."""
    codes = codes.reshape(codes.shape[0], -1).long() + num_categories
    return torch.cat([category[:, None].long(), codes], dim=1)
