"""DeepSeek-V3's decoder as the class-conditional AR prior: latent attention
(MLA) and a sigmoid-routed mixture of experts with shared experts, at
Moonlight-16B-A3B's widths by default (HF ``moonshotai/Moonlight-16B-A3B``,
``model_type`` ``deepseek_v3``; DeepSeek-V2 arXiv:2405.04434 section 2.1,
DeepSeek-V3 arXiv:2412.19437 section 2.1). New to the port: the JAX package
has no such model.

All tensors are f32; there are no biases; the head is not tied. With h the
residual stream (B, T, hidden):

- a layer: ``h += MLA(RMSNorm(h))``, then ``h += FFN(RMSNorm(h))``; the
  first ``first_k_dense_replace`` layers' FFN is a dense SwiGLU
  ``down(silu(gate(x)) * up(x))`` of width ``intermediate_size``, every
  later one the MoE; then a final RMSNorm and the head. RMSNorm:
  ``x * rsqrt(mean(x^2) + eps) * weight``;
- MLA without ``q_lora``: ``q = W_q x`` per head split into ``q_nope`` and
  ``q_pe``; ``[c, k_pe] = W_kva x``; ``[k_nope, v] = W_kvb RMSNorm(c)``;
  RoPE (theta ``rope_theta``) on ``q_pe`` and on the one ``k_pe`` all heads
  share, in HF ``modeling_deepseek.apply_rotary_pos_emb``'s layout (each
  vector's interleaved pairs de-interleaved, then rotate-half); causal
  softmax of ``[q_nope, q_pe] . [k_nope, k_pe]`` at 1/sqrt(nope + rope)
  (the einsum attention of ``llama.py``, additive -1e9 mask); ``o = W_o``;
- the router (``noaux_tc``, one group): ``s = sigmoid(x W_g^T)`` over all
  ``n_routed_experts``; the top ``num_experts_per_tok`` of ``s + b``, ``b``
  the buffer ``e_score_correction_bias``; weights ``s`` at the chosen
  experts over their sum + 1e-20, times ``routed_scaling_factor``;
- the MoE: ``y = sum over chosen, held experts of w_e expert_e(x) +
  shared(x)``, each expert a SwiGLU of width ``moe_intermediate_size`` and
  ``shared`` one of ``n_shared_experts`` times it. A layer holds
  ``experts_held`` experts, ``[r * held, (r + 1) * held)`` for its
  ``expert_rank`` r (all of them by default): it routes over all, computes
  its own experts' part for the tokens routed to them, and leaves out what
  experts held elsewhere add (one rank of expert parallelism, run without
  the exchange). Where it holds fewer than all, the router learns nothing
  from the experts' outputs (their weights are detached; it still learns
  from the balance loss): a rank sees only its own experts' part of that
  gradient, which, alone, teaches the router to avoid them (the held
  experts' rows fell from the deployment's 1/8 of the choices to 1/10-1/40
  of it within 60-120 training steps). No capacity limit: no token is
  dropped. Tokens are sorted
  by held expert (one read of the groups' rows on the host per layer, a
  copy behind an event that the shared experts' products hide; no other
  read), each group's products go through ``ops/f32_gemm.py``
  (``torch.matmul`` below its ``MIN_ROWS``; a group of no rows launches
  nothing), gate and up as one product of their stacked weights, and each
  group's output is weighted and scatter-added back;
- balance (arXiv:2412.19437 section 2.1.2): the sequence-wise loss
  ``alpha sum_i f_i P_i``, ``f_i = E / (K T) #{t : i chosen}``, ``P_i =
  mean_t s_it / sum_j s_jt``, averaged over sequences and summed over the
  MoE layers, joins the CE; after the optimizer, :meth:`after_step` moves
  ``b_i += gamma sign(mean load - load_i)`` by each layer's loads of the
  step over all experts (the buffer is outside the optimizer).

``forward(tokens, return_aux=True)`` gives ``(logits, aux)``: ``aux`` holds
the balance loss and each MoE layer's loads, which ``ARAlgorithm.train_step``
adds to the CE and hands to :meth:`after_step`. Generation through MLA's
latent cache is not ported: ``init_cache`` and ``forward`` with a cache
raise ``NotImplementedError``.

Spans (``utils/debug.py``): ``vq.mla``, ``vq.moe.route``, ``vq.moe.balance``
(also :meth:`after_step`), ``vq.moe.dispatch``, ``vq.moe.experts``,
``vq.moe.combine``, ``vq.moe.shared`` in the forward; the backward of MLA, of
each MoE layer, of its experts and of its shared experts under the ranges
``mla.backward``, ``moe.backward``, ``moe.experts.backward`` and
``moe.shared.backward`` (:class:`~..utils.debug.BackwardRange`). The
products open F1's ranges by what they are, in the forward and the
backward: ``mla.gemm``, ``ffn.gemm``, ``moe.router.gemm``,
``moe.expert.gemm``, ``moe.shared.gemm``, ``head.gemm``. ``counters``:
each held expert's rows per MoE layer, the experts' forward products (two a
group) by the kernel and by ``torch.matmul`` (the backward takes two of
the same kind for each) and the host reads of the counts.

Parameter names follow HF's ``modeling_deepseek`` without its ``model.``
prefix (``layers.{i}.self_attn.kv_b_proj.weight``,
``layers.{i}.mlp.experts.{e}.down_proj.weight`` by the expert's global
index, ``embed_tokens.weight``, ``lm_head.weight``); projection weights are
(out, in).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.f32_gemm import product, takes_kernel
from ...registries import TransformerRegistry
from ...utils.debug import BackwardRange, span
from .llama import _einsum_attention

__all__ = ["DeepseekV3Transformer", "rope_tables", "apply_rope"]


class _Linear(nn.Module):
    """``x @ weight.T``, weight (out, in), through F1 in the range ``name``."""

    def __init__(self, fin: int, fout: int, name: str) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.range = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return product(x, self.weight, transposed=True, name=self.range)


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


class _SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))``; gate and up as one product of the two
    weights stacked (two products where there were three: the launches an
    expert's group of rows costs the host)."""

    def __init__(self, dim: int, width: int, name: str) -> None:
        super().__init__()
        self.gate_proj = _Linear(dim, width, name)
        self.up_proj = _Linear(dim, width, name)
        self.down_proj = _Linear(width, dim, name)
        self.range = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.cat([self.gate_proj.weight, self.up_proj.weight])
        gate, up = product(x, stacked, transposed=True, name=self.range).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


def rope_tables(t: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (T, dim) as HF's ``DeepseekV3RotaryEmbedding`` makes them."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, d): HF ``apply_rotary_pos_emb``'s layout (pairs
    de-interleaved, then rotate-half)."""
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos[None, :, None] + rotated * sin[None, :, None]


class _MLA(nn.Module):
    def __init__(self, dim: int, heads: int, kv_rank: int, nope: int, rope: int, v_dim: int, eps: float) -> None:
        super().__init__()
        self.heads, self.kv_rank, self.nope, self.rope, self.v_dim = heads, kv_rank, nope, rope, v_dim
        self.q_proj = _Linear(dim, heads * (nope + rope), "mla.gemm")
        self.kv_a_proj_with_mqa = _Linear(dim, kv_rank + rope, "mla.gemm")
        self.kv_a_layernorm = _RMSNorm(kv_rank, eps)
        self.kv_b_proj = _Linear(kv_rank, heads * (nope + v_dim), "mla.gemm")
        self.o_proj = _Linear(heads * v_dim, dim, "mla.gemm")

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.heads
        q = self.q_proj(x).reshape(b, t, h, self.nope + self.rope)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.kv_rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).reshape(b, t, h, self.nope + self.v_dim)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.reshape(b, t, 1, self.rope), cos, sin).expand(b, t, h, self.rope)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        attn = _einsum_attention(q, k, v, torch.float32)
        return self.o_proj(attn.reshape(b, t, h * self.v_dim))


class _Router(nn.Module):
    """HF's ``MoEGate``: the router's weight and the balancing bias."""

    def __init__(self, dim: int, experts: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(experts, dim))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))


def new_counters(layers: int, held: int) -> dict:
    """What the MoE layers count: each held expert's rows per MoE layer, the
    experts' forward products (two a group) by the kernel and by
    ``torch.matmul``, the host reads of the counts."""
    return {"expert_rows": [[0] * held for _ in range(layers)], "kernel_products": 0, "plain_products": 0,
            "count_reads": 0}


class _MoE(nn.Module):
    def __init__(self, dim: int, width: int, experts: int, top_k: int, shared: int, held: range,
                 scaling: float, alpha: float, counters: dict, index: int) -> None:
        super().__init__()
        self.num_experts, self.top_k, self.held = experts, top_k, held
        self.scaling, self.alpha = scaling, alpha
        self.counters, self.index = counters, index
        self._counts_host = None  # pinned (held,) rows of the groups, on the card
        self.gate = _Router(dim, experts)
        self.experts = nn.ModuleDict({str(e): _SwiGLU(dim, width, "moe.expert.gemm") for e in held})
        self.shared_experts = _SwiGLU(dim, width * shared, "moe.shared.gemm")

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (N, dim) -> the chosen experts (N, K), their weights (N, K), the
        scores s (N, E)."""
        s = torch.sigmoid(product(x, self.gate.weight, transposed=True, name="moe.router.gemm"))
        idx = torch.topk(s.detach() + self.gate.e_score_correction_bias, self.top_k, dim=-1, sorted=False).indices
        return idx, self.weigh(s, idx), s

    def weigh(self, s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The chosen experts' weights: their scores over the scores' sum,
        times the scaling; detached where the layer holds part of the
        experts (module docstring)."""
        w = s.gather(1, idx)
        if len(self.held) < self.num_experts:
            w = w.detach()
        return w / (w.sum(-1, keepdim=True) + 1e-20) * self.scaling

    def balance(self, s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The sequence-wise balance loss of s (B, T, E) and the chosen idx (B, T, K)."""
        b, t, e = s.shape
        chosen = torch.zeros((b, e), device=s.device).scatter_add_(
            1, idx.reshape(b, -1), torch.ones((b, t * self.top_k), device=s.device))
        f = chosen * (e / (self.top_k * t))
        p = (s / s.sum(-1, keepdim=True)).mean(1)
        return self.alpha * (f * p).sum(-1).mean()

    def sort_choices(self, idx: torch.Tensor):
        """The choices of held experts grouped by expert in the held order
        (indices into the flattened (N, K) choices, the rest after them),
        and a function that returns the groups' rows on the host. On the
        card the rows are copied to pinned memory behind an event, so the
        host waits for that copy alone while the device runs on."""
        held = len(self.held)
        local = idx - self.held.start
        key = torch.where((local >= 0) & (local < held), local, held).reshape(-1)
        order = torch.sort(key, stable=True).indices
        counts = torch.zeros(held + 1, dtype=torch.long, device=key.device).scatter_add_(
            0, key, torch.ones_like(key))[:held]  # bincount would read its maximum on the host
        self.counters["count_reads"] += 1
        if not counts.is_cuda:
            return order, counts.tolist
        if self._counts_host is None:
            self._counts_host = torch.empty(held, dtype=counts.dtype, pin_memory=True)
        host = self._counts_host
        host.copy_(counts, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def read() -> list:
            copied.synchronize()
            return host.tolist()

        return order, read

    def run_experts(self, xs: torch.Tensor, counts: list) -> torch.Tensor:
        rows = self.counters["expert_rows"][self.index]
        out = []
        for j, (e, xe) in enumerate(zip(self.held, xs.split(counts))):
            if not counts[j]:
                continue
            rows[j] += counts[j]
            key = "kernel_products" if takes_kernel(xe, self.experts[str(e)].gate_proj.weight) else "plain_products"
            self.counters[key] += 2
            out.append(self.experts[str(e)](xe))
        return torch.cat(out) if out else xs

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, T, dim) -> (this rank's part of the layer's output, the
        balance loss, the loads of all experts)."""
        b, t, d = x.shape
        region = BackwardRange("moe.backward")
        flat = region.input(x).reshape(-1, d)
        with span("vq.moe.route"):
            idx, w, s = self.route(flat)
        with span("vq.moe.balance"):
            balance = self.balance(s.reshape(b, t, -1), idx.reshape(b, t, -1))
            load = torch.zeros(self.num_experts, dtype=torch.long, device=idx.device).scatter_add_(
                0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        with span("vq.moe.dispatch"):
            order, read_counts = self.sort_choices(idx)
        # the shared experts run while the host waits for the groups' rows
        with span("vq.moe.shared"):
            shared = BackwardRange("moe.shared.backward")
            y_shared = shared.output(self.shared_experts(shared.input(flat)))
        with span("vq.moe.dispatch"):
            counts = read_counts()
            order = order[: sum(counts)]
            tok, weights = order // self.top_k, w.reshape(-1)[order]
            experts = BackwardRange("moe.experts.backward")
            xs = experts.input(flat[tok])
        with span("vq.moe.experts"):
            ys = experts.output(self.run_experts(xs, counts))
        with span("vq.moe.combine"):
            y = y_shared.index_add(0, tok, ys * weights[:, None])
        return region.output(y.reshape(b, t, d)), balance, load


class _Layer(nn.Module):
    def __init__(self, attn: _MLA, mlp: nn.Module, dim: int, eps: float) -> None:
        super().__init__()
        self.input_layernorm = _RMSNorm(dim, eps)
        self.self_attn = attn
        self.post_attention_layernorm = _RMSNorm(dim, eps)
        self.mlp = mlp

    def forward(self, h, cos, sin):
        with span("vq.mla"):
            region = BackwardRange("mla.backward")
            h = h + region.output(self.self_attn(region.input(self.input_layernorm(h)), cos, sin))
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, _MoE):
            y, balance, load = self.mlp(x)
            return h + y, balance, load
        return h + self.mlp(x), None, None


@TransformerRegistry.register()
class DeepseekV3Transformer(nn.Module):
    """DeepSeek-V3's decoder (module docstring); the defaults are
    Moonlight-16B-A3B's. Weights start as N(0, 0.02) (norms at 1, the
    balancing bias at 0) from ``seed``, drawn on ``device`` (where
    ``ARAlgorithm`` runs it: ``builds_on_device``), or where the caller's
    default device puts them."""

    supports_fused_ce = False
    returns_aux = True
    builds_on_device = True

    def __init__(
        self,
        vocabulary_size: int,
        max_length: int,
        hidden_size: int = 2048,
        num_layers: int = 27,
        num_heads: int = 16,
        kv_lora_rank: int = 512,
        qk_nope_head_dim: int = 128,
        qk_rope_head_dim: int = 64,
        v_head_dim: int = 128,
        intermediate_size: int = 11264,
        moe_intermediate_size: int = 1408,
        n_routed_experts: int = 64,
        num_experts_per_tok: int = 6,
        n_shared_experts: int = 2,
        first_k_dense_replace: int = 1,
        routed_scaling_factor: float = 2.446,
        rms_norm_eps: float = 1e-5,
        rope_theta: float = 50000.0,
        experts_held: int | None = None,
        expert_rank: int = 0,
        balance_alpha: float = 1e-4,
        bias_gamma: float = 1e-3,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__()
        held = n_routed_experts if experts_held is None else experts_held
        if n_routed_experts % held or not 0 <= expert_rank < n_routed_experts // held:
            raise ValueError(f"{held} experts held of {n_routed_experts}: no rank {expert_rank}")
        self.vocabulary_size, self.max_length, self.hidden_size = vocabulary_size, max_length, hidden_size
        self.num_layers, self.rope_dim, self.rope_theta = num_layers, qk_rope_head_dim, rope_theta
        self.bias_gamma = bias_gamma
        self.held = range(expert_rank * held, (expert_rank + 1) * held)
        self.counters = new_counters(num_layers - first_k_dense_replace, held)
        # built where it runs: the draw below runs there too, not on the host
        with torch.device(device) if device is not None else contextlib.nullcontext():
            self.embed_tokens = nn.Embedding(vocabulary_size, hidden_size)
            layers = []
            for i in range(num_layers):
                attn = _MLA(hidden_size, num_heads, kv_lora_rank, qk_nope_head_dim, qk_rope_head_dim, v_head_dim,
                            rms_norm_eps)
                if i < first_k_dense_replace:
                    mlp = _SwiGLU(hidden_size, intermediate_size, "ffn.gemm")
                else:
                    mlp = _MoE(hidden_size, moe_intermediate_size, n_routed_experts, num_experts_per_tok,
                               n_shared_experts, self.held, routed_scaling_factor, balance_alpha,
                               self.counters, i - first_k_dense_replace)
                layers.append(_Layer(attn, mlp, hidden_size, rms_norm_eps))
            self.layers = nn.ModuleList(layers)
            self.norm = _RMSNorm(hidden_size, rms_norm_eps)
            self.lm_head = _Linear(hidden_size, vocabulary_size, "head.gemm")
        where = self.lm_head.weight.device
        gen = torch.Generator(device=where if where.type == "cuda" else "cpu").manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() > 1:
                    p.normal_(0.0, 0.02, generator=gen)

    def moe_layers(self) -> list[_MoE]:
        return [layer.mlp for layer in self.layers if isinstance(layer.mlp, _MoE)]

    def forward(self, tokens: torch.Tensor, cache: Any = None, return_aux: bool = False):
        """tokens (B, T) -> logits (B, T, V) f32; with ``return_aux`` also
        ``{"balance": the balance loss, "loads": each MoE layer's (E,)
        loads}``."""
        if cache is not None:
            raise NotImplementedError("DeepseekV3Transformer: decoding through MLA's latent cache is not ported")
        t = tokens.shape[1]
        if t > self.max_length:
            raise ValueError(f"{t} positions exceed max_length {self.max_length}")
        h = self.embed_tokens(tokens.long())
        cos, sin = rope_tables(t, self.rope_dim, self.rope_theta, h.device)
        balance, loads = h.new_zeros(()), []
        for layer in self.layers:
            h, bal, load = layer(h, cos, sin)
            if bal is not None:
                balance, loads = balance + bal, loads + [load]
        logits = self.lm_head(self.norm(h))
        return (logits, {"balance": balance, "loads": loads}) if return_aux else logits

    @torch.no_grad()
    def after_step(self, aux: dict) -> None:
        """The loss-free balancing: each MoE layer's bias moves by
        ``gamma sign(mean load - load)`` of its step's loads."""
        with span("vq.moe.balance"):
            for moe, load in zip(self.moe_layers(), aux["loads"]):
                load = load.float()
                moe.gate.e_score_correction_bias.add_(torch.sign(load.mean() - load), alpha=self.bias_gamma)

    def init_cache(self, *args: Any, **kwargs: Any):
        raise NotImplementedError("DeepseekV3Transformer: generation with MLA's latent cache is not ported")

