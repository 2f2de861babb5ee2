"""DeepSeek-V2 decoder as a query tower (DeepSeek-V2-Lite: multi-head
latent attention, a dense first layer, then 64 routed experts top-6 and
2 shared experts a layer), after DeepSeek's ``modeling_deepseek.py``.

The representation is the final RMSNorm's output at each query's last
real token (``last_token_rep``; padding on the right), as decoder
embedders (RepLLaMA, E5-Mistral) pool; no L2 normalisation, as the
other towers' representations have none.

Equations (``x`` a token's hidden state):

* layer ``l``: ``h = x + MLA(RMSNorm_1(x))``, ``x' = h + FFN_l(RMSNorm_2(h))``;
  FFN of the first ``first_k_dense_replace`` layers a SwiGLU
  ``W_down(silu(W_gate x) * W_up x)``, after them the MoE;
* RMSNorm ``w * x / sqrt(mean(x^2) + eps)`` in float32;
* MLA without a q LoRA: ``q = W_q x`` (h heads of ``d_n + d_r``);
  ``[c, k_r] = W_kva x``, ``c <- RMSNorm_kv(c)``; ``W_kvb c`` gives each
  head's ``k_n`` and ``v``; ``q_r`` and the one shared ``k_r`` rotated by
  YaRN RoPE at the token's position (interleaved pairs, HF's
  ``apply_rotary_emb``); score ``tau (q_n . k_n + q_r . k_r)`` with
  ``tau = (d_n + d_r)^-1/2 * m^2``, ``m = 0.1 mscale_all_dim ln(factor)
  + 1`` (DeepSeek's code; HF's ``deepseek_v2`` leaves out ``m^2``);
  causal and padding masks; softmax in float32;
* MoE: gate ``s = softmax(W_g x)`` over the routed experts, logits in
  float32; the ``num_experts_per_tok`` highest ``s_e``, not
  renormalised, times ``routed_scaling_factor``;
  ``y = sum_e s_e SwiGLU_e(x) + SwiGLU_shared(x)``, the shared experts
  one SwiGLU of ``n_shared_experts * moe_intermediate_size``.

The routed experts run as grouped products (``ops.grouped``): the
(token, choice) rows sorted by expert on the device, the experts' row
ends found by ``searchsorted``, one product for all experts, the rows
put back in token order and summed with their weights in float32.  No
routing count is read on the host.  ``MoE.expert_rows`` keeps the last
batch's rows per expert as a device tensor.

Parameter names follow HF's checkpoint (``model.`` dropped) with each
layer's routed experts stacked: ``layers.{i}.mlp.experts.gate_proj``
(E, I, d) and so on (``convert.convert_deepseek_v2``).  Weights are
held in the build dtype, norms and softmaxes computed in float32.  A
model is built in ``eval()`` mode with frozen parameters: a serving
tower, with no dropout and no training path.

Spans: ``tower.mla`` around each attention block, ``tower.moe`` around
each MoE block with ``moe.route`` and ``moe.experts`` inside; counters
``moe.routed_rows`` (tokens x experts per token, a layer) and
``moe.layers``, both known on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .. import frozen_eval, resolve_device
from ..ops.grouped import grouped_mm
from ..utils.timers import count, span
from .t5 import RMSNorm

# what the port computes of DeepSeek-V2's options; a config asking for
# another value is refused
_FIXED = {"q_lora_rank": None, "topk_method": "greedy",
          "scoring_func": "softmax", "norm_topk_prob": False, "n_group": 1,
          "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
          "attention_bias": False}


@dataclasses.dataclass(frozen=True)
class DeepseekV2Dims:
    """DeepSeek-V2-Lite's published sizes by default (its
    ``config.json``)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.707

    @classmethod
    def from_config(cls, c: Mapping) -> "DeepseekV2Dims":
        """From HF ``config.json`` keys (missing keys: DeepSeek-V2-Lite's,
        but ``rope_scaling``, which must be YaRN's); options the port
        does not compute raise."""
        for k, v in _FIXED.items():
            if k in c and c[k] != v:
                raise ValueError(f"deepseek_v2: {k}={c[k]!r} is not "
                                 f"supported (only {v!r})")
        if c.get("num_key_value_heads", c.get("num_attention_heads")) != \
                c.get("num_attention_heads"):
            raise ValueError("deepseek_v2: num_key_value_heads must equal "
                             "num_attention_heads")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: c[k] for k in names if k in c}
        rs = c.get("rope_scaling")
        if not rs or rs.get("type", rs.get("rope_type")) != "yarn":
            raise ValueError(f"deepseek_v2: rope_scaling={rs!r} is not "
                             "supported (only YaRN)")
        if rs.get("mscale", 0.707) != rs.get("mscale_all_dim", 0.707):
            # cos and sin would be scaled by their ratio
            raise ValueError("deepseek_v2: mscale != mscale_all_dim")
        for k, hf in (("rope_factor", "factor"),
                      ("original_max_position_embeddings",
                       "original_max_position_embeddings"),
                      ("beta_fast", "beta_fast"), ("beta_slow", "beta_slow"),
                      ("mscale_all_dim", "mscale_all_dim")):
            if hf in rs:
                kw[k] = rs[hf]
        return cls(**kw)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """``tau``: ``qk_head_dim^-1/2`` times YaRN's ``m^2``."""
        m = yarn_mscale(self.rope_factor, self.mscale_all_dim)
        return self.qk_head_dim ** -0.5 * m * m


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(d: DeepseekV2Dims) -> torch.Tensor:
    """(d_r / 2,) float32: ``f_j = theta^(-2j/d_r)`` blended towards
    ``f_j / factor`` by the ramp ``clamp((j - low) / (high - low), 0, 1)``
    over YaRN's correction range (low floor, high ceil)."""
    dim = d.qk_rope_head_dim

    def corr(rot):
        return (dim * math.log(d.original_max_position_embeddings
                               / (rot * 2 * math.pi))
                / (2 * math.log(d.rope_theta)))
    low = max(math.floor(corr(d.beta_fast)), 0)
    high = min(math.ceil(corr(d.beta_slow)), dim - 1)
    j = torch.arange(dim // 2, dtype=torch.float32)
    f = 1.0 / d.rope_theta ** (2 * j / dim)
    ramp = ((j - low) / max(high - low, 1e-3)).clamp(0, 1)
    return f * (1 - ramp) + f / d.rope_factor * ramp


def rope_tables(inv_freq: torch.Tensor, length: int):
    """(cos, sin), each (length, d_r / 2) float32, at positions
    0..length-1."""
    pos = torch.arange(length, dtype=torch.float32, device=inv_freq.device)
    ang = pos[:, None] * inv_freq[None, :]
    return ang.cos(), ang.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Interleaved pairs ``(x_2j, x_2j+1)`` of ``x`` (b, L, ..., d_r)
    rotated by the position's angle, in float32; ``cos``/``sin``
    (L, d_r / 2)."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    shape = (1, cos.shape[0]) + (1,) * (x.dim() - 3) + (cos.shape[1],)
    c, s = cos.reshape(shape), sin.reshape(shape)
    return torch.stack((a * c - b * s, a * s + b * c), -1).flatten(-2) \
        .to(x.dtype)


def causal_padding_mask(mask: torch.Tensor) -> torch.Tensor:
    """(b, L) 1/0 padding mask -> additive float32 (b, 1, L, L): key
    ``p'`` open to query ``p`` when ``p' <= p`` and ``p'`` is real."""
    L = mask.shape[1]
    causal = torch.ones((L, L), dtype=torch.bool, device=mask.device).tril()
    ok = causal[None, None] & (mask[:, None, None, :] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(ok, zero, zero - 1e9)


class MLP(nn.Module):
    """SwiGLU ``down(silu(gate x) * up x)``."""

    def __init__(self, d: int, inner: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(d, inner, **kw)
        self.up_proj = nn.Linear(d, inner, **kw)
        self.down_proj = nn.Linear(inner, d, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLA(nn.Module):
    """Multi-head latent attention (no q LoRA), HF's parameter names."""

    def __init__(self, dims: DeepseekV2Dims, device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        kw = dict(bias=False, device=device, dtype=dtype)
        h = d.num_attention_heads
        self.q_proj = nn.Linear(d.hidden_size, h * d.qk_head_dim, **kw)
        self.kv_a_proj_with_mqa = nn.Linear(
            d.hidden_size, d.kv_lora_rank + d.qk_rope_head_dim, **kw)
        self.kv_a_layernorm = RMSNorm(d.kv_lora_rank, d.rms_norm_eps,
                                      device=device, dtype=dtype)
        self.kv_b_proj = nn.Linear(
            d.kv_lora_rank, h * (d.qk_nope_head_dim + d.v_head_dim), **kw)
        self.o_proj = nn.Linear(h * d.v_head_dim, d.hidden_size, **kw)

    def forward(self, x, cos, sin, add_mask):
        """x (b, L, d); ``add_mask`` (b, 1, L, L) additive float32."""
        with span("tower.mla"):
            d = self.dims
            b, L, _ = x.shape
            h, dn, dr = d.num_attention_heads, d.qk_nope_head_dim, \
                d.qk_rope_head_dim
            q = self.q_proj(x).view(b, L, h, dn + dr)
            c, k_r = self.kv_a_proj_with_mqa(x).split(
                [d.kv_lora_rank, dr], -1)
            k_n, v = self.kv_b_proj(self.kv_a_layernorm(c)).view(
                b, L, h, dn + d.v_head_dim).split([dn, d.v_head_dim], -1)
            q = torch.cat([q[..., :dn], rotate(q[..., dn:], cos, sin)], -1)
            k_r = rotate(k_r, cos, sin)                       # (b, L, dr)
            k = torch.cat([k_n, k_r[:, :, None, :].expand(b, L, h, dr)], -1)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() \
                * d.softmax_scale + add_mask
            probs = torch.softmax(scores, -1).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
            return self.o_proj(o.reshape(b, L, h * d.v_head_dim))


class Experts(nn.Module):
    """The routed experts' SwiGLUs, stacked: ``gate_proj`` / ``up_proj``
    (E, I, d), ``down_proj`` (E, d, I), each expert in ``nn.Linear``
    layout."""

    def __init__(self, n: int, d: int, inner: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = nn.Parameter(torch.empty((n, inner, d), **kw))
        self.up_proj = nn.Parameter(torch.empty((n, inner, d), **kw))
        self.down_proj = nn.Parameter(torch.empty((n, d, inner), **kw))
        for p in self.parameters():
            nn.init.normal_(p, std=0.02)

    def forward(self, rows, ends):
        """Rows sorted by expert, ``ends`` (E,) int32 cumulative counts."""
        a = grouped_mm(rows, self.gate_proj, ends)
        u = grouped_mm(rows, self.up_proj, ends)
        return grouped_mm(F.silu(a) * u, self.down_proj, ends)


class MoE(nn.Module):
    """Routed experts top-k (softmax gate, greedy, not renormalised)
    plus the shared experts."""

    def __init__(self, dims: DeepseekV2Dims, device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        kw = dict(device=device, dtype=dtype)
        self.gate = nn.Linear(d.hidden_size, d.n_routed_experts, bias=False,
                              **kw)
        self.experts = Experts(d.n_routed_experts, d.hidden_size,
                               d.moe_intermediate_size, **kw)
        self.shared_experts = MLP(
            d.hidden_size, d.n_shared_experts * d.moe_intermediate_size,
            **kw)
        self.register_buffer("expert_ids", torch.arange(
            d.n_routed_experts, device=device), persistent=False)
        self.expert_rows = None

    def route(self, x):
        """x (T, d) -> (weights (T, k) float32, experts (T, k))."""
        logits = F.linear(x.float(), self.gate.weight.float())
        w, idx = torch.topk(torch.softmax(logits, -1),
                            self.dims.num_experts_per_tok, dim=-1)
        return w * self.dims.routed_scaling_factor, idx

    def forward(self, x):
        """x (b, L, d) -> (b, L, d)."""
        with span("tower.moe"):
            d = self.dims
            shape = x.shape
            x = x.reshape(-1, shape[-1])
            T, k = x.shape[0], d.num_experts_per_tok
            with span("moe.route"):
                w, idx = self.route(x)
                flat = idx.reshape(-1)
                order = torch.argsort(flat, stable=True)
                ends = torch.searchsorted(flat[order], self.expert_ids,
                                          right=True).to(torch.int32)
                rows = x.index_select(0, order // k)
            with span("moe.experts"):
                y = self.experts(rows, ends)
            out = torch.empty_like(y)
            out[order] = y
            routed = (out.view(T, k, -1).float() * w[..., None]).sum(1)
            y = (routed + self.shared_experts(x).float()).to(x.dtype)
            self.expert_rows = torch.diff(ends, prepend=ends.new_zeros(1))
            count("moe.routed_rows", T * k)
            count("moe.layers")
            return y.reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, dims: DeepseekV2Dims, moe: bool, device=None,
                 dtype=None):
        super().__init__()
        d = dims
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(d.hidden_size, d.rms_norm_eps, **kw)
        self.self_attn = MLA(d, **kw)
        self.post_attention_layernorm = RMSNorm(d.hidden_size,
                                                d.rms_norm_eps, **kw)
        self.mlp = MoE(d, **kw) if moe else MLP(d.hidden_size,
                                                d.intermediate_size, **kw)

    def forward(self, x, cos, sin, add_mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, add_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2Model(nn.Module):
    """Embedding, ``num_hidden_layers`` decoder layers and the final
    norm (HF's ``DeepseekV2Model``, no LM head)."""

    def __init__(self, dims: DeepseekV2Dims, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        d = dims
        self.dims = d
        kw = dict(device=dev, dtype=dtype)
        self.embed_tokens = nn.Embedding(d.vocab_size, d.hidden_size, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(d, i >= d.first_k_dense_replace, **kw)
            for i in range(d.num_hidden_layers))
        self.norm = RMSNorm(d.hidden_size, d.rms_norm_eps, **kw)
        self.register_buffer("inv_freq", yarn_inv_freq(d).to(dev),
                             persistent=False)
        frozen_eval(self)

    def hidden(self, input_ids, attention_mask):
        """(b, L, d) states after the last layer (before the final
        norm)."""
        x = self.embed_tokens(input_ids.long())
        cos, sin = rope_tables(self.inv_freq, input_ids.shape[1])
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        add = causal_padding_mask(attention_mask)
        for layer in self.layers:
            x = layer(x, cos, sin, add)
        return x

    def forward(self, input_ids, attention_mask=None):
        return self.norm(self.hidden(input_ids, attention_mask))

    def last_token_rep(self, input_ids, attention_mask=None):
        """(b, d): the final norm's output at each query's last real
        token (right padding)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.hidden(input_ids, attention_mask)
        last = (attention_mask.long().sum(1) - 1).clamp(min=0)
        pooled = x[torch.arange(x.shape[0], device=x.device), last]
        return self.norm(pooled)

