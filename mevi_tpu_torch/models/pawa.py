"""PAWA adaptive decoder head (port of ``mevi_tpu.models.pawa``).

A small torch-style TransformerDecoder (post-LayerNorm, scaled
dot-product attention, ReLU FFN) runs over the decode-token embeddings
with a single learned memory vector; its output feeds the per-position
LM-head weight delta composed in :mod:`mevi_tpu_torch.models.nci`.
Cross-attention over one memory key is softmax over a single key, so at
decode time each layer's cross block collapses to ``out_proj(v_mem)``.
Training side: dropout on the attention probabilities, on each
attention output and in the FF (``nn.TransformerDecoderLayer``'s
places), active in ``train()`` mode only; the decode steps (unrolled
over per-position entries, or dynamic-``t`` over a preallocated
time-major cache) are inference paths.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import frozen_eval, resolve_device


@dataclasses.dataclass(frozen=True)
class PawaDims:
    d_model: int = 768
    num_heads: int = 8
    d_ff: int = 2048
    num_layers: int = 4
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-5


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` numerics: packed in-projection, scaled,
    heads-last ``(b, l, h, dk)`` layout."""

    def __init__(self, dims: PawaDims, device=None, dtype=None):
        super().__init__()
        self.dims = dims
        dm = dims.d_model
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * dm, dm, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(
            torch.zeros(3 * dm, device=device, dtype=dtype))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(dm, dm, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dims.dropout_rate)

    def _split(self, x):
        h = self.dims.num_heads
        b, l, _ = x.shape
        return x.reshape(b, l, h, self.dims.d_model // h)

    def project_q(self, x):
        dm = self.dims.d_model
        return self._split(F.linear(x, self.in_proj_weight[:dm],
                                    self.in_proj_bias[:dm]))

    def project_kv(self, x):
        dm = self.dims.d_model
        k = F.linear(x, self.in_proj_weight[dm:2 * dm],
                     self.in_proj_bias[dm:2 * dm])
        v = F.linear(x, self.in_proj_weight[2 * dm:],
                     self.in_proj_bias[2 * dm:])
        return self._split(k), self._split(v)

    def project_qkv(self, x):
        dm = self.dims.d_model
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        return (self._split(qkv[..., :dm]), self._split(qkv[..., dm:2 * dm]),
                self._split(qkv[..., 2 * dm:]))

    def scale(self, dtype):
        dk = self.dims.d_model // self.dims.num_heads
        return torch.tensor(float(dk), dtype=torch.float32).sqrt().to(dtype)

    def attend(self, q, k, v, attn_mask=None):
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / self.scale(q.dtype)
        if attn_mask is not None:
            scores = scores + attn_mask
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", self.dropout(probs), v)
        b, l = ctx.shape[:2]
        return self.out_proj(ctx.reshape(b, l, self.dims.d_model))

    def forward(self, q_in, kv_in, attn_mask=None):
        if q_in is kv_in:
            q, k, v = self.project_qkv(q_in)
        else:
            q = self.project_q(q_in)
            k, v = self.project_kv(kv_in)
        return self.attend(q, k, v, attn_mask)


class TorchDecoderLayer(nn.Module):
    """``nn.TransformerDecoderLayer`` (post-norm, relu)."""

    def __init__(self, dims: PawaDims, device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        kw = dict(device=device, dtype=dtype)
        self.self_attn = TorchMultiheadAttention(d, **kw)
        self.cross_attn = TorchMultiheadAttention(d, **kw)
        ln = dict(eps=d.layer_norm_epsilon, **kw)
        self.norm1 = nn.LayerNorm(d.d_model, **ln)
        self.norm2 = nn.LayerNorm(d.d_model, **ln)
        self.norm3 = nn.LayerNorm(d.d_model, **ln)
        self.linear1 = nn.Linear(d.d_model, d.d_ff, **kw)
        self.linear2 = nn.Linear(d.d_ff, d.d_model, **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def _ff(self, x):
        ff = self.dropout(F.relu(self.linear1(x)))
        return self.norm3(x + self.dropout(self.linear2(ff)))

    def forward(self, tgt, memory, tgt_mask=None):
        sa = self.self_attn(tgt, tgt, tgt_mask)
        x = self.norm1(tgt + self.dropout(sa))
        ca = self.cross_attn(x, memory, None)
        x = self.norm2(x + self.dropout(ca))
        return self._ff(x)

    def decode_step_unrolled(self, x_t, t: int, entries_i, mem_const):
        """Step at python-int ``t``; ``entries_i`` is this layer's
        per-position list of ``(k, v)``, each ``(rows, h, dk)``; the
        position-0 entry may have 1 row (PAWA is query-independent) and
        broadcasts over the beam batch.  Returns (out (b, 1, d),
        new entry (k, v) of (b, h, dk))."""
        b = x_t.shape[0]
        q, k_t, v_t = self.self_attn.project_qkv(x_t)   # (b, 1, h, dk)
        k_t2, v_t2 = k_t[:, 0], v_t[:, 0]
        q2 = q[:, 0]
        parts = []
        for p in range(t):
            kp = entries_i[p][0]
            if kp.shape[0] != b:
                qb = q2.reshape(kp.shape[0], -1, *q2.shape[1:])
                parts.append(torch.einsum("Bnhd,Bhd->Bnh", qb, kp)
                             .reshape(b, -1))
            else:
                parts.append(torch.einsum("bhd,bhd->bh", q2, kp))
        parts.append(torch.einsum("bhd,bhd->bh", q2, k_t2))
        scores = (torch.stack(parts, -1)
                  / self.self_attn.scale(q.dtype)).float()
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        ctx = probs[..., t, None] * v_t2
        for p in range(t):
            vp = entries_i[p][1]
            if vp.shape[0] != b:
                pb = probs[..., p].reshape(vp.shape[0], -1, probs.shape[1])
                ctx = ctx + torch.einsum("Bnh,Bhd->Bnhd", pb, vp
                                         ).reshape(b, *vp.shape[1:])
            else:
                ctx = ctx + probs[..., p, None] * vp
        sa = self.self_attn.out_proj(ctx.reshape(b, 1, self.dims.d_model))
        x = self.norm1(x_t + sa)
        x = self.norm2(x + mem_const)
        return self._ff(x), (k_t2, v_t2)


    def decode_step(self, x_t, t, cache_kv, mem_const):
        """Step at position ``t`` (int or 0-d tensor) over a time-major
        ``(max_len, b, h, dk)`` cache pair written in place at ``t``;
        ``mem_const`` is the layer's ``out_proj(v_mem)``.  Returns
        (out (b, 1, d), cache_kv)."""
        ck, cv = cache_kv
        pos = torch.arange(ck.shape[0], device=x_t.device)
        t_idx = torch.as_tensor(t, device=x_t.device).reshape(1)
        zero = torch.zeros((), dtype=torch.float32, device=x_t.device)
        causal = torch.where(pos <= t_idx, zero, zero - 1e9)
        q, k_t, v_t = self.self_attn.project_qkv(x_t)   # (b, 1, h, dk)
        ck.index_copy_(0, t_idx, k_t.transpose(0, 1).to(ck.dtype))
        cv.index_copy_(0, t_idx, v_t.transpose(0, 1).to(cv.dtype))
        scores = torch.einsum("bqhd,lbhd->bhql", q, ck.to(q.dtype)) \
            / self.self_attn.scale(q.dtype)
        probs = torch.softmax(scores.float() + causal, dim=-1).to(q.dtype)
        ctx = torch.einsum("bhql,lbhd->bqhd", probs, cv.to(q.dtype))
        b = ctx.shape[0]
        sa = self.self_attn.out_proj(ctx.reshape(b, 1, self.dims.d_model))
        x = self.norm1(x_t + sa)
        x = self.norm2(x + mem_const)
        return self._ff(x), (ck, cv)


class PawaAdaptor(nn.Module):
    """The adaptor stack producing h_a (b, l, d)."""

    def __init__(self, dims: PawaDims, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.dims = dims
        self.memory_embedding = nn.Parameter(
            torch.rand(1, 1, dims.d_model, device=dev, dtype=dtype))
        self.layers = nn.ModuleList(
            TorchDecoderLayer(dims, device=dev, dtype=dtype)
            for _ in range(dims.num_layers))
        frozen_eval(self)

    def _panel_inputs(self, tgt_embeds):
        """(causal additive mask (1, 1, l, l), memory (b, 1, d))."""
        b, l, _ = tgt_embeds.shape
        tri = torch.ones(l, l, dtype=torch.bool,
                         device=tgt_embeds.device).tril()
        zero = torch.zeros((), dtype=tgt_embeds.dtype,
                           device=tgt_embeds.device)
        mask = torch.where(tri, zero, zero - math.inf)[None, None]
        memory = self.memory_embedding.to(tgt_embeds.dtype).expand(
            b, 1, self.dims.d_model)
        return mask, memory

    def forward(self, tgt_embeds):
        mask, memory = self._panel_inputs(tgt_embeds)
        x = tgt_embeds
        for layer in self.layers:
            x = layer(x, memory, mask)
        return x

    def panel_with_kvs(self, tgt_embeds):
        """Panel forward that also returns every layer's self-attention
        (k, v), what the decode path caches: (h_all (b, l, d), kvs
        (num_layers, 2, b, l, h, dk)).  PAWA sees only the decode
        tokens, so its whole state is a function of the code prefix;
        :meth:`NCIT5.pawa_prefix_tables` tabulates it per prefix."""
        mask, memory = self._panel_inputs(tgt_embeds)
        x = tgt_embeds
        kvs = []
        for layer in self.layers:
            _, k, v = layer.self_attn.project_qkv(x)     # (b, l, h, dk)
            kvs.append(torch.stack([k, v]))
            x = layer(x, memory, mask)
        return x, torch.stack(kvs)

    def precompute_mem_kvs(self, dtype=None):
        """Per layer the (1, 1, d) constant ``out_proj(v_mem)``: the
        cross-attention over the single memory key."""
        mem = self.memory_embedding
        if dtype is not None:
            mem = mem.to(dtype)
        out = []
        for layer in self.layers:
            _, v = layer.cross_attn.project_kv(mem)       # (1, 1, h, dk)
            out.append(layer.cross_attn.out_proj(
                v.reshape(1, 1, self.dims.d_model)))
        return out

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Per-layer time-major ``(max_len, b, h, dk)`` cache pairs."""
        d = self.dims
        w = self.memory_embedding
        shape = (max_len, batch, d.num_heads, d.d_model // d.num_heads)
        return [(torch.zeros(shape, dtype=dtype or w.dtype, device=w.device),
                 torch.zeros(shape, dtype=dtype or w.dtype, device=w.device))
                for _ in self.layers]

    def decode_step(self, embed_t, t, cache, mem_kvs):
        """embed_t (b, 1, d) at position ``t`` -> (h_a_t (b, 1, d),
        cache)."""
        x = embed_t
        for layer, ckv, mkv in zip(self.layers, cache, mem_kvs):
            x, _ = layer.decode_step(x, t, ckv, mkv)
        return x, cache

    def decode_step_unrolled(self, embed_t, t: int, entries, mem_kvs=None):
        """Static-``t`` step over a per-position entry list (each entry
        a tuple over layers of ``(k, v)``).  Returns (h_a_t (b, 1, d),
        new entry)."""
        if mem_kvs is None:
            mem_kvs = self.precompute_mem_kvs()
        x = embed_t
        new = []
        for i, (layer, mkv) in enumerate(zip(self.layers, mem_kvs)):
            x, e = layer.decode_step_unrolled(
                x, t, [ent[i] for ent in entries], mkv)
            new.append(e)
        return x, tuple(new)
