"""T5 encoder-decoder in PyTorch, numerically matching
``mevi_tpu.models.t5`` (and so HF T5).

* attention is not scaled by 1/sqrt(d_k) (T5 folds it into init),
* RMSNorm without mean subtraction or bias,
* relative position bias only in block 0 of each stack, shared onward,
* additive -1e9 masks, softmax in float32,
* heads-last layouts ``(b, l, h, dk)`` at every public function, and
  the JAX package's two decode caches: per-position entries as tuples
  over layers of ``(k, v)`` arrays of shape ``(rows, h, dk)`` (the
  unrolled step at a python-int position), or preallocated time-major
  ``(max_len, b, h, dk)`` caches written at step ``t`` (the dynamic
  step, ``t`` an int or a 0-d tensor).

Training side: dropout where the JAX modules place it (inside the FF,
on each residual branch, on a stack's input embeddings and on its
output before the final norm; none on attention probabilities), active
in ``train()`` mode only.  A module is built in ``eval()`` mode with its
parameters frozen, the serving default; training code turns both on.
``T5Dims.remat`` wraps each block in ``torch.utils.checkpoint``
(non-reentrant, RNG state preserved, so dropout replays identically).
``T5Dims.dtype`` is the compute dtype: the training steps run the
forward under ``torch.autocast`` in it over float32 parameters
(``mevi_tpu_torch.train.trainer.compute_autocast``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device_constant, frozen_eval, resolve_device


@dataclasses.dataclass(frozen=True)
class T5Dims:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    num_decoder_layers: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1
    gated_act: bool = False      # False: relu (t5 v1.0 / t5-ance)
    remat: bool = False          # checkpoint blocks (training memory)
    dtype: torch.dtype = torch.float32   # compute dtype


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (self.weight.float() * y).to(x.dtype)


def _log_f32(x: float) -> torch.Tensor:
    return torch.log(torch.tensor(x, dtype=torch.float32))


def relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int
                             ) -> torch.Tensor:
    """HF T5 ``_relative_position_bucket`` exactly as the JAX package
    computes it: float32 log with the ``+1e-20`` guard, truncation to
    int32 (HF's torch version differs in the last two)."""
    ret = torch.zeros_like(rel_pos, dtype=torch.int32)
    n = -rel_pos.to(torch.int32)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = device_constant(_log_f32, max_distance / max_exact,
                            device=n.device)
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20) / denom
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _softmax_f32(scores, dtype):
    return torch.softmax(scores, dim=-1).to(dtype)


class T5Attention(nn.Module):
    def __init__(self, dims: T5Dims, has_relative_bias: bool = False,
                 bidirectional: bool = True, device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        self.has_relative_bias = has_relative_bias
        self.bidirectional = bidirectional
        inner = d.num_heads * d.d_kv
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = nn.Linear(d.d_model, inner, **kw)
        self.k = nn.Linear(d.d_model, inner, **kw)
        self.v = nn.Linear(d.d_model, inner, **kw)
        self.o = nn.Linear(inner, d.d_model, **kw)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                d.relative_attention_num_buckets, d.num_heads,
                device=device, dtype=dtype)

    def bias_table(self, buckets):
        """(…) buckets -> (…, h) float32 bias."""
        return self.relative_attention_bias(buckets.long()).float()

    def compute_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        d = self.dims
        dev = self.q.weight.device
        ctx = torch.arange(q_len, device=dev)[:, None]
        mem = torch.arange(k_len, device=dev)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional,
            d.relative_attention_num_buckets,
            d.relative_attention_max_distance)
        return self.bias_table(buckets).permute(2, 0, 1)[None]  # (1,h,q,k)

    def _split(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.dims.num_heads, self.dims.d_kv)

    def attend(self, q, k, v, position_bias, mask):
        """q, k, v: (b, l, h, d_kv); mask: additive (b, 1, q, k) or None."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = scores + mask
        probs = _softmax_f32(scores, q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        b, l, h, dk = out.shape
        return out.reshape(b, l, h * dk)

    def forward(self, hidden, kv_hidden=None, mask=None,
                position_bias=None, kv_cache=None):
        """kv_cache: optional precomputed (k, v) heads for cross-attn."""
        if kv_cache is not None:
            q = self._split(self.q(hidden))
            k, v = kv_cache
        elif kv_hidden is None:
            q, k, v = self.project_qkv(hidden)
        else:
            q = self._split(self.q(hidden))
            k, v = self.project_kv(kv_hidden)
        if position_bias is None and self.has_relative_bias:
            position_bias = self.compute_bias(q.shape[1], k.shape[1])
        ctx = self.attend(q, k, v, position_bias, mask)
        return self.o(ctx), position_bias

    def project_qkv(self, hidden):
        """Self-attention q/k/v in one (3*inner, d) matmul."""
        inner = self.dims.num_heads * self.dims.d_kv
        w = torch.cat([self.q.weight, self.k.weight, self.v.weight], 0)
        qkv = F.linear(hidden, w)
        return (self._split(qkv[..., :inner]),
                self._split(qkv[..., inner:2 * inner]),
                self._split(qkv[..., 2 * inner:]))

    def project_kv(self, kv_hidden):
        return self._split(self.k(kv_hidden)), self._split(self.v(kv_hidden))


class T5FF(nn.Module):
    def __init__(self, dims: T5Dims, device=None, dtype=None):
        super().__init__()
        d = dims
        self.gated = d.gated_act
        kw = dict(bias=False, device=device, dtype=dtype)
        if d.gated_act:
            self.wi_0 = nn.Linear(d.d_model, d.d_ff, **kw)
            self.wi_1 = nn.Linear(d.d_model, d.d_ff, **kw)
        else:
            self.wi = nn.Linear(d.d_model, d.d_ff, **kw)
        self.wo = nn.Linear(d.d_ff, d.d_model, **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(self.dropout(h))


class T5Block(nn.Module):
    def __init__(self, dims: T5Dims, is_decoder: bool,
                 has_relative_bias: bool, device=None, dtype=None):
        super().__init__()
        d = dims
        kw = dict(device=device, dtype=dtype)
        self.is_decoder = is_decoder
        self.self_attn = T5Attention(d, has_relative_bias,
                                     bidirectional=not is_decoder, **kw)
        self.self_norm = RMSNorm(d.d_model, d.layer_norm_epsilon, **kw)
        if is_decoder:
            self.cross_attn = T5Attention(d, False, **kw)
            self.cross_norm = RMSNorm(d.d_model, d.layer_norm_epsilon,
                                      **kw)
        self.ff = T5FF(d, **kw)
        self.ff_norm = RMSNorm(d.d_model, d.layer_norm_epsilon, **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, hidden, self_mask=None, position_bias=None,
                enc_hidden=None, enc_mask=None, cross_kv=None):
        y, position_bias = self.self_attn(
            self.self_norm(hidden), mask=self_mask,
            position_bias=position_bias)
        hidden = hidden + self.dropout(y)
        if self.is_decoder:
            y, _ = self.cross_attn(
                self.cross_norm(hidden), kv_hidden=enc_hidden,
                mask=enc_mask, kv_cache=cross_kv)
            hidden = hidden + self.dropout(y)
        y = self.ff(self.ff_norm(hidden))
        return hidden + self.dropout(y), position_bias


def _cross_ffn_step(block, hidden, cross_kv, enc_mask, beams):
    """Cross-attention + FFN tail of one decode step; ``cross_kv`` may
    be per-QUERY (b // beams rows) and is then shared across each
    query's beams without materializing the replication."""
    cattn = block.cross_attn
    cx = block.cross_norm(hidden)
    ck_, cv_ = cross_kv
    if beams > 1 and ck_.shape[0] * beams == cx.shape[0]:
        cq = cattn._split(cattn.q(cx))             # (B*nb, 1, h, dk)
        B = ck_.shape[0]
        h, dk = cq.shape[2], cq.shape[3]
        cqb = cq.reshape(B, beams, h, dk)
        scores = torch.einsum("bnhd,bkhd->bhnk", cqb, ck_).float()
        if enc_mask is not None:
            scores = scores + enc_mask             # (B, 1, 1, k) bcast
        probs = _softmax_f32(scores, cq.dtype)
        ctx = torch.einsum("bhnk,bkhd->bnhd", probs, cv_)
        y = cattn.o(ctx.reshape(B * beams, 1, h * dk))
    else:
        y, _ = cattn(cx, mask=enc_mask, kv_cache=(ck_, cv_))
    hidden = hidden + y
    return hidden + block.ff(block.ff_norm(hidden))


def extend_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(b, k) 1/0 mask -> additive float32 (b, 1, 1, k)."""
    if mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, zero - 1e9)


def causal_mask(length: int, device=None) -> torch.Tensor:
    m = torch.ones(length, length, dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(m, zero, zero - 1e9)[None, None]


class T5Stack(nn.Module):
    """Encoder or decoder stack (embedding handled by the caller so that
    NCI can swap in a separate decode-vocab embedding)."""

    def __init__(self, dims: T5Dims, num_layers: int, is_decoder: bool,
                 device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        self.is_decoder = is_decoder
        self.blocks = nn.ModuleList(
            T5Block(d, is_decoder, has_relative_bias=(i == 0),
                    device=device, dtype=dtype)
            for i in range(num_layers))
        self.final_norm = RMSNorm(d.d_model, d.layer_norm_epsilon,
                                  device=device, dtype=dtype)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, embeds, self_mask=None, enc_hidden=None,
                enc_mask=None, cross_kvs=None):
        hidden = self.dropout(embeds)
        position_bias = None
        remat = self.dims.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            args = (hidden, self_mask, position_bias, enc_hidden, enc_mask,
                    None if cross_kvs is None else cross_kvs[i])
            if remat:
                hidden, position_bias = checkpoint(block, *args,
                                                   use_reentrant=False)
            else:
                hidden, position_bias = block(*args)
        return self.final_norm(self.dropout(hidden))

    def project_cross_kvs(self, enc_hidden):
        """Each layer's cross-attention (k, v), once per query."""
        assert self.is_decoder
        return [b.cross_attn.project_kv(enc_hidden) for b in self.blocks]

    # -- incremental decoding (self-attention KV cache) --------------------

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Per-layer ``(k, v)`` caches of shape ``(max_len, b, h, d_kv)``,
        time-major as in the JAX package (the step's write is one
        leading-dim slab); ``dtype`` defaults to the parameters'."""
        d = self.dims
        w = self.final_norm.weight
        shape = (max_len, batch, d.num_heads, d.d_kv)
        return [(torch.zeros(shape, dtype=dtype or w.dtype, device=w.device),
                 torch.zeros(shape, dtype=dtype or w.dtype, device=w.device))
                for _ in self.blocks]

    def decode_step(self, embed_t, t, cache, cross_kvs, enc_mask,
                    beams: int = 1):
        """One decode step at position ``t`` (a python int or a 0-d
        tensor) over the preallocated ``cache`` of :meth:`init_cache`,
        written in place at ``t``.  ``cross_kvs`` may be per query
        (``b // beams`` rows, see :func:`_cross_ffn_step`); ``enc_mask``
        additive.  Returns ``(hidden (b, 1, d), cache)``."""
        assert self.is_decoder
        d = self.dims
        max_len = cache[0][0].shape[0]
        pos = torch.arange(max_len, device=embed_t.device)
        t_idx = torch.as_tensor(t, device=embed_t.device).reshape(1)
        zero = torch.zeros((), dtype=torch.float32, device=embed_t.device)
        causal = torch.where(pos <= t_idx, zero, zero - 1e9)
        hidden = embed_t
        position_bias = None
        for i, block in enumerate(self.blocks):
            attn = block.self_attn
            q, k_t, v_t = attn.project_qkv(block.self_norm(hidden))
            ck, cv = cache[i]                          # (L, b, h, dk)
            ck.index_copy_(0, t_idx, k_t.transpose(0, 1).to(ck.dtype))
            cv.index_copy_(0, t_idx, v_t.transpose(0, 1).to(cv.dtype))
            if i == 0:
                # the decoder's relative-position bias row for query t
                buckets = relative_position_bucket(
                    pos - t_idx, False, d.relative_attention_num_buckets,
                    d.relative_attention_max_distance)
                position_bias = attn.bias_table(buckets).T[None, :, None, :]
            scores = torch.einsum("bqhd,lbhd->bhql", q, ck.to(q.dtype)
                                  ).float()
            probs = _softmax_f32(scores + position_bias + causal, q.dtype)
            y = torch.einsum("bhql,lbhd->bqhd", probs, cv.to(q.dtype))
            b = y.shape[0]
            hidden = hidden + attn.o(y.reshape(b, 1, d.num_heads * d.d_kv))
            hidden = _cross_ffn_step(block, hidden, cross_kvs[i],
                                     enc_mask, beams)
        return self.final_norm(hidden), cache

    def decode_step_unrolled(self, embed_t, t: int, entries, cross_kvs,
                             enc_mask, beams: int = 1):
        """One decode step at python-int position ``t``.

        ``entries``: list over positions < t, each a tuple over layers
        of ``(k, v)`` of shape ``(rows_p, h, dk)``; ``rows_p`` may be
        ``b // beams`` for beam-shared positions (the start token),
        which are broadcast inside attention, never replicated.
        Returns ``(hidden (b, 1, d), new_entry)``, ``new_entry`` a
        tuple over layers of ``(k (b, h, dk), v (b, h, dk))``.
        """
        assert self.is_decoder
        d = self.dims
        b = embed_t.shape[0]
        hidden = embed_t
        new_kv = []
        position_bias = None
        for i, block in enumerate(self.blocks):
            attn = block.self_attn
            q, k_t, v_t = attn.project_qkv(block.self_norm(hidden))
            k_t2, v_t2 = k_t[:, 0], v_t[:, 0]          # (b, h, dk)
            new_kv.append((k_t2, v_t2))
            if i == 0:
                rel = torch.arange(t + 1, device=embed_t.device) - t
                buckets = relative_position_bucket(
                    rel, False, d.relative_attention_num_buckets,
                    d.relative_attention_max_distance)
                position_bias = attn.bias_table(buckets).T[None]  # (1,h,t+1)
            q2 = q[:, 0]
            parts = []
            for p in range(t):
                kp = entries[p][i][0]
                if kp.shape[0] != b:                   # beam-shared
                    qb = q2.reshape(kp.shape[0], -1, *q2.shape[1:])
                    parts.append(torch.einsum("Bnhd,Bhd->Bnh", qb, kp)
                                 .reshape(b, -1))
                else:
                    parts.append(torch.einsum("bhd,bhd->bh", q2, kp))
            parts.append(torch.einsum("bhd,bhd->bh", q2, k_t2))
            scores = torch.stack(parts, -1).float()
            probs = _softmax_f32(scores + position_bias, q.dtype)
            ctx = probs[..., t, None] * v_t2
            for p in range(t):
                vp = entries[p][i][1]
                if vp.shape[0] != b:
                    pb = probs[..., p].reshape(vp.shape[0], -1,
                                               probs.shape[1])
                    ctx = ctx + torch.einsum("Bnh,Bhd->Bnhd", pb, vp
                                             ).reshape(b, *vp.shape[1:])
                else:
                    ctx = ctx + probs[..., p, None] * vp
            hidden = hidden + attn.o(ctx.reshape(b, 1, -1))
            hidden = _cross_ffn_step(block, hidden, cross_kvs[i],
                                     enc_mask, beams)
        return self.final_norm(hidden), tuple(new_kv)


class T5EncoderModel(nn.Module):
    """Shared-embedding encoder (query/passage tower front end)."""

    def __init__(self, dims: T5Dims, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.dims = dims
        kw = dict(device=dev, dtype=dtype)
        self.shared = nn.Embedding(dims.vocab_size, dims.d_model, **kw)
        self.encoder = T5Stack(dims, dims.num_layers, False, **kw)
        frozen_eval(self)

    def forward(self, input_ids, attention_mask=None):
        return self.encoder(self.shared(input_ids.long()),
                            self_mask=extend_mask(attention_mask))


class T5Model(nn.Module):
    """Encoder + decoder without LM head: the T5-ANCE query tower
    (representation = decoder token-0 hidden state)."""

    def __init__(self, dims: T5Dims, num_decoder_layers: Optional[int] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        d = dims
        self.dims = d
        n_dec = num_decoder_layers or d.num_decoder_layers
        kw = dict(device=dev, dtype=dtype)
        self.shared = nn.Embedding(d.vocab_size, d.d_model, **kw)
        self.encoder = T5Stack(d, d.num_layers, False, **kw)
        self.decoder = T5Stack(d, n_dec, True, **kw)
        frozen_eval(self)

    def encode(self, input_ids, attention_mask=None):
        return self.encoder(self.shared(input_ids.long()),
                            self_mask=extend_mask(attention_mask))

    def decode(self, decoder_input_ids, enc_hidden,
               enc_attention_mask=None):
        embeds = self.shared(decoder_input_ids.long())
        l = decoder_input_ids.shape[1]
        return self.decoder(embeds,
                            self_mask=causal_mask(l, embeds.device),
                            enc_hidden=enc_hidden,
                            enc_mask=extend_mask(enc_attention_mask))

    def forward(self, input_ids, attention_mask=None,
                decoder_input_ids=None):
        enc = self.encode(input_ids, attention_mask)
        if decoder_input_ids is None:
            decoder_input_ids = torch.zeros(
                (input_ids.shape[0], 1), dtype=torch.int32,
                device=input_ids.device)
        return enc, self.decode(decoder_input_ids, enc, attention_mask)

    def first_token_rep(self, input_ids, attention_mask=None):
        """The ANCE embedding: decoder token-0 hidden state."""
        _, dec = self(input_ids, attention_mask)
        return dec[:, 0, :]
