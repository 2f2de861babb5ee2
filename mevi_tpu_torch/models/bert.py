"""BERT/ERNIE encoder in PyTorch (port of ``mevi_tpu.models.bert``),
numerically matching HF, so AR2 and coCondenser checkpoints carry over.

The twin tower's representation for the BERT family is the CLS
(token 0) hidden state.  Dropout sits on the embeddings, the attention
probabilities and each sub-layer's output, active in ``train()`` mode
only; a model is built in ``eval()`` mode with frozen parameters.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import frozen_eval, resolve_device


@dataclasses.dataclass(frozen=True)
class BertDims:
    vocab_size: int = 30522
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_epsilon: float = 1e-12
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32   # compute dtype


class BertEmbeddings(nn.Module):
    def __init__(self, dims: BertDims, device=None, dtype=None):
        super().__init__()
        d = dims
        kw = dict(device=device, dtype=dtype)
        self.word = nn.Embedding(d.vocab_size, d.d_model, **kw)
        self.position = nn.Embedding(d.max_position_embeddings, d.d_model,
                                     **kw)
        self.token_type = nn.Embedding(d.type_vocab_size, d.d_model, **kw)
        self.norm = nn.LayerNorm(d.d_model, eps=d.layer_norm_epsilon, **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, input_ids, token_type_ids=None):
        ids = input_ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = self.word(ids) + self.position(pos) \
            + self.token_type(token_type_ids.long())
        return self.dropout(self.norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, dims: BertDims, device=None, dtype=None):
        super().__init__()
        d = dims
        self.dims = d
        kw = dict(device=device, dtype=dtype)
        self.query = nn.Linear(d.d_model, d.d_model, **kw)
        self.key = nn.Linear(d.d_model, d.d_model, **kw)
        self.value = nn.Linear(d.d_model, d.d_model, **kw)
        self.out = nn.Linear(d.d_model, d.d_model, **kw)
        self.norm = nn.LayerNorm(d.d_model, eps=d.layer_norm_epsilon, **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, hidden, mask=None):
        d = self.dims
        b, l, _ = hidden.shape
        dk = d.d_model // d.num_heads

        def heads(lin):                 # heads-last (b, l, h, dk)
            return lin(hidden).reshape(b, l, d.num_heads, dk)
        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
            math.sqrt(dk), dtype=torch.float32).to(q.dtype)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", self.dropout(probs), v)
        out = self.dropout(self.out(ctx.reshape(b, l, d.d_model)))
        return self.norm(hidden + out)


class BertLayer(nn.Module):
    def __init__(self, dims: BertDims, device=None, dtype=None):
        super().__init__()
        d = dims
        kw = dict(device=device, dtype=dtype)
        self.attn = BertSelfAttention(d, **kw)
        self.ff_intermediate = nn.Linear(d.d_model, d.d_ff, **kw)
        self.ff_out = nn.Linear(d.d_ff, d.d_model, **kw)
        self.ff_norm = nn.LayerNorm(d.d_model, eps=d.layer_norm_epsilon,
                                    **kw)
        self.dropout = nn.Dropout(d.dropout_rate)

    def forward(self, hidden, mask=None):
        hidden = self.attn(hidden, mask)
        inter = F.gelu(self.ff_intermediate(hidden), approximate="none")
        out = self.dropout(self.ff_out(inter))
        return self.ff_norm(hidden + out)


class BertEncoderModel(nn.Module):
    def __init__(self, dims: BertDims, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.dims = dims
        self.embeddings = BertEmbeddings(dims, device=dev, dtype=dtype)
        self.layers = nn.ModuleList(
            BertLayer(dims, device=dev, dtype=dtype)
            for _ in range(dims.num_layers))
        frozen_eval(self)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            mask = torch.where(attention_mask[:, None, None, :] > 0, zero,
                               zero - 1e9)
        for layer in self.layers:
            x = layer(x, mask)
        return x

    def cls_rep(self, input_ids, attention_mask=None, token_type_ids=None):
        """CLS representation (``document_encoder.py:113-120``)."""
        return self(input_ids, attention_mask, token_type_ids)[:, 0, :]
