"""Plain BERT encoder (post-LayerNorm, scaled attention, exact GELU) as
HF's ``modeling_bert`` defines it, over a dict of weights named as the
port's ``state_dict``.  The AR2 query representation is the CLS (token
0) state."""

from __future__ import annotations

import math

import torch

from .common import F32, additive_mask, layer_norm


def tower_specs(c):
    """BERT at HF's init: every matrix at std ``initializer_range``
    (0.02), biases 0, LayerNorms 1 and 0."""
    d, ff = c["d_model"], c["d_ff"]
    std = c["initializer_range"]
    out = [("embeddings.word.weight", (c["vocab_size"], d), "normal", std),
           ("embeddings.position.weight", (c["max_position_embeddings"], d),
            "normal", std),
           ("embeddings.token_type.weight", (c["type_vocab_size"], d),
            "normal", std),
           ("embeddings.norm.weight", (d,), "ones", None),
           ("embeddings.norm.bias", (d,), "zeros", None)]
    for i in range(c["num_layers"]):
        b = f"layers.{i}."
        for m in ("query", "key", "value", "out"):
            out += [(f"{b}attn.{m}.weight", (d, d), "normal", std),
                    (f"{b}attn.{m}.bias", (d,), "zeros", None)]
        out += [(f"{b}attn.norm.weight", (d,), "ones", None),
                (f"{b}attn.norm.bias", (d,), "zeros", None),
                (f"{b}ff_intermediate.weight", (ff, d), "normal", std),
                (f"{b}ff_intermediate.bias", (ff,), "zeros", None),
                (f"{b}ff_out.weight", (d, ff), "normal", std),
                (f"{b}ff_out.bias", (d,), "zeros", None),
                (f"{b}ff_norm.weight", (d,), "ones", None),
                (f"{b}ff_norm.bias", (d,), "zeros", None)]
    return out


def rep(W, c, ids, mask, P=F32):
    """(b, d) CLS states (the port's ``cls_rep``); token types all 0."""
    d, h = c["d_model"], c["num_heads"]
    dk = d // h
    eps = c["layer_norm_epsilon"]
    b, L = ids.shape
    pos = torch.arange(L, device=ids.device)
    x = (W["embeddings.word.weight"].float()[ids.long()]
         + W["embeddings.position.weight"].float()[pos][None]
         + W["embeddings.token_type.weight"].float()[0])
    x = layer_norm(x, W["embeddings.norm.weight"],
                   W["embeddings.norm.bias"], eps)
    add = additive_mask(mask)
    for i in range(c["num_layers"]):
        p = f"layers.{i}."

        def lin(name, y):
            return P.linear(y, W[p + name + ".weight"], W[p + name + ".bias"])
        q = lin("attn.query", x).reshape(b, L, h, dk)
        k = lin("attn.key", x).reshape(b, L, h, dk)
        v = lin("attn.value", x).reshape(b, L, h, dk)
        s = P.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk) + add
        o = P.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = layer_norm(x + lin("attn.out", o.reshape(b, L, d)),
                       W[p + "attn.norm.weight"], W[p + "attn.norm.bias"],
                       eps)
        y = torch.nn.functional.gelu(lin("ff_intermediate", x))
        x = layer_norm(x + lin("ff_out", y), W[p + "ff_norm.weight"],
                       W[p + "ff_norm.bias"], eps)
    return x[:, 0]
