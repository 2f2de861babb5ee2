"""Plain T5 (v1.0: ReLU feed-forward, RMSNorm, unscaled attention,
relative position bias in each stack's first block, shared onward) as
HF's ``modeling_t5`` defines it, over a dict of weights named as the
port's ``state_dict``.  The T5-ANCE query representation is the decoder's
state at its start token (``rep``, the port's ``first_token_rep``)."""

from __future__ import annotations

import math

import torch

from .common import F32, additive_mask, rms_norm


def stack_specs(prefix, c, n_layers, decoder):
    """A stack's weights at T5's own init scales (HF ``T5PreTrainedModel.
    _init_weights``): q at ``(d * d_kv) ** -0.5``, which folds in the
    attention's missing ``1 / sqrt(d_kv)``; k, v, wi and the relative
    bias at ``d ** -0.5``; o at ``inner ** -0.5``; wo at ``d_ff ** -0.5``."""
    d, inner, ff, h = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"], \
        c["num_heads"]
    out = []
    for i in range(n_layers):
        b = f"{prefix}.blocks.{i}."
        atts = ["self_attn"] + (["cross_attn"] if decoder else [])
        for a in atts:
            out.append((f"{b}{a}.q.weight", (inner, d), "normal",
                        (d * c["d_kv"]) ** -0.5))
            for m in "kv":
                out.append((f"{b}{a}.{m}.weight", (inner, d), "normal",
                            d ** -0.5))
            out.append((f"{b}{a}.o.weight", (d, inner), "normal",
                        inner ** -0.5))
        if i == 0:
            out.append((f"{b}self_attn.relative_attention_bias.weight",
                        (c["relative_attention_num_buckets"], h), "normal",
                        d ** -0.5))
        norms = ["self_norm", "ff_norm"] + (["cross_norm"] if decoder else [])
        out += [(f"{b}{n}.weight", (d,), "ones", None) for n in norms]
        out.append((f"{b}ff.wi.weight", (ff, d), "normal", d ** -0.5))
        out.append((f"{b}ff.wo.weight", (d, ff), "normal", ff ** -0.5))
    out.append((f"{prefix}.final_norm.weight", (d,), "ones", None))
    return out


def tower_specs(c):
    """T5 (HF init: the shared embedding at std 1)."""
    return ([("shared.weight", (c["vocab_size"], c["d_model"]), "normal",
              1.0)]
            + stack_specs("encoder", c, c["num_layers"], False)
            + stack_specs("decoder", c, c["num_decoder_layers"], True))


def rel_bucket(rel, bidirectional, num_buckets, max_distance):
    """HF T5 ``_relative_position_bucket``; ``rel`` = key - query."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).long() * num_buckets
        n = rel.abs()
    else:
        n = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float().clamp(min=1) / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def position_bias(W, prefix, c, q_len, k_len, bidirectional, device):
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    b = rel_bucket(mem - ctx, bidirectional,
                   c["relative_attention_num_buckets"],
                   c["relative_attention_max_distance"])
    table = W[f"{prefix}.blocks.0.self_attn.relative_attention_bias.weight"]
    return table.float()[b].permute(2, 0, 1)[None]      # (1, h, q, k)


def attention(W, a, c, x, kv, add, P):
    """Unscaled multi-head attention; ``add`` (b|1, h|1, q, k) additive."""
    b, lq, _ = x.shape
    lk = kv.shape[1]
    h, dk = c["num_heads"], c["d_kv"]
    q = P.linear(x, W[a + ".q.weight"]).reshape(b, lq, h, dk)
    k = P.linear(kv, W[a + ".k.weight"]).reshape(b, lk, h, dk)
    v = P.linear(kv, W[a + ".v.weight"]).reshape(b, lk, h, dk)
    s = P.einsum("bqhd,bkhd->bhqk", q, k) + add
    p = torch.softmax(s, -1)
    o = P.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, lq, h * dk)
    return P.linear(o, W[a + ".o.weight"])


def run_stack(W, prefix, c, n_layers, x, self_add, enc=None, enc_add=None,
              P=F32):
    """A T5 stack over embeddings ``x``; ``self_add`` includes the
    position bias and the mask."""
    eps = c["layer_norm_epsilon"]
    x = x.float()
    for i in range(n_layers):
        b = f"{prefix}.blocks.{i}."
        y = rms_norm(x, W[b + "self_norm.weight"], eps)
        x = x + attention(W, b + "self_attn", c, y, y, self_add, P)
        if enc is not None:
            y = rms_norm(x, W[b + "cross_norm.weight"], eps)
            x = x + attention(W, b + "cross_attn", c, y, enc, enc_add, P)
        y = rms_norm(x, W[b + "ff_norm.weight"], eps)
        y = torch.relu(P.linear(y, W[b + "ff.wi.weight"]))
        x = x + P.linear(y, W[b + "ff.wo.weight"])
    return rms_norm(x, W[f"{prefix}.final_norm.weight"], eps)


def encode(W, c, ids, mask, P=F32, emb="shared.weight", prefix="encoder"):
    L = ids.shape[1]
    add = position_bias(W, prefix, c, L, L, True, ids.device) \
        + additive_mask(mask)
    x = W[emb].float()[ids.long()]
    return run_stack(W, prefix, c, c["num_layers"], x, add, P=P)


def decode(W, c, tokens, emb_table, enc, enc_mask, n_layers, P=F32,
           prefix="decoder"):
    """Causal decoder over ``tokens`` (b, L) against ``enc`` (b, Lk, d)."""
    L = tokens.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=tokens.device).tril()
    add = position_bias(W, prefix, c, L, L, False, tokens.device) \
        + (causal.float() - 1.0) * 1e9
    x = emb_table.float()[tokens.long()]
    return run_stack(W, prefix, c, n_layers, x, add, enc,
                     additive_mask(enc_mask), P)


def rep(W, c, ids, mask, P=F32):
    """(b, d): the decoder's hidden state at its start token 0."""
    enc = encode(W, c, ids, mask, P)
    start = torch.zeros((ids.shape[0], 1), dtype=torch.long,
                        device=ids.device)
    return decode(W, c, start, W["shared.weight"], enc, mask,
                  c["num_decoder_layers"], P)[:, 0]
