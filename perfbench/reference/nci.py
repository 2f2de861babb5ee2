"""Plain NCI scorer: the T5 seq2seq model over a position-sliced code
vocabulary with the PAWA adaptive LM head (MEVI's ``main_models.py``),
teacher-forced along given code sequences.

Decode vocabulary ``V = kary * max_output_length + 2``: 0 is the start
token, 1 is EOS, code ``c`` of level ``t`` is ``2 + t * kary + c``.  At
position ``t`` the tree allows the level-``t`` codes and EOS; the logits
there are ``W[col] . s_t + h_t A[:, :, col] s_t`` over those columns,
with ``s_t`` the decoder state times ``d^-0.5`` (the tied head), ``h_t``
the PAWA adaptor's state (a post-norm transformer decoder over the
decode-token embeddings with one learned memory vector) and ``A`` the
adaptor kernel viewed as (d, d, V).  A hypothesis scores the sum of its
log-probabilities (log-softmax over the allowed columns, float32) over
its M codes and EOS, divided by ``(M + 1) ** length_penalty``.
"""

from __future__ import annotations

import math

import torch

from . import t5
from .common import F32, layer_norm


def specs(c):
    """The T5 parts at T5's init (``t5.stack_specs``; embeddings, the
    decode one too, at std 1, ``nn.Embedding``'s); PAWA and the adaptor
    kernel at the port's init (xavier-uniform in-projections, lecun-normal
    linears and kernel, a uniform [0, 1) memory vector)."""
    d = c["d_model"]
    pw = c["pawa"]
    V = c["kary"] * c["max_output_length"] + 2
    out = [("shared.weight", (c["vocab_size"], d), "normal", 1.0),
           ("decode_embeddings.weight", (V, d), "normal", 1.0),
           ("adaptor_kernel", (d, d * V), "normal", d ** -0.5),
           ("pawa.memory_embedding", (1, 1, d), "uniform", (0.0, 1.0))]
    out += t5.stack_specs("encoder", c, c["num_layers"], False)
    out += t5.stack_specs("decoder", c, c["num_decoder_layers"], True)
    bound = math.sqrt(6.0 / (4 * d))
    for i in range(pw["num_layers"]):
        b = f"pawa.layers.{i}."
        for a in ("self_attn", "cross_attn"):
            out += [(f"{b}{a}.in_proj_weight", (3 * d, d), "uniform",
                     (-bound, bound)),
                    (f"{b}{a}.in_proj_bias", (3 * d,), "zeros", None),
                    (f"{b}{a}.out_proj.weight", (d, d), "normal", d ** -0.5),
                    (f"{b}{a}.out_proj.bias", (d,), "zeros", None)]
        for n in ("norm1", "norm2", "norm3"):
            out += [(f"{b}{n}.weight", (d,), "ones", None),
                    (f"{b}{n}.bias", (d,), "zeros", None)]
        out += [(f"{b}linear1.weight", (pw["d_ff"], d), "normal", d ** -0.5),
                (f"{b}linear1.bias", (pw["d_ff"],), "zeros", None),
                (f"{b}linear2.weight", (d, pw["d_ff"]), "normal",
                 pw["d_ff"] ** -0.5),
                (f"{b}linear2.bias", (d,), "zeros", None)]
    return out


def _mha(W, a, c, x, kv, add, P):
    """``nn.MultiheadAttention`` (packed in-projection, 1/sqrt(dk))."""
    d, h = c["d_model"], c["pawa"]["num_heads"]
    dk = d // h
    w, bias = W[a + ".in_proj_weight"], W[a + ".in_proj_bias"]
    b, lq, _ = x.shape
    lk = kv.shape[1]
    q = P.linear(x, w[:d], bias[:d]).reshape(b, lq, h, dk)
    k = P.linear(kv, w[d:2 * d], bias[d:2 * d]).reshape(b, lk, h, dk)
    v = P.linear(kv, w[2 * d:], bias[2 * d:]).reshape(b, lk, h, dk)
    s = P.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    if add is not None:
        s = s + add
    o = P.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return P.linear(o.reshape(b, lq, d), W[a + ".out_proj.weight"],
                    W[a + ".out_proj.bias"])


def pawa(W, c, emb, P=F32):
    """PAWA states (b, L, d) over decode-token embeddings (b, L, d)."""
    b, L, d = emb.shape
    eps = c["pawa"]["layer_norm_epsilon"]
    causal = torch.ones(L, L, dtype=torch.bool, device=emb.device).tril()
    add = torch.zeros(L, L, device=emb.device).masked_fill(~causal,
                                                           float("-inf"))
    mem = W["pawa.memory_embedding"].float().expand(b, 1, d)
    x = emb.float()
    for i in range(c["pawa"]["num_layers"]):
        p = f"pawa.layers.{i}."

        def ln(n, y):
            return layer_norm(y, W[p + n + ".weight"], W[p + n + ".bias"], eps)
        x = ln("norm1", x + _mha(W, p + "self_attn", c, x, x, add, P))
        x = ln("norm2", x + _mha(W, p + "cross_attn", c, x, mem, None, P))
        y = torch.relu(P.linear(x, W[p + "linear1.weight"],
                                W[p + "linear1.bias"]))
        x = ln("norm3", x + P.linear(y, W[p + "linear2.weight"],
                                     W[p + "linear2.bias"]))
    return x


def level_logp(W, c, ids, mask, codes, P=F32):
    """Teacher-forced log-probabilities.  ids, mask (b, Lq); codes
    (b, H, M) -> (b, H, M + 1, K + 1): at position t (the start token
    and the first t codes fed), log-softmax over [level-t codes, EOS]."""
    K, M = c["kary"], c["code_len"]
    d = c["d_model"]
    b, H, _ = codes.shape
    V = K * c["max_output_length"] + 2
    enc = t5.encode(W, c, ids, mask, P)
    toks = codes.long() + 2 + torch.arange(M, device=codes.device) * K
    toks = torch.cat([torch.zeros_like(toks[..., :1]), toks], -1)
    toks = toks.reshape(b * H, M + 1)
    emb_table = W["decode_embeddings.weight"]
    enc_rep = enc.repeat_interleave(H, 0)
    mask_rep = mask.repeat_interleave(H, 0)
    dec = t5.decode(W, c, toks, emb_table, enc_rep, mask_rep,
                    c["num_decoder_layers"], P)
    s = dec * d ** -0.5
    h = pawa(W, c, emb_table.float()[toks], P)
    A = W["adaptor_kernel"].reshape(d, d, V)
    out = []
    for t in range(M + 1):
        cols = torch.cat([torch.arange(2 + t * K, 2 + (t + 1) * K),
                          torch.tensor([1])]).to(codes.device)
        logits = P.linear(s[:, t], W["decode_embeddings.weight"][cols])
        tmp = P.einsum("bi,ijk->bjk", h[:, t], A[:, :, cols])
        logits = logits + P.einsum("bjk,bj->bk", tmp, s[:, t])
        out.append(torch.log_softmax(logits, -1))
    return torch.stack(out, 1).reshape(b, H, M + 1, K + 1)


def path_scores(logp, codes, length_penalty):
    """From :func:`level_logp`: (normalized scores of the hypotheses
    (b, H), cumulative score of every last-level extension of each
    hypothesis's parent (b, H, K))."""
    M = codes.shape[-1]
    K = logp.shape[-1] - 1
    picked = torch.gather(logp[..., :M, :K], -1,
                          codes.long()[..., None])[..., 0]     # (b, H, M)
    cum = picked.sum(-1)
    norm = (cum + logp[..., M, K]) / float(M + 1) ** length_penalty
    ext = picked[..., :M - 1].sum(-1, keepdim=True) + logp[..., M - 1, :K]
    return norm, ext
