"""Plain DeepSeek-V2 (multi-head latent attention, a dense first layer,
then routed top-k and shared experts) as a query tower, after DeepSeek's
``modeling_deepseek.py``, over a dict of weights named as the port's
``state_dict`` (HF's names without ``model.``, each layer's routed
experts stacked ``(E, ...)``).  The representation is the final norm's
output at each query's last real token (``rep``; padding on the right).

The configuration ``c`` holds HF ``config.json`` keys.  Where this file
departs from the published description, and why:

* the softmax scale is ``(d_n + d_r)^-1/2 * m^2`` with YaRN's
  ``m = 0.1 mscale_all_dim ln(factor) + 1``, as DeepSeek's own code and
  HF's ``deepseek_v3`` apply it; HF's ``deepseek_v2`` file (4.57) leaves
  ``m^2`` out;
* no LM head: the tower stops at the final norm, pooled at the last real
  token (RepLLaMA's pooling); the configuration keeps the first of the
  model's layers (one pipeline stage);
* masked scores get ``-1e9`` added, not ``-inf`` (a real query's row
  always holds its own token, so the softmax is the same);
* the routed experts are computed one expert at a time over the
  (token, choice) pairs that chose it (a boolean selection on the
  routing, no sort and no offsets): one token at a time would read every
  expert's weights once per token, which at the benchmark's sizes takes
  far longer than a run.  Each pair's output times its gate weight lands
  in its own slot, and a token's slots are summed in choice order, as a
  per-token loop sums them.

Plain ``torch`` in float32 (TF32 off, ``common.tf32_off``); ``P`` the
precision of the matrix products (``common.Precision``).
"""

from __future__ import annotations

import math

import torch

from .common import F32, rms_norm


def tower_specs(c):
    """Every matrix and the embedding normal at HF's std 0.02
    (``initializer_range``), norms ones, in the port's order."""
    H, h = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    r, E, I = c["kv_lora_rank"], c["n_routed_experts"], \
        c["moe_intermediate_size"]
    std = 0.02

    def mlp(p, inner):
        return [(p + "gate_proj.weight", (inner, H), "normal", std),
                (p + "up_proj.weight", (inner, H), "normal", std),
                (p + "down_proj.weight", (H, inner), "normal", std)]
    out = [("embed_tokens.weight", (c["vocab_size"], H), "normal", std)]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm.weight", (H,), "ones", None),
                (a + "q_proj.weight", (h * (dn + dr), H), "normal", std),
                (a + "kv_a_proj_with_mqa.weight", (r + dr, H), "normal",
                 std),
                (a + "kv_a_layernorm.weight", (r,), "ones", None),
                (a + "kv_b_proj.weight", (h * (dn + dv), r), "normal", std),
                (a + "o_proj.weight", (H, h * dv), "normal", std),
                (p + "post_attention_layernorm.weight", (H,), "ones", None)]
        m = p + "mlp."
        if i < c["first_k_dense_replace"]:
            out += mlp(m, c["intermediate_size"])
        else:
            out += [(m + "gate.weight", (E, H), "normal", std),
                    (m + "experts.gate_proj", (E, I, H), "normal", std),
                    (m + "experts.up_proj", (E, I, H), "normal", std),
                    (m + "experts.down_proj", (E, H, I), "normal", std)]
            out += mlp(m + "shared_experts.", c["n_shared_experts"] * I)
    out.append(("norm.weight", (H,), "ones", None))
    return out


def yarn(c):
    """(inv_freq (d_r / 2,) float64, softmax scale): YaRN's blend of
    ``f_j = theta^(-2j/d_r)`` and ``f_j / factor`` over the correction
    range, and ``(d_n + d_r)^-1/2 m^2``."""
    dr = c["qk_rope_head_dim"]
    theta = c["rope_theta"]
    rs = c["rope_scaling"]
    factor = rs["factor"]

    def corr(rot):
        return (dr * math.log(rs["original_max_position_embeddings"]
                              / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dr - 1)
    inv = []
    for j in range(dr // 2):
        f = theta ** (-2 * j / dr)
        g = min(max((j - low) / max(high - low, 1e-3), 0.0), 1.0)
        inv.append(f * (1 - g) + f / factor * g)
    m = 0.1 * rs["mscale_all_dim"] * math.log(factor) + 1 \
        if factor > 1 else 1.0
    scale = (c["qk_nope_head_dim"] + dr) ** -0.5 * m * m
    return torch.tensor(inv, dtype=torch.float64), scale


def rotate(x, ang):
    """Interleaved pairs of ``x`` (b, L, ..., d_r) as complex numbers
    times ``exp(i ang)``, ``ang`` (L, d_r / 2) (HF's
    ``apply_rotary_emb``)."""
    z = torch.view_as_complex(x.float().contiguous().reshape(
        *x.shape[:-1], -1, 2))
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (ang.shape[1],)
    rot = torch.polar(torch.ones_like(ang), ang).reshape(shape)
    return torch.view_as_real(z * rot).flatten(-2)


def swiglu(x, wg, wu, wd, P):
    return P.linear(torch.nn.functional.silu(P.linear(x, wg))
                    * P.linear(x, wu), wd)


def mla(W, a, c, x, ang, add, scale, P):
    b, L, _ = x.shape
    h = c["num_attention_heads"]
    dn, dr, dv, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"], c["kv_lora_rank"]
    q = P.linear(x, W[a + "q_proj.weight"]).reshape(b, L, h, dn + dr)
    ckv = P.linear(x, W[a + "kv_a_proj_with_mqa.weight"])
    lat = rms_norm(ckv[..., :r], W[a + "kv_a_layernorm.weight"],
                   c["rms_norm_eps"])
    kv = P.linear(lat, W[a + "kv_b_proj.weight"]).reshape(b, L, h, dn + dv)
    q_r = rotate(q[..., dn:], ang)
    k_r = rotate(ckv[..., r:], ang)                  # one head, shared
    s = (P.einsum("bqhd,bkhd->bhqk", q[..., :dn], kv[..., :dn])
         + P.einsum("bqhd,bkd->bhqk", q_r, k_r)) * scale + add
    p = torch.softmax(s, -1)
    o = P.einsum("bhqk,bkhd->bqhd", p, kv[..., dn:]).reshape(b, L, h * dv)
    return P.linear(o, W[a + "o_proj.weight"])


def moe(W, m, c, x, P):
    """Softmax gate over the routed experts (float32), the ``k`` highest
    taken greedily, not renormalised, times the scaling factor; each
    routed expert's SwiGLU over the tokens that chose it; the shared
    experts over every token."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    k = c["num_experts_per_tok"]
    s = torch.softmax(P.linear(x, W[m + "gate.weight"]), -1)
    w, idx = torch.topk(s, k, dim=-1)
    w = w * c["routed_scaling_factor"]
    slots = torch.zeros((x.shape[0], k, x.shape[1]), device=x.device)
    e_ = m + "experts."
    for e in range(c["n_routed_experts"]):
        t, j = (idx == e).nonzero(as_tuple=True)
        if t.numel():
            y = swiglu(x[t], W[e_ + "gate_proj"][e], W[e_ + "up_proj"][e],
                       W[e_ + "down_proj"][e], P)
            slots[t, j] = w[t, j, None] * y
    routed = slots[:, 0]
    for j in range(1, k):
        routed = routed + slots[:, j]
    sh = m + "shared_experts."
    shared = swiglu(x, W[sh + "gate_proj.weight"], W[sh + "up_proj.weight"],
                    W[sh + "down_proj.weight"], P)
    return (routed + shared).reshape(shape)


def rep(W, c, ids, mask, P=F32):
    """(b, d): the final norm's output at each query's last real token."""
    b, L = ids.shape
    eps = c["rms_norm_eps"]
    inv, scale = yarn(c)
    pos = torch.arange(L, dtype=torch.float64)
    ang = (pos[:, None] * inv[None, :]).float().to(ids.device)
    keep = torch.ones((L, L), dtype=torch.bool, device=ids.device).tril() \
        & (mask[:, None, None, :] > 0)
    add = (keep.float() - 1.0) * 1e9                 # (b, 1, L, L)
    x = W["embed_tokens.weight"].float()[ids.long()]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, W[p + "input_layernorm.weight"], eps)
        x = x + mla(W, p + "self_attn.", c, y, ang, add, scale, P)
        y = rms_norm(x, W[p + "post_attention_layernorm.weight"], eps)
        m = p + "mlp."
        if i < c["first_k_dense_replace"]:
            x = x + swiglu(y, W[m + "gate_proj.weight"],
                           W[m + "up_proj.weight"],
                           W[m + "down_proj.weight"], P)
        else:
            x = x + moe(W, m, c, y, P)
    last = mask.long().sum(1) - 1
    return rms_norm(x[torch.arange(b, device=ids.device), last],
                    W["norm.weight"], eps)
