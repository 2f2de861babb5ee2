"""The DeepSeek-V2 query tower (DeepSeek-V2-Lite as a decoder embedder):
multi-head latent attention, a dense first layer, then routed top-k and
shared experts; the representation the final norm's output at the last
real token (``last_token_rep``).  The configuration's ``tower`` keys are
HF ``config.json`` keys.

In traced runs the model's attention and MoE blocks open the harness
ranges ``pb.mla`` and ``pb.moe`` (while a profiler is active, as
``harness.add_ranges`` wraps the server), at the places of the program's
own ``tower.mla`` and ``tower.moe`` spans; ``metrics/mla_device_ms``,
``moe_device_ms`` and ``moe_roofline`` read them.
"""

from perfbench import counts

TINY = {"family": "deepseek_v2", "rep": "last_token_rep",
        "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 2,
        "first_k_dense_replace": 1, "routed_scaling_factor": 1.0,
        "rms_norm_eps": 1e-06, "rope_theta": 10000,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}


def _add_range(module, name):
    """Hooks that open ``pb.<name>`` around each call of ``module`` while
    a profiler is active (hooks, not a wrapped ``forward``: a module
    holding a bound method of itself is a reference cycle, which keeps
    its weights alive past the run's ``del`` until a garbage
    collection)."""
    import torch
    from torch.profiler import record_function
    open_ranges = []

    def enter(mod, args):
        r = None
        if torch.autograd._profiler_enabled():
            r = record_function("pb." + name)
            r.__enter__()
        open_ranges.append(r)

    def leave(mod, args, out):
        r = open_ranges.pop()
        if r is not None:
            r.__exit__(None, None, None)
    module.register_forward_pre_hook(enter)
    module.register_forward_hook(leave, always_call=True)


def build(c, W, dev, dtype):
    import torch
    from mevi_tpu_torch.models.deepseek_v2 import (DeepseekV2Dims,
                                                   DeepseekV2Model)
    if dev.type == "cuda":
        # The weights' float32 draw (``weights.make``, 4.8 G values,
        # 17.9 GiB) has just been freed: give its segment back, so that
        # the tower is not carved out of it, and let later segments map
        # and unmap memory page by page.  Otherwise the blocks of the
        # serving window that outlive it pin whole segments, and the
        # reference's own 17.9 GiB draw finds no room beside a traced
        # run's server (which the harness's ranges keep alive in a
        # reference cycle until a garbage collection).  The
        # configuration's ``deployment`` states the setting; no other
        # cell uses it.
        torch.cuda.empty_cache()
        settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           None) or torch.cuda.memory._set_allocator_settings
        settings("expandable_segments:True")
    tower = DeepseekV2Model(DeepseekV2Dims.from_config(c), device=dev,
                            dtype=dtype)
    tower.load_state_dict(W)
    for i, layer in enumerate(tower.layers):
        _add_range(layer.self_attn, "mla")
        if i >= c["first_k_dense_replace"]:
            _add_range(layer.mlp, "moe")
    return tower.last_token_rep


def _swiglu(d, inner):
    return 2 * 3 * d * inner


def moe_layers(c):
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def moe_token_flops(c):
    """One token through one MoE block: the gate, its routed experts and
    the shared experts."""
    d, inner = c["hidden_size"], c["moe_intermediate_size"]
    return (2 * c["n_routed_experts"] * d
            + c["num_experts_per_tok"] * _swiglu(d, inner)
            + _swiglu(d, c["n_shared_experts"] * inner))


def moe_counts(c, tokens, itemsize):
    """(bytes, operations) of the MoE blocks over a batch of ``tokens``:
    every routed, shared and gate weight read once and each block's
    token rows read and written once; the gate's, the routed
    (row, expert) pairs' and the shared experts' products."""
    d, inner, E = c["hidden_size"], c["moe_intermediate_size"], \
        c["n_routed_experts"]
    weights = (E * 3 * d * inner + 3 * d * c["n_shared_experts"] * inner
               + E * d)
    per_layer = weights * itemsize + 2 * tokens * d * itemsize
    n = moe_layers(c)
    return n * per_layer, n * tokens * moe_token_flops(c)


def flops(lengths, c):
    """Per real token: MLA's projections and attention over the query's
    own tokens, the dense SwiGLU or an MoE block a layer."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"], c["kv_lora_rank"]
    proj = 2 * d * (h * (dn + dr) + r + dr) + 2 * r * h * (dn + dv) \
        + 2 * h * dv * d
    dense = c["first_k_dense_replace"]
    total = 0
    for l in lengths:
        l = int(l)
        att = 2 * h * l * l * (dn + dr + dv)
        total += c["num_hidden_layers"] * (l * proj + att)
        total += l * (dense * _swiglu(d, c["intermediate_size"])
                      + moe_layers(c) * moe_token_flops(c))
    return total


def moe_least_seconds(c, tokens, itemsize):
    """The MoE blocks' least time over a batch (``counts.least_seconds``)."""
    return counts.least_seconds(*moe_counts(c, tokens, itemsize))
