"""The port's DeepSeek-V2 query tower (``mevi_tpu_torch.models.deepseek_v2``)
against the plain reference (``tests/plain_deepseek_v2.py``) at a tiny
seeded size: hidden 64, 4 heads, ``kv_lora_rank`` 16, qk 16 + 8, v 16,
8 routed experts top-2 plus 2 shared, one dense and two MoE layers,
vocabulary 128.  Also: pooling at the last real token of right-padded
queries, the grouped expert products against a per-token loop, YaRN at
the published sizes, the tower served through ``BucketServer`` from an
``EncoderConfig``, the HF checkpoint converter, and the two copies of
the reference.  On the card (``cuda``, skips without one): the expert
layer at full width against the plain grouped loop, and no host sync
in the tower."""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plain_deepseek_v2 as plain
from mevi_tpu_torch.config import EncoderConfig
from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.models import convert
from mevi_tpu_torch.models.deepseek_v2 import (DeepseekV2Dims,
                                               DeepseekV2Model, MoE,
                                               yarn_inv_freq)
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims
from mevi_tpu_torch.models.twin_tower import make_tower, tower_from_config
from mevi_tpu_torch.ops.grouped import grouped_mm, grouped_mm_plain
from mevi_tpu_torch.serve import BucketServer

# HF config.json keys of the tiny tower
TINY = {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
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
DIMS = DeepseekV2Dims.from_config(TINY)


def _weights(model, seed, std=0.02):
    """Seeded normal weights at HF's std (norms: 1 + a small spread, so
    that a wrong norm weight shows), written into ``model``; returns its
    state dict in float32."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            else:
                v = std * torch.randn(p.shape, generator=g)
            p.copy_(v.to(p.dtype))
    return {k: v.float() for k, v in model.state_dict().items()}


def _model(dtype=torch.float32, seed=0, dims=DIMS):
    m = DeepseekV2Model(dims, device="cpu", dtype=dtype)
    return m, _weights(m, seed)


def _queries(seed, b=6, L=9, lengths=None):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY["vocab_size"], (b, L), generator=g)
    if lengths is None:
        lengths = torch.randint(1, L + 1, (b,), generator=g)
    mask = (torch.arange(L)[None] < torch.as_tensor(lengths)[:, None]).int()
    return ids * mask, mask


def _rel(a, b):
    return float(((a.float() - b.float()).norm(dim=-1)
                  / b.float().norm(dim=-1)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_agrees_with_the_plain_reference(seed):
    m, W = _model(seed=seed)
    ids, mask = _queries(seed + 10)
    got = m.last_token_rep(ids, mask)
    want = plain.rep(W, TINY, ids, mask)
    assert _rel(got, want) < 1e-5


def test_bfloat16_agrees_with_the_plain_reference():
    # bf16 weights and activations (8 bits of mantissa, 2^-9 relative
    # rounding per operand) through 3 layers; the reference computes in
    # float32 on the same bf16-rounded weights.  Errors add up over ~10
    # rounded products a layer to ~1e-2 of the norm; a near-tie between
    # the 2nd and 3rd expert can route one token differently, which
    # moves its row by about that much too.  A float32 product slip
    # (a wrong weight, head or rotation) moves it by O(1).
    m, W = _model(dtype=torch.bfloat16, seed=3)
    ids, mask = _queries(13, b=16)
    got = m.last_token_rep(ids, mask)
    assert got.dtype == torch.bfloat16
    assert _rel(got, plain.rep(W, TINY, ids, mask)) < 0.03


def test_pooling_at_the_last_real_token_of_right_padded_queries():
    m, W = _model(seed=4)
    lengths = [1, 3, 9, 5]
    ids, mask = _queries(14, b=4, L=9, lengths=lengths)
    got = m.last_token_rep(ids, mask)
    for i, n in enumerate(lengths):
        alone = m.last_token_rep(ids[i:i + 1, :n], mask[i:i + 1, :n])
        torch.testing.assert_close(got[i:i + 1], alone, rtol=1e-5,
                                   atol=1e-6)
    full = m(ids, mask)
    torch.testing.assert_close(got, full[torch.arange(4),
                                         torch.tensor(lengths) - 1])
    assert _rel(got, plain.rep(W, TINY, ids, mask)) < 1e-5


def _per_token_moe(moe: MoE, x):
    """The MoE block one token at a time: each token's chosen experts'
    SwiGLUs in float32, summed with their gate weights."""
    E = moe.experts
    out = []
    for t in range(x.shape[0]):
        xt = x[t:t + 1].float()
        s = torch.softmax(xt @ moe.gate.weight.float().T, -1)[0]
        w, idx = torch.topk(s, moe.dims.num_experts_per_tok)
        y = torch.zeros_like(xt)
        for wj, e in zip(w.tolist(), idx.tolist()):
            a = xt @ E.gate_proj[e].float().T
            u = xt @ E.up_proj[e].float().T
            y = y + wj * ((torch.nn.functional.silu(a) * u)
                          @ E.down_proj[e].float().T)
        sh = moe.shared_experts
        y = y + (torch.nn.functional.silu(xt @ sh.gate_proj.weight.float().T)
                 * (xt @ sh.up_proj.weight.float().T)) \
            @ sh.down_proj.weight.float().T
        out.append(y)
    return torch.cat(out)


def _skewed_moe(dtype):
    """An MoE block whose every token picks expert 5 and none picks
    expert 2: tokens share a direction the gate weighs."""
    torch.manual_seed(7)
    moe = MoE(DIMS, device="cpu", dtype=dtype)
    _weights(moe, 7)
    u = torch.randn(64)
    u = u / u.norm()
    x = 0.3 * torch.randn(40, 64) + 3.0 * u
    with torch.no_grad():
        w = moe.gate.weight.float()
        w[5] += 4.0 * u
        w[2] -= 4.0 * u
        moe.gate.weight.copy_(w.to(dtype))
    return moe, x.to(dtype)


def test_grouped_dispatch_matches_the_per_token_loop():
    moe, x = _skewed_moe(torch.float32)
    y = moe(x[None])[0]
    rows = moe.expert_rows
    assert rows.dtype == torch.int32 and int(rows.sum()) == 40 * 2
    assert int(rows[2]) == 0 and int(rows[5]) == 40
    assert int(rows.argmax()) == 5
    torch.testing.assert_close(y, _per_token_moe(moe, x), rtol=1e-5,
                               atol=1e-6)


def test_grouped_product_matches_the_plain_grouped_loop():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(50, 64, generator=g)
    w = torch.randn(6, 32, 64, generator=g)
    ends = torch.tensor([0, 20, 20, 21, 49, 50], dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        got = grouped_mm(x.to(dt), w.to(dt), ends)
        want = grouped_mm_plain(x.to(dt).float(), w.to(dt).float(), ends)
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want,
                                   rtol=1e-5 if dt == torch.float32
                                   else 1e-2, atol=1e-4 if
                                   dt == torch.float32 else 5e-2)


def test_yarn_at_the_published_sizes():
    d = DeepseekV2Dims()
    inv = yarn_inv_freq(d).double()
    f = torch.tensor([10000.0 ** (-2 * j / 64) for j in range(32)],
                     dtype=torch.float64)
    gamma = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = f * (1 - gamma) + f / 40 * gamma
    torch.testing.assert_close(inv, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[:11], f[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[23:], f[23:] / 40, rtol=1e-6, atol=0)
    assert d.softmax_scale == pytest.approx(0.1147214, abs=1e-7)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.260804, abs=1e-6)
    ref_inv, ref_scale = plain.yarn({**TINY, "qk_rope_head_dim": 64,
                                     "qk_nope_head_dim": 128})
    torch.testing.assert_close(ref_inv, want, rtol=1e-12, atol=0)
    assert ref_scale == pytest.approx(d.softmax_scale, rel=1e-12)


def test_dims_refuse_what_the_port_does_not_compute():
    assert DeepseekV2Dims.from_config(
        {"rope_scaling": TINY["rope_scaling"]}) == DeepseekV2Dims()
    for k, v in (("q_lora_rank", 1536), ("topk_method", "noaux_tc"),
                 ("scoring_func", "sigmoid"), ("norm_topk_prob", True),
                 ("num_key_value_heads", 1), ("rope_scaling", None),
                 ("rope_scaling", {"type": "linear", "factor": 4.0})):
        with pytest.raises(ValueError, match=k):
            DeepseekV2Dims.from_config({**TINY, k: v})
    with pytest.raises(ValueError, match="rope_scaling"):
        DeepseekV2Dims.from_config({k: v for k, v in TINY.items()
                                    if k != "rope_scaling"})


def test_the_two_reference_copies_agree_exactly():
    from perfbench.reference import deepseek_v2 as bench_ref
    m, W = _model(seed=5)
    ids, mask = _queries(15)
    a = plain.rep(W, TINY, ids, mask)
    b = bench_ref.rep(W, TINY, ids, mask)
    assert torch.equal(a, b)
    names = [s[0] for s in bench_ref.tower_specs(TINY)]
    assert names == list(m.state_dict())


def _encoder_config():
    return EncoderConfig(family="deepseek_v2", d_model=64, num_layers=3,
                         num_heads=4, d_ff=96, vocab_size=128,
                         layer_norm_epsilon=1e-6,
                         deepseek_v2={k: v for k, v in TINY.items()
                                      if k not in ("hidden_size",
                                                   "vocab_size")})


def test_tower_from_config_served_through_bucket_server():
    tower = tower_from_config(_encoder_config(), device="cpu")
    assert tower.family == "deepseek_v2"
    assert tower.module.dims == DIMS
    W = _weights(tower.module, 6)
    torch.manual_seed(0)
    t5 = T5Dims(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nci = NCIT5(NCIDims(t5=t5, kary=4, max_output_length=6,
                        adaptor_layer_num=1, adaptor_num_heads=4,
                        adaptor_d_ff=32), device="cpu")
    with torch.no_grad():
        for p in nci.parameters():
            p.copy_(0.2 * torch.randn(p.shape))
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(512, 64)).astype(np.float32)
    codes = rng.integers(0, 4, size=(512, 4)).astype(np.int32)
    index = build_fine_index(codes, emb, 4, device="cpu")
    srv = BucketServer(SimpleNamespace(first_token_rep=tower.rep), nci,
                       index, num_beams=3, cap=16, pool=10, device="cpu")
    ids, mask = _queries(16, b=5, L=8)
    scores, docs, _, _, ndoc = srv.finalize(srv.query_device(ids, mask))
    q = plain.rep(W, TINY, ids, mask)
    assert (ndoc > 0).all()
    for i in range(5):
        n = int(ndoc[i])
        want = emb[docs[i, :n]] @ q[i].numpy()
        np.testing.assert_allclose(scores[i, :n], want, rtol=1e-4,
                                   atol=1e-4)
        assert (np.diff(scores[i, :n]) <= 0).all()


def test_encoder_config_keeps_the_other_families_json_and_key():
    from mevi_tpu_torch.config import MEVIConfig
    cfg = MEVIConfig()
    assert "deepseek_v2" not in cfg.to_json()
    ds = MEVIConfig(encoder=_encoder_config())
    back = MEVIConfig.from_json(ds.to_json())
    assert back.encoder == ds.encoder
    assert ds.artifact_key("x") != cfg.artifact_key("x")
    with pytest.raises(ValueError, match="contradict"):
        tower_from_config(dataclasses.replace(
            _encoder_config(), deepseek_v2={"hidden_size": 32}),
            device="cpu")
    assert make_tower("deepseek_v2", DIMS, device="cpu").family == \
        "deepseek_v2"


def _hf_state_dict(seed, n_layers=3):
    """A synthetic HF DeepSeek-V2 checkpoint at the tiny size, experts one
    module each, with an LM head the tower does not keep."""
    d, h = 64, 4
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g)
    sd = {"model.embed_tokens.weight": r(128, d), "model.norm.weight": r(d),
          "lm_head.weight": r(128, d)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        sd.update({p + "input_layernorm.weight": r(d),
                   p + "post_attention_layernorm.weight": r(d),
                   a + "q_proj.weight": r(h * 24, d),
                   a + "kv_a_proj_with_mqa.weight": r(24, d),
                   a + "kv_a_layernorm.weight": r(16),
                   a + "kv_b_proj.weight": r(h * 32, 16),
                   a + "o_proj.weight": r(d, h * 16)})
        m = p + "mlp."
        if i == 0:
            sd.update({m + "gate_proj.weight": r(96, d),
                       m + "up_proj.weight": r(96, d),
                       m + "down_proj.weight": r(d, 96)})
            continue
        sd[m + "gate.weight"] = r(8, d)
        for e in range(8):
            sd.update({f"{m}experts.{e}.gate_proj.weight": r(32, d),
                       f"{m}experts.{e}.up_proj.weight": r(32, d),
                       f"{m}experts.{e}.down_proj.weight": r(d, 32)})
        sd.update({m + "shared_experts.gate_proj.weight": r(64, d),
                   m + "shared_experts.up_proj.weight": r(64, d),
                   m + "shared_experts.down_proj.weight": r(d, 64)})
    return sd


def test_convert_maps_an_hf_checkpoint_with_stacked_experts():
    sd = _hf_state_dict(9)
    out = convert.convert_deepseek_v2(sd, num_layers=3)
    m = DeepseekV2Model(DIMS, device="cpu")
    m.load_state_dict(out)                       # strict: names and shapes
    assert torch.equal(out["layers.2.mlp.experts.up_proj"][5],
                       sd["model.layers.2.mlp.experts.5.up_proj.weight"])
    assert torch.equal(out["layers.1.self_attn.kv_b_proj.weight"],
                       sd["model.layers.1.self_attn.kv_b_proj.weight"])
    assert "lm_head.weight" not in out
    # a pipeline stage: the first layers only, with the final norm
    cut = convert.convert_deepseek_v2(sd, num_layers=2)
    assert not any(k.startswith("layers.2.") for k in cut)
    assert torch.equal(cut["norm.weight"], sd["model.norm.weight"])
    assert torch.equal(convert.convert_tower(sd, "deepseek_v2", 3)[
        "layers.1.mlp.experts.down_proj"], out["layers.1.mlp.experts.down_proj"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_full_width_experts_and_no_host_sync_on_the_card(cuda_device):
    """The expert layer at DeepSeek-V2-Lite's widths over 4,096 tokens
    against the plain grouped loop; a two-layer tower at full width
    under CUDA's sync debug mode, which raises on a synchronising op."""
    d = DeepseekV2Dims(num_hidden_layers=2, vocab_size=1024)
    torch.manual_seed(0)
    moe = MoE(d, device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        moe.gate.weight.normal_(std=0.02)
    x = torch.randn(4096, d.hidden_size, device=cuda_device,
                    dtype=torch.bfloat16)
    w, idx = moe.route(x)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], moe.expert_ids,
                              right=True).to(torch.int32)
    rows = x.index_select(0, order // d.num_experts_per_tok)
    E = moe.experts
    got = E(rows, ends).float()
    a = grouped_mm_plain(rows.float(), E.gate_proj.float(), ends)
    u = grouped_mm_plain(rows.float(), E.up_proj.float(), ends)
    want = grouped_mm_plain(torch.nn.functional.silu(a) * u,
                            E.down_proj.float(), ends)
    assert _rel(got, want) < 2e-2
    tower = DeepseekV2Model(d, device=cuda_device, dtype=torch.bfloat16)
    ids = torch.randint(0, 1024, (64, 32), device=cuda_device)
    mask = torch.ones_like(ids)
    tower.last_token_rep(ids, mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep = tower.last_token_rep(ids, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(rep.float()).all()
