"""The DeepSeek-V2 tower's spans and counters (beside
``tests/test_torch_spans.py``): off, they are the recorder's shared
no-op and the tower reads nothing back from the device; on, they nest
``tower`` > ``tower.mla`` / ``tower.moe`` > ``moe.route`` /
``moe.experts`` inside the served batch, and ``moe.routed_rows`` counts
tokens x experts per token a layer."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mevi_tpu_torch.config import EncoderConfig
from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.models.deepseek_v2 import DeepseekV2Dims, DeepseekV2Model
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims
from mevi_tpu_torch.models.twin_tower import tower_from_config
from mevi_tpu_torch.serve import BucketServer
from mevi_tpu_torch.utils import timers
from mevi_tpu_torch.utils.timers import SPANS, span

HF = {"kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
      "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
      "n_shared_experts": 2, "moe_intermediate_size": 32,
      "first_k_dense_replace": 1}
DIMS = DeepseekV2Dims(vocab_size=128, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=3, num_attention_heads=4, **HF)
LITE_YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40,
             "mscale": 0.707, "mscale_all_dim": 0.707,
             "original_max_position_embeddings": 4096, "type": "yarn"}
MOE_SPANS = ("tower.mla", "tower.moe", "moe.route", "moe.experts")


@pytest.fixture
def rec():
    SPANS.disable()
    SPANS.clear()
    yield SPANS
    SPANS.disable()
    SPANS.clear()


class _Reads(TorchDispatchMode):
    """Records each op and whether it made a tensor on another device
    than its inputs' (a copy to the host)."""

    def __init__(self):
        super().__init__()
        self.ops, self.moved = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(str(func))
        devs = {a.device for a in args if isinstance(a, torch.Tensor)}
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and devs and o.device not in devs:
                self.moved.append(str(func))
        return out


def test_off_the_spans_are_the_no_op_and_nothing_is_read_back(rec):
    assert all(span(n) is span("tower") for n in MOE_SPANS)
    # on the meta device an op that read a value on the host (an item,
    # a nonzero, a copy out) would raise
    model = DeepseekV2Model(DIMS, device="meta", dtype=torch.bfloat16)
    ids = torch.zeros((4, 7), dtype=torch.int32, device="meta")
    with _Reads() as reads:
        rep = model.last_token_rep(ids, torch.ones_like(ids))
    assert rep.shape == (4, 64) and rep.device.type == "meta"
    assert reads.moved == []
    assert not [o for o in reads.ops if "_local_scalar_dense" in o
                or "nonzero" in o]
    assert "aten._grouped_mm.default" in reads.ops
    assert rec.spans() == []


def _server():
    enc = EncoderConfig(family="deepseek_v2", d_model=64, num_layers=3,
                        num_heads=4, d_ff=96, vocab_size=128,
                        layer_norm_epsilon=1e-6,
                        deepseek_v2={**HF, "rope_scaling": LITE_YARN})
    tower = tower_from_config(enc, device="cpu")
    torch.manual_seed(1)
    with torch.no_grad():
        for p in tower.module.parameters():
            p.copy_(0.05 * torch.randn(p.shape))
    t5 = T5Dims(vocab_size=128, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nci = NCIT5(NCIDims(t5=t5, kary=4, max_output_length=6,
                        adaptor_layer_num=1, adaptor_num_heads=4,
                        adaptor_d_ff=32), device="cpu")
    rng = np.random.default_rng(3)
    index = build_fine_index(rng.integers(0, 4, (256, 4)).astype(np.int32),
                             rng.normal(size=(256, 64)).astype(np.float32),
                             4, device="cpu")
    return BucketServer(SimpleNamespace(first_token_rep=tower.rep), nci,
                        index, num_beams=3, cap=16, pool=10,
                        device="cpu"), tower


def test_on_they_nest_under_the_tower_and_count_routed_rows(rec):
    srv, tower = _server()
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        1, 120, size=(5, 6)))
    rows0 = timers.counter("moe.routed_rows")
    layers0 = timers.counter("moe.layers")
    off = srv.finalize(srv.query_device(ids, torch.ones_like(ids)))
    # counters count whether spans are on or off: 2 MoE layers a batch
    assert timers.counter("moe.layers") - layers0 == 2
    assert timers.counter("moe.routed_rows") - rows0 == 2 * 5 * 6 * 2
    assert rec.spans() == []
    rec.enable()
    on = srv.finalize(srv.query_device(ids, torch.ones_like(ids)))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    s = rec.spans()
    names = Counter(x.name for x in s)
    assert {n: names[n] for n in MOE_SPANS} == {
        "tower.mla": 3, "tower.moe": 2, "moe.route": 2, "moe.experts": 2}
    parent = {x.name: s[x.parent].name for x in s if x.name in MOE_SPANS}
    assert parent == {"tower.mla": "tower", "tower.moe": "tower",
                      "moe.route": "tower.moe", "moe.experts": "tower.moe"}
    assert s[[x.name for x in s].index("tower")].parent >= 0   # in a batch
    assert len({x.batch for x in s if x.name in MOE_SPANS}) == 1
    assert timers.counter("moe.routed_rows") - rows0 == 2 * (5 * 6 * 2 * 2)
    rows = tower.module.layers[2].mlp.expert_rows
    assert int(rows.sum()) == 5 * 6 * 2
