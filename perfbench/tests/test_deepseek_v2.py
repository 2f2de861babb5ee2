"""The DeepSeek-V2 cell's readers (``mla_device_ms``, ``moe_device_ms``,
``moe_roofline``) over a hand-made trace, the MoE blocks' counts against
a hand count, and the configuration's file against the published
``config.json`` it was cut from."""

import json
import os
import types

import pytest

from perfbench import counts, harness, lookup
from perfbench.trace import Trace, load_events

CELL = "marco-dsv2lite.b512"


def _reader(name):
    return lookup.load_module(os.path.join(harness.HERE, "metrics",
                                           name + ".py"),
                              "perfbench_metric_" + name)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1 if corr is None or cat != "kernel" else 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _window(tmp_path, with_blocks=True):
    """Two batches: each a tower with one MLA and one MoE block (one
    kernel each, 3 ms and 20 ms), a kernel between them, and a beam
    kernel outside the tower."""
    ev = [_ev("user_annotation", "pb.window", 0, 200_000)]
    corr = 0
    for b in range(2):
        t0 = b * 100_000
        ev += [_ev("user_annotation", "pb.coarse", t0, 90_000),
               _ev("user_annotation", "pb.tower", t0 + 10, 60_000)]
        if with_blocks:
            ev += [_ev("user_annotation", "pb.mla", t0 + 20, 100),
                   _ev("user_annotation", "pb.moe", t0 + 200, 100)]
        for ts, dur in ((t0 + 30, 3_000), (t0 + 150, 1_000),
                        (t0 + 250, 20_000), (t0 + 70_000, 5_000)):
            corr += 1
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", ts, 5, corr),
                   _ev("kernel", f"k{corr}", ts + 10, dur, corr)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return types.SimpleNamespace(trace=Trace(load_events(str(path))), n=2)


def test_the_readers_on_a_hand_made_trace(tmp_path):
    w = _window(tmp_path)
    assert _reader("mla_device_ms").read(w) == pytest.approx(3.0)
    assert _reader("moe_device_ms").read(w) == pytest.approx(20.0)
    cell, cfg = harness.load_cell(CELL)
    least = lookup.tower("deepseek_v2").moe_least_seconds(
        cfg["tower"], 512 * 32, 2)
    assert _reader("moe_roofline").read(w) == pytest.approx(
        100.0 * least / 20e-3)
    assert _reader("tower_device_ms").read(w) == pytest.approx(24.0)


def test_the_readers_find_nothing_without_the_blocks(tmp_path):
    # a tower without the ranges (another family, or the parent's tree)
    w = _window(tmp_path, with_blocks=False)
    for name in ("mla_device_ms", "moe_device_ms", "moe_roofline"):
        assert _reader(name).read(w) is None


def test_moe_counts_against_a_hand_count():
    cfg = harness.load_cell(CELL)[1]
    tokens = 512 * 32
    nbytes, ops = lookup.tower("deepseek_v2").moe_counts(cfg["tower"],
                                                         tokens, 2)
    # a layer: 64 experts of three 2,048 x 1,408 matrices, the shared
    # SwiGLU of 2,816, the 64 x 2,048 gate, in bf16; the tokens' rows
    # read and written
    params = 64 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 64 * 2048
    assert params == 571_080_704
    assert nbytes == 8 * (2 * params + 2 * tokens * 2048 * 2)
    per_token = 6 * 2 * 3 * 2048 * 1408 + 2 * 3 * 2048 * 2816 \
        + 2 * 64 * 2048
    assert per_token == 138_674_176
    assert ops == 8 * tokens * per_token
    least = counts.least_seconds(nbytes, ops)
    assert least == pytest.approx(18.38e-3, rel=1e-3)      # compute-bound
    assert least == ops / counts.H100_BF16_FLOPS


def test_the_configuration_is_the_published_one_cut_in_depth_and_vocab():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entry = [c for c in bench["configs"]
             if c["name"] == "marco-dsv2lite-rq4x5"][0]
    cfg = json.load(open(os.path.join(harness.ROOT, entry["file"])))
    published = {
        "hidden_size": 2048, "intermediate_size": 10944,
        "moe_intermediate_size": 1408, "num_hidden_layers": 27,
        "num_attention_heads": 16, "num_key_value_heads": 16,
        "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 64,
        "num_experts_per_tok": 6, "n_shared_experts": 2,
        "first_k_dense_replace": 1, "routed_scaling_factor": 1,
        "norm_topk_prob": False, "topk_method": "greedy",
        "scoring_func": "softmax", "rms_norm_eps": 1e-06,
        "rope_theta": 10000, "vocab_size": 102400,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}
    changed = {"num_hidden_layers": 9, "vocab_size": 25600}
    assert sorted(entry["reduced"]) == sorted(changed) == \
        sorted(cfg["reduced"])
    for k, v in published.items():
        want = changed.get(k, v)
        assert cfg[k] == want, k                   # top level, as published
        assert cfg["tower"][k] == want, k          # what the tower is built from
    assert cfg["tower"]["family"] == "deepseek_v2"
    assert cfg["corpus"]["d"] == cfg["hidden_size"] == 2048
    marco = harness.load_cell("marco.b512")[1]
    for k in ("nci", "index", "serving", "query_lengths"):
        assert cfg[k] == marco[k], k
