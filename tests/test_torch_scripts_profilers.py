"""The coarse-stage profilers of ``mevi_tpu_torch.scripts`` on the CPU at
their tiny geometry (a 2 + 2 layer NCI at d 32, batch 4, float32, the
host clock; no JAX counterpart runs: the JAX scripts time a TPU):
``profile_beam`` (with the traced breakdown), ``profile_step``,
``beam_trace`` and ``trace_beam_only`` each run through ``main`` and
print their keys; ``beam_trace``'s category table sorts fixed kernel
names, and a FLOPs count that fails or reads zero raises."""

import json
import os
from unittest import mock

import pytest

from mevi_tpu_torch.scripts import (beam_trace, profile_beam, profile_step,
                                    trace_beam_only)
from mevi_tpu_torch.utils import profiling as P
from torch_one_thread import one_thread  # noqa: F401

PROFILE_BEAM_STAGES = ("launch_sync_floor", "enc_kv_proj",
                       "incremental_beam", "panel_beam",
                       "greedy_decode_5_steps", "adaptor_einsum_old",
                       "adaptor_packed_new")


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_beam_prints_every_stage(capsys):
    with mock.patch.dict(os.environ, {"TRACE": "1"}):
        out = profile_beam.main(["--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(out))
    assert out["batch"] == 4 and out["beams"] == 10
    assert tuple(out["stages"]) == PROFILE_BEAM_STAGES
    for name, row in out["stages"].items():
        assert row["seq_ms"] > 0 and row["pipe_ms"] > 0, name
    for name in ("enc_kv", "beam"):
        tr = out["trace"][name]
        assert tr["device_ms"] > 0 and tr["gflops"] > 0
        assert tr["bf16_peak_pct"] is None          # no peak on the CPU
        assert tr["top_ms"]


def test_profile_step_prints_every_variant(capsys):
    out = profile_step.main(["--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(out))
    assert list(out["variants"]) == ["matmul_calib", "dec_only", "dec_head",
                                     "full"]
    assert out["variants"]["matmul_calib"]["ms"] > 0
    for name in ("dec_only", "dec_head", "full"):
        row = out["variants"][name]
        assert row["prologue_ms"] > 0 and row["ms"] > 0
        assert row["steps_only_ms"] == pytest.approx(row["ms"]
                                                     - row["prologue_ms"])


def test_beam_trace_writes_the_artifact(tmp_path, capsys):
    path = tmp_path / "bt.json"
    with mock.patch.dict(os.environ, {"BT_OUT": str(path),
                                      "BT_LABEL": "test"}):
        out = beam_trace.main(["--device", "cpu"])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    summary = last_json(capsys)
    assert set(summary) == {"beam_device_ms", "beam_mfu_pct",
                            "trace_breakdown_ms"}
    assert out["label"] == "test" and out["beam_mfu_pct"] is None
    assert out["beam_gflops"] > 0 and out["kernels_a_call"] > 0
    cats = out["trace_breakdown_ms"]
    assert set(cats) == {c for c, _ in beam_trace.CATEGORIES} | {"other"}
    assert sum(cats.values()) == pytest.approx(out["beam_device_ms"])
    assert cats["gemm"] > 0


@pytest.mark.parametrize("name,cat", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm"),
    ("nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>",
     "gemm"),
    ("aten::linear", "gemm"),
    ("bucket_kernel<1, 0, 3>", "bucket_kernel"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
     "float>", "reduction_softmax"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "reduction_softmax"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>",
     "reduction_softmax"),
    ("Memcpy DtoD (Device -> Device)", "copy_memcpy"),
    ("void at::native::direct_copy_kernel_cuda", "copy_memcpy"),
    ("void at::native::index_elementwise_kernel<128, 4>", "index_cat"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "index_cat"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::AUnaryFunctor<float>>", "elementwise"),
    ("aten::mul", "elementwise"),
    ("cudaLaunchKernel", "other"),
])
def test_category_table(name, cat):
    assert beam_trace.category(name) == cat


def test_categorize_sums_by_category():
    cats = beam_trace.categorize({"nvjet_a": 0.5, "nvjet_b": 0.25,
                                  "bucket_kernel<1>": 0.125, "mystery": 1.0})
    assert cats["gemm"] == 0.75 and cats["bucket_kernel"] == 0.125
    assert cats["other"] == 1.0 and cats["elementwise"] == 0.0


def test_beam_trace_failed_flops_count_raises():
    def broken(*a, **k):
        raise RuntimeError("no FLOP count")
    with mock.patch.object(P, "flops_of", broken):
        with pytest.raises(RuntimeError, match="no FLOP count"):
            beam_trace.trace("cpu", B=2, n=1)
    with mock.patch.object(P, "flops_of", lambda *a, **k: 0.0):
        with pytest.raises(RuntimeError, match="FLOPs count of the beam"):
            beam_trace.trace("cpu", B=2, n=1)


def test_trace_beam_only_prints_lanes(capsys):
    out = trace_beam_only.main(["--device", "cpu"])
    assert last_json(capsys) == json.loads(json.dumps(out))
    assert out["pawa_tables"] is True and out["calls"] == 3
    assert out["beam_device_ms"] > 0 and out["lanes"]
    assert all(len(lane) == 4 for lane in out["lanes"])


def test_cpu_trace_counts_outermost_operators():
    """A CPU-only trace's operator time is the outermost events' of each
    thread: nested calls are not counted twice."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1,
           "tid": 1, "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1,
           "tid": 1, "ts": 2.0, "dur": 6.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "pid": 1,
           "tid": 1, "ts": 12.0, "dur": 3.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
           "tid": 2, "ts": 2.0, "dur": 4.0}]
    assert [e["name"] for e in P._outermost(ev)] == [
        "aten::linear", "aten::mm", "aten::relu"]


def test_sequential_pipelined_ms_counts_calls():
    seen = []
    seq, pipe = P.sequential_pipelined_ms(seen.append, iters=3, warmup=2,
                                          device="cpu")
    assert seen == [0, 1, 2, 3, 4, 0, 1, 2]
    assert seq >= 0 and pipe >= 0
