"""Attribution of device operations to the harness's ranges, busy time
and idle gaps, over a hand-made chrome trace."""

import json

import pytest

from perfbench.trace import Trace, load_events


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    ev = [
        _ev("user_annotation", "pb.window", 100, 1000),
        _ev("user_annotation", "pb.coarse", 110, 300),
        _ev("user_annotation", "pb.tower", 120, 100),
        _ev("user_annotation", "pb.bucket", 500, 50),
        # launches: one in the tower, two in the beam, one in the bucket,
        # one before the window
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 5, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 5, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 5, 5),
        _ev("kernel", "gemm", 140, 100, 1, tid=7),
        _ev("kernel", "add", 260, 20, 2, tid=7),
        _ev("kernel", "topk", 310, 40, 3, tid=7),
        _ev("kernel", "bucket", 520, 30, 4, tid=7),
        _ev("kernel", "early", 60, 60, 5, tid=7),
        _ev("gpu_memcpy", "DtoH", 600, 10, None, tid=8),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(load_events(str(path)))


def test_layers_by_launch(trace):
    assert trace.layer_seconds("tower") == pytest.approx(100e-6)
    assert trace.layer_seconds("coarse", outside="tower") == pytest.approx(
        60e-6)
    assert len(trace.layer_ops("coarse", outside="tower")) == 2
    assert trace.layer_seconds("bucket") == pytest.approx(30e-6)
    assert trace.layer_seconds("pool") is None


def test_busy_and_idle(trace):
    # the early kernel overlaps the window's start by 20 us
    assert trace.window_s == pytest.approx(1000e-6)
    assert trace.busy_s() == pytest.approx((20 + 100 + 20 + 40 + 30 + 10)
                                           * 1e-6)
    gaps = dict(trace.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(1000e-6 - trace.busy_s())
    # a gap is named by the range open when it began
    assert gaps["tower"] == pytest.approx(20e-6)
    assert gaps["coarse"] == pytest.approx(20e-6 + 30e-6 + 170e-6)
    assert gaps["harness"] == pytest.approx(50e-6 + 490e-6)
    assert trace.device_ops()[0] == ["gemm", pytest.approx(100e-6)]
