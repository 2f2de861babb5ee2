"""``mevi_tpu_torch.utils.profiling``: FLOPs of a call against the JAX
package's ``compiled_flops`` (XLA's cost analysis) of the same products,
and the chrome-trace parser on hand-written ``torch.profiler`` traces
(CUDA kernels counted by name; CPU ops, memcpy and memset events left
out; plain, gzipped, or the newest trace under a directory).  JAX is
imported inside the one test that compares with it, so the card's test
command (``--noconftest -m cuda``) collects this file without JAX."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from mevi_tpu_torch.utils import profiling as P


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (7, 300, 5)])
def test_flops_of_matmul(m, k, n):
    jax = pytest.importorskip("jax")
    from mevi_tpu.utils.profiling import compiled_flops
    jnp = jax.numpy
    rng = np.random.default_rng(0)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = P.flops_of(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert got == 2 * m * k * n
    want = compiled_flops(jax.jit(jnp.matmul), jnp.asarray(a),
                          jnp.asarray(b))
    assert got == want


def test_flops_of_counts_every_product():
    """A module's product and a product of its output: both counted."""
    lin = torch.nn.Linear(16, 8, bias=False)

    def gram(t):
        y = lin(t)
        return y.T @ y
    assert P.flops_of(gram, torch.randn(4, 16)) == \
        2 * (4 * 16 * 8) + 2 * (8 * 4 * 8)


def _event(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": 0.0, "dur": dur}


TRACE = {"traceEvents": [
    _event("aten::mm", "cpu_op", 900.0),
    _event("cudaLaunchKernel", "cuda_runtime", 5.0),
    _event("ampere_sgemm_128x64", "kernel", 120.5),
    _event("ampere_sgemm_128x64", "kernel", 79.5),
    _event("bucket_kernel<2, 0, 3>", "kernel", 40.0),
    _event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 300.0),
    _event("Memset (Device)", "gpu_memset", 2.0),
    _event("bucket_kernel<2, 0, 3>", "kernel", 10.0, ph="i"),
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "python"}},
]}


def _check(total, per_op, calls):
    assert total == pytest.approx(240e-6)
    assert per_op == pytest.approx({"ampere_sgemm_128x64": 200e-6,
                                    "bucket_kernel<2, 0, 3>": 40e-6})
    assert calls == {"ampere_sgemm_128x64": 2, "bucket_kernel<2, 0, 3>": 1}


def test_device_op_seconds_plain_file(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    _check(*P.device_op_seconds(str(path)))


def test_device_op_seconds_gzip_newest_in_dir(tmp_path):
    old = tmp_path / "a" / "old.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": [
        _event("stale", "kernel", 1.0)]}))
    os.utime(old, (1, 1))
    new = tmp_path / "b" / "host.pt.trace.json.gz"
    new.parent.mkdir()
    with gzip.open(new, "wt") as fw:
        json.dump(TRACE, fw)
    _check(*P.device_op_seconds(str(tmp_path)))


def test_device_op_seconds_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        P.device_op_seconds(str(tmp_path))


def test_traced_stage_seconds_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trace runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.traced_stage_seconds(lambda i: None, 1)


@pytest.mark.cuda
def test_traced_stage_seconds_on_the_card(tmp_path):
    """On the card: a traced matmul's device time is its kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a = torch.randn(1024, 1024, device="cuda")
    tr = P.traced_stage_seconds(lambda i: a @ a, 3, trace_dir=str(tmp_path))
    assert 0 < tr.device_s <= tr.wall_s
    assert sum(tr.calls.values()) >= 3
    assert os.path.exists(tmp_path / "trace.json")
