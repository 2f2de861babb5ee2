"""``BucketServer``'s device half queues a batch without waiting for the
card: the CSR is proven once at build (``eval.searcher.HostCSR``), each
batch's cluster ids are checked on the device, and a fault is raised at
``finalize``.

On the CPU, over float32 and bfloat16 corpora: the build of each owner
of a ``HostCSR`` (``BucketServer``, ``FineReranker``) refuses each bad
CSR; out-of-range override ids never reach the bucket wrapper,
``query_device`` returns and ``finalize`` raises, after which the server
serves as a fresh one does; a good batch equals, bit for bit, what each
checked public wrapper (v3, fused) gives; ``serve.cidx_check`` counts
one a batch; ``FineReranker`` refuses host cluster ids outside the CSR
before any launch.  On the card (``cuda``, skips
without one): after one warm-up batch, which captures the beam's graph,
``query_device`` runs under ``torch.cuda.set_sync_debug_mode("error")``,
and two batches in flight equal the same batches served one at a time.
No JAX in this file: the card runs it with ``--noconftest``."""

import re

import numpy as np
import pytest
import torch

import mevi_tpu_torch.eval.searcher as searcher
import mevi_tpu_torch.serve as serve
from mevi_tpu_torch.eval.searcher import (FineReranker, build_fine_index,
                                          merge_pool)
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.ops.bucket import (ALIGN, CIDX_ERROR,
                                       bucket_scores_fused, bucket_scores_v3)
from mevi_tpu_torch.serve import BucketServer
from mevi_tpu_torch.utils import timers

KARY, M, NB, CAP, POOL = 4, 3, 3, 16, 10
NDOC, D, B, L = 512, 16, 5, 6
DTYPES = [torch.float32, torch.bfloat16]


def _server(device="cpu", dtype=torch.float32, index=None):
    t5 = T5Dims(vocab_size=64, d_model=D, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nci = NCIT5(NCIDims(t5=t5, kary=KARY, max_output_length=M + 2,
                        adaptor_layer_num=1, adaptor_num_heads=4,
                        adaptor_d_ff=32), device=device)
    tower = T5Model(t5, device=device)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in (nci, tower):
            for p in m.parameters():
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    if index is None:
        index = _index(device, dtype)
    return BucketServer(tower, nci, index, num_beams=NB, cap=CAP, pool=POOL,
                        device=device)


def _index(device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(NDOC, D)).astype(np.float32)
    codes = rng.integers(0, KARY, size=(NDOC, M)).astype(np.int32)
    return build_fine_index(codes, emb, KARY, dtype=dtype, device=device)


def _batch(seed, device="cpu"):
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        2, 60, size=(B, L))).to(device)
    return ids, torch.ones_like(ids)


def _override(seed, device="cpu"):
    """B * nb ids drawn over every cluster."""
    return torch.from_numpy(np.random.default_rng(100 + seed).integers(
        0, KARY ** M, size=B * NB).astype(np.int32)).to(device)


def _serve(srv, seed, override=None):
    return srv.finalize(srv.query_device(*_batch(seed, srv.device),
                                         cidx_override=override))


def _assert_same(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def _bad_csr(off, kind):
    off = off.copy()
    if kind == "falls":
        off[2] = off[3] + 1
    elif kind == "starts_below_0":
        off[0] = -1
    elif kind == "runs_past_N":
        off[-1] = NDOC + 1
    else:                                   # "one_entry"
        off = off[:1]
    return off


OWNERS = {"BucketServer": lambda index: _server(index=index),
          "FineReranker": lambda index: FineReranker(index, CAP, POOL,
                                                     device="cpu")}


@pytest.mark.parametrize("owner", sorted(OWNERS))
@pytest.mark.parametrize("kind,message", [
    ("falls", "must not fall"), ("starts_below_0", "start at >= 0"),
    ("runs_past_N", "run past the corpus rows"),
    ("one_entry", "C \\+ 1 >= 2 entries")])
def test_build_refuses_a_bad_csr(kind, message, owner):
    index = _index()
    off = _bad_csr(np.asarray(index.host_offsets, np.int64), kind)
    bad = index._replace(offsets=torch.from_numpy(off.astype(np.int32)),
                         host_offsets=off)
    with pytest.raises(ValueError, match=message):
        OWNERS[owner](bad)


def _record_wrapper(monkeypatch, module):
    """What reaches ``module``'s bucket wrapper: (starts, ends) a call."""
    seen = []
    real = module.bucket_scores_v3

    def v3(semb, starts, ends, *a, **k):
        seen.append((starts.clone(), ends.clone()))
        return real(semb, starts, ends, *a, **k)
    monkeypatch.setattr(module, "bucket_scores_v3", v3)
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("times_c,plus", [(0, -2), (0, -1), (1, 0), (1, 7)],
                         ids=["-2", "-1", "C", "C+7"])
def test_out_of_range_ids_fault_at_finalize(monkeypatch, dtype, times_c,
                                            plus):
    srv = _server(dtype=dtype)
    C = srv.csr.nclusters
    seen = _record_wrapper(monkeypatch, serve)
    ov = _override(1)
    ov[4] = times_c * C + plus
    h = srv.query_device(*_batch(1), cidx_override=ov)
    assert h.fault.dim() == 0 and bool(h.fault)
    with pytest.raises(ValueError, match=re.escape(CIDX_ERROR)):
        srv.finalize(h)
    # the kernel's inputs lay inside the CSR: no row outside was read
    ((starts, ends),) = seen
    assert int(starts.min()) >= 0 and int(ends.max()) <= NDOC
    assert bool((starts <= ends).all())
    # the next good batch serves as a fresh server does
    good = _override(2)
    _assert_same(_serve(srv, 2, good),
                 _serve(_server(dtype=dtype), 2, good))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("override", [False, True])
def test_good_batch_equals_the_checked_wrappers(dtype, override):
    srv = _server(dtype=dtype)
    ids, mask = _batch(3)
    ov = _override(3) if override else None
    h = srv.query_device(ids, mask, cidx_override=ov)
    assert not bool(h.fault)
    codes, beam_scores, cidx, q_rep = srv.coarse(ids, mask)
    if ov is not None:
        cidx = ov
    ci, off = cidx.long(), srv.csr.offsets_d
    for s, r in (bucket_scores_v3(srv.sorted_emb, off[ci], off[ci + 1],
                                  q_rep, CAP, ALIGN, device="cpu"),
                 bucket_scores_fused(srv.sorted_emb, off, cidx, q_rep, CAP,
                                     ALIGN, device="cpu")):
        want = merge_pool(s.reshape(B, -1), r.reshape(B, -1), NB, CAP,
                          POOL)
        for got, w in zip(h, (*want, codes, beam_scores), strict=True):
            assert torch.equal(got, w)


@pytest.mark.parametrize("cid", ["-1", "C"])
def test_fine_reranker_refuses_ids_outside_the_csr(monkeypatch, cid):
    rr = FineReranker(_index(), CAP, POOL, device="cpu")
    seen = _record_wrapper(monkeypatch, searcher)
    codes = np.random.default_rng(4).integers(0, KARY, size=(B, NB, M))
    qemb = torch.ones(B, D)
    rr(qemb, codes)                         # good codes reach the kernel
    assert len(seen) == 1
    # packed radix-KARY: (0, ..., 0, -1) -> -1, (KARY, 0, ..., 0) -> C
    bad = {"-1": [0] * (M - 1) + [-1], "C": [KARY] + [0] * (M - 1)}
    codes[2, 1] = bad[cid]
    with pytest.raises(ValueError, match=re.escape(CIDX_ERROR)):
        rr(qemb, codes)
    assert len(seen) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_cidx_check_counts_one_a_batch(dtype):
    srv = _server(dtype=dtype)
    before = timers.counter("serve.cidx_check")
    h = None
    for seed in range(3):
        nxt = srv.query_device(*_batch(seed), cidx_override=_override(seed))
        if h is not None:
            srv.finalize(h)
        h = nxt
    srv.finalize(h)
    assert timers.counter("serve.cidx_check") == before + 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_query_device_waits_for_nothing(cuda_device, dtype):
    srv = _server(cuda_device, dtype)
    dev = cuda_device
    ov = _override(2, dev)
    b1, b2 = _batch(1, dev), _batch(2, dev)
    _serve(srv, 0)                  # warm-up: the kernel, the beam's graph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h1 = srv.query_device(*b1)
        h2 = srv.query_device(*b2, cidx_override=ov)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    in_flight = [srv.finalize(h1), srv.finalize(h2)]
    one_at_a_time = [_serve(srv, 1), _serve(srv, 2, ov)]
    for a, b in zip(in_flight, one_at_a_time):
        _assert_same(a, b)
    assert not np.array_equal(in_flight[0][1], in_flight[1][1])
    # an id outside the CSR faults at finalize, and reads nothing outside
    # the corpus: the card serves on
    bad = ov.clone()
    bad[0] = srv.csr.nclusters + 7
    h = srv.query_device(*_batch(2, dev), cidx_override=bad)
    with pytest.raises(ValueError, match=re.escape(CIDX_ERROR)):
        srv.finalize(h)
    _assert_same(_serve(srv, 1), one_at_a_time[0])
