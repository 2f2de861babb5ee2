"""``decode.beam_graph.BeamGraph``, the NCI beam of ``BucketServer``
replayed from one CUDA graph per batch shape, and the device constants
that keep the beam capturable.

On the CPU: the constants are bitwise the host-built ones they replace;
the server runs the beam eagerly and returns what the direct call does;
the runner's bookkeeping (a shape's first call run eagerly, captured
and replayed, later calls replayed, the least recently used shape
evicted, outputs cloned) with a
stand-in for the CUDA graph.  On the card (``cuda``, skips without one):
replayed codes and scores bitwise equal to the eager beam's over 4
batches served in a closed loop, at tiny widths and at T5-base widths
with B = 512, PAWA prefix tables off and on.  No JAX in this file."""

import contextlib

import numpy as np
import pytest
import torch

from mevi_tpu_torch.decode import beam_graph
from mevi_tpu_torch.decode.beam import (_final_order,
                                        nci_beam_search_incremental)
from mevi_tpu_torch.decode.beam_graph import BeamGraph
from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model, relative_position_bucket
from mevi_tpu_torch.serve import BucketServer
from mevi_tpu_torch.utils import timers

COUNTERS = ("beam.graph.eager", "beam.graph.capture", "beam.graph.replay")


def _counts():
    return {k: timers.counter(k) for k in COUNTERS}


def _delta(before):
    return {k: timers.counter(k) - v for k, v in before.items()}


# ---------------------------------------------------------------------------
# the constants, against the host-built ones they replace
# ---------------------------------------------------------------------------

def _bucket_host_built(rel_pos, bidirectional, num_buckets, max_distance):
    ret = torch.zeros_like(rel_pos, dtype=torch.int32)
    n = -rel_pos.to(torch.int32)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20) / denom.to(n.device)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@pytest.mark.parametrize("bidirectional,num_buckets,max_distance", [
    (True, 32, 128), (False, 32, 128), (True, 16, 40), (False, 8, 20)])
def test_relative_position_bucket_bitwise_host_built(
        bidirectional, num_buckets, max_distance):
    rel = torch.arange(-700, 701)[None, :] - torch.arange(0, 7)[:, None]
    got = relative_position_bucket(rel, bidirectional, num_buckets,
                                   max_distance)
    want = _bucket_host_built(rel, bidirectional, num_buckets, max_distance)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,lp", [(4, 0.8), (3, 1.0), (6, 0.65)])
def test_final_order_bitwise_host_built(M, lp):
    g = torch.Generator().manual_seed(M)
    scores = torch.randn(64, 10, generator=g) * 30
    eos = -torch.rand(64, 10, generator=g) * 5
    norm, order = _final_order(scores, eos, M, lp)
    total = scores + eos
    want = total / torch.tensor(float(M + 1)).pow(
        torch.tensor(float(lp))).to(total.device)
    want_order = torch.sort(-want, dim=-1, stable=True).indices
    assert torch.equal(order, want_order)
    assert torch.equal(norm, torch.gather(want, -1, want_order))


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------

def _tiny(device):
    kary, M = 4, 4
    t5 = T5Dims(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1, dropout_rate=0.0)
    nci = NCIT5(NCIDims(t5=t5, kary=kary, max_output_length=M + 2,
                        adaptor_layer_num=1, adaptor_num_heads=4,
                        adaptor_d_ff=32), device=device)
    tower = T5Model(t5, device=device)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in (nci, tower):
            for p in m.parameters():
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return nci, tower, dict(kary=kary, M=M, d=16, nb=3, B=8, L=6, vocab=60,
                            ndoc=512, dtype=torch.float32)


def _base(device):
    """T5-base widths: the NCI 12 + 6 with PAWA 4 over kary 32, M 4, in
    bf16, at their default inits; a one-layer tower of width 768."""
    kary, M = 32, 4
    t5 = T5Dims(dropout_rate=0.0, dtype=torch.bfloat16)
    torch.manual_seed(0)
    nci = NCIT5(NCIDims(t5=t5, kary=kary, max_output_length=M + 2),
                device=device, dtype=torch.bfloat16)
    tower = T5Model(T5Dims(vocab_size=1024, num_layers=1,
                           num_decoder_layers=1, dropout_rate=0.0),
                    device=device, dtype=torch.bfloat16)
    return nci, tower, dict(kary=kary, M=M, d=768, nb=10, B=512, L=32,
                            vocab=1000, ndoc=8192, dtype=torch.bfloat16)


def _server(size, pawa, device):
    nci, tower, s = (_tiny if size == "tiny" else _base)(device)
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(s["ndoc"], s["d"])).astype(np.float32)
    codes = rng.integers(0, s["kary"], size=(s["ndoc"], s["M"])
                         ).astype(np.int32)
    index = build_fine_index(codes, emb, s["kary"], dtype=s["dtype"],
                             device=device)
    srv = BucketServer(tower, nci, index, num_beams=s["nb"], cap=16,
                       pool=20, pawa_tables=pawa, device=device)
    assert (srv.pawa_tables is not None) == pawa
    return srv, s


def _batches(s, n, device):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.integers(2, s["vocab"],
                                            size=(s["B"], s["L"])))
        mask = torch.ones_like(ids)
        mask[: s["B"] // 2, s["L"] - 2:] = 0
        out.append((ids.to(device), mask.to(device)))
    return out


def _eager(srv, ids, mask):
    codes, scores, _ = nci_beam_search_incremental(
        srv.nci, ids, mask, srv.num_beams, srv.length_penalty,
        level_tables=srv.level_tables, pawa_tables=srv.pawa_tables)
    return codes.cpu().numpy(), scores.cpu().numpy()


def _closed_loop(srv, batches):
    """Batch i + 1 issued before batch i is finalized, as the serving
    loop does: each output is finalized with the next batch in flight."""
    out, h = [], None
    for ids, mask in batches:
        nxt = srv.query_device(ids, mask)
        if h is not None:
            out.append(srv.finalize(h))
        h = nxt
    out.append(srv.finalize(h))
    return out


@pytest.mark.parametrize("pawa", [False, True])
def test_cpu_server_runs_the_beam_eagerly(pawa):
    srv, s = _server("tiny", pawa, "cpu")
    batches = _batches(s, 3, "cpu")
    before = _counts()
    served = _closed_loop(srv, batches)
    assert _delta(before) == {"beam.graph.eager": 3, "beam.graph.capture": 0,
                              "beam.graph.replay": 0}
    for (ids, mask), out in zip(batches, served):
        codes, scores = _eager(srv, ids, mask)
        np.testing.assert_array_equal(out[2], codes)
        np.testing.assert_array_equal(out[3], scores)
    assert srv.beam._graphs == {}


# ---------------------------------------------------------------------------
# the runner's bookkeeping, with a stand-in for the CUDA graph
# ---------------------------------------------------------------------------

class _StandInGraph:
    """Records its replays; a replay recomputes nothing, so the static
    outputs keep what the capture wrote."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_runner_bookkeeping_with_a_stand_in_graph(monkeypatch):
    monkeypatch.setattr(beam_graph, "_eager_only", lambda t: False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    calls = []

    def beam(model, ids, mask, nb, lp, level_tables=None, pawa_tables=None):
        calls.append(ids.shape)
        return (ids[:, :2].to(torch.int32) + 1, ids[:, :1].float() * 0.5,
                None)

    bg = BeamGraph(beam, object(), 3, 0.8)
    ids = torch.arange(12).reshape(4, 3)
    mask = torch.ones_like(ids)
    key = ((4, 3), ids.dtype, mask.dtype, ids.device)
    before = _counts()
    codes0, scores0 = bg(ids, mask)          # first sight: eager, capture
    g = bg._graphs[key]
    assert g.graph.replays == 1 and len(calls) == 2
    assert torch.equal(codes0, g.codes)
    assert codes0.data_ptr() != g.codes.data_ptr()       # cloned out
    assert scores0.data_ptr() != g.scores.data_ptr()
    bg(ids + 20, None)                                   # another key
    codes2, _ = bg(ids + 30, mask)                       # replay
    assert g.graph.replays == 2 and len(calls) == 4
    assert torch.equal(g.ids, ids + 30)                  # copied in
    assert codes2.data_ptr() != codes0.data_ptr()
    assert _delta(before) == {"beam.graph.eager": 2, "beam.graph.capture": 2,
                              "beam.graph.replay": 3}
    # three more shapes evict the least recently used (the mask-less key)
    for r in range(5, 8):
        bg(torch.zeros((r, 3), dtype=torch.long), None)
    assert len(bg._graphs) == BeamGraph.SHAPES
    assert ((4, 3), ids.dtype, None, ids.device) not in bg._graphs
    assert key in bg._graphs
    assert _delta(before)["beam.graph.capture"] == 5


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pawa", [False, True])
@pytest.mark.parametrize("size", ["tiny", "base"])
def test_replay_bitwise_equal_to_the_eager_beam(cuda_device, size, pawa):
    srv, s = _server(size, pawa, cuda_device)
    batches = _batches(s, 4, cuda_device)
    want = [_eager(srv, ids, mask) for ids, mask in batches]
    before = _counts()
    timers.SPANS.clear()
    timers.enable()
    try:
        served = _closed_loop(srv, batches)
    finally:
        timers.disable()
    assert _delta(before) == {"beam.graph.eager": 1, "beam.graph.capture": 1,
                              "beam.graph.replay": 4}
    for (codes, scores), out in zip(want, served):
        assert np.isfinite(scores).all()
        np.testing.assert_array_equal(out[2], codes)
        np.testing.assert_array_equal(out[3], scores)
    # the batches differ, so a handle reading another's outputs would show
    assert not np.array_equal(want[2][1], want[3][1])
    spans = timers.SPANS.spans()
    timers.SPANS.clear()
    names = [x.name for x in spans]
    assert names.count("beam.graph.replay") == 4
    assert names.count("beam.encode") == 2           # eager + capture
    for x in spans:
        if x.name == "beam.graph.replay":
            assert spans[x.parent].name == "beam"
