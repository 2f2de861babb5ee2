"""The port's span recorder (``mevi_tpu_torch.utils.timers``): off, it
records nothing and opens no profiler range; on, spans nest with their
parent, batch id and self time, open ``mevi.*`` ranges under a profiler
capture, and the serving path (``BucketServer.query_device`` +
``finalize``) emits one batch's span tree without changing its
outputs."""

import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.ops.bucket import launch_counts
from mevi_tpu_torch.serve import BucketServer
from mevi_tpu_torch.utils import timers
from mevi_tpu_torch.utils.timers import SPANS, SectionTimers, span


@pytest.fixture
def rec():
    """The process-wide recorder, off and empty before and after."""
    SPANS.disable()
    SPANS.clear()
    yield SPANS
    SPANS.disable()
    SPANS.clear()


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_off_records_nothing_and_opens_no_range(rec):
    assert not rec.on
    assert span("a") is span("b", t=3)       # one shared no-op context

    def body():
        with span("a", batch=rec.new_batch()):
            with span("b", t=1):
                torch.ones(4).sum()
    names = _profiled_names(body)
    assert "aten::sum" in names
    assert not [n for n in names if n.startswith("mevi.")]
    assert rec.spans() == [] and rec.summary() == {}
    assert rec.new_batch() is None


def test_on_nesting_parent_batch_and_self_time(rec):
    rec.enable()
    b0 = rec.new_batch()
    with span("root", batch=b0):
        with span("child", t=1):
            with span("leaf"):
                sum(range(2000))
        with span("child", t=2):
            pass
    with span("other"):
        pass
    s = rec.spans()
    assert [(x.name, x.parent, x.batch, x.t) for x in s] == [
        ("root", -1, b0, None), ("child", 0, b0, 1), ("leaf", 1, b0, None),
        ("child", 0, b0, 2), ("other", -1, None, None)]
    assert rec.new_batch() == b0 + 1
    assert all(x.end_ns >= x.start_ns for x in s)
    dur = [x.end_ns - x.start_ns for x in s]
    summ = rec.summary()
    assert summ["child"]["count"] == 2
    assert summ["child"]["total_ms"] == pytest.approx((dur[1] + dur[3]) * 1e-6)
    assert summ["child"]["self_ms"] == pytest.approx(
        (dur[1] - dur[2] + dur[3]) * 1e-6)
    assert summ["root"]["self_ms"] == pytest.approx(
        (dur[0] - dur[1] - dur[3]) * 1e-6)
    assert summ["leaf"]["self_ms"] == summ["leaf"]["total_ms"]
    assert 0 <= summ["root"]["self_ms"] <= summ["root"]["total_ms"]


def test_counters_count_whether_on_or_off(rec):
    n = timers.counter("test.things")
    timers.count("test.things")
    rec.enable()
    timers.count("test.things", 3)
    assert timers.counter("test.things") == n + 4
    assert rec.counters()["test.things"] == n + 4
    assert timers.counter("test.never") == 0


def test_spans_open_profiler_ranges_when_on(rec):
    rec.enable()

    def body():
        with span("outer"):
            with span("inner", t=0):
                torch.ones(4).sum()
    names = _profiled_names(body)
    assert "mevi.outer" in names and "mevi.inner" in names
    # and none without a capture, while still recorded
    body()
    assert [x.name for x in rec.spans()] == ["outer", "inner"] * 2


def test_section_timers_are_spans_of_the_recorder(rec):
    t = SectionTimers(sync=False)
    with t.section("sec"):
        pass
    assert [x.name for x in rec.spans()] == ["sec"]     # recorded while off
    rec.enable()
    with span("outer"):
        with t.section("sec"):
            pass
    s = rec.spans()
    assert (s[2].name, s[2].parent) == ("sec", 1)
    summ = t.summary()
    assert summ["sec"]["count"] == 2
    assert summ["sec"]["total_s"] == pytest.approx(sum(
        (x.end_ns - x.start_ns) * 1e-9 for x in s if x.name == "sec"))


def test_dump_writes_spans_counters_and_summary(rec, tmp_path):
    rec.enable()
    with span("a", batch=rec.new_batch()):
        with span("b", t=2):
            pass
    p = tmp_path / "spans.json"
    rec.dump(str(p))
    got = json.loads(p.read_text())
    assert [(x["name"], x["parent"], x["t"]) for x in got["spans"]] == [
        ("a", -1, None), ("b", 0, 2)]
    assert got["summary"]["b"]["count"] == 1
    assert isinstance(got["counters"], dict)


def test_threads_keep_their_own_parents(rec):
    """Many threads record nested spans at once: none is lost, and each
    child's parent is its own thread's root."""
    rec.enable()
    nthreads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(per):
                with span(f"root{k}"):
                    with span(f"child{k}"):
                        pass
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    s = rec.spans()
    assert len(s) == 2 * nthreads * per
    for x in s:
        if x.name.startswith("child"):
            assert s[x.parent].name == "root" + x.name[len("child"):]
        else:
            assert x.parent == -1


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

KARY, M, NB = 4, 4, 3


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    t5 = T5Dims(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nci = NCIT5(NCIDims(t5=t5, kary=KARY, max_output_length=M + 2,
                        adaptor_layer_num=1, adaptor_num_heads=4,
                        adaptor_d_ff=32), device="cpu")
    tower = T5Model(t5, device="cpu")
    with torch.no_grad():
        for m in (nci, tower):
            for p in m.parameters():
                p.copy_(0.2 * torch.randn(p.shape))
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(512, 16)).astype(np.float32)
    codes = rng.integers(0, KARY, size=(512, M)).astype(np.int32)
    index = build_fine_index(codes, emb, KARY, device="cpu")
    ids = torch.from_numpy(rng.integers(2, 60, size=(5, 6)))
    return BucketServer(tower, nci, index, num_beams=NB, cap=16, pool=10,
                        device="cpu"), ids


def _serve(srv, ids):
    return srv.finalize(srv.query_device(ids, torch.ones_like(ids)))


def test_bucket_server_span_tree(rec, server):
    srv, ids = server
    launches = launch_counts()
    off = _serve(srv, ids)
    assert rec.spans() == []
    checks = rec.counter("serve.cidx_check")
    rec.enable()
    h = srv.query_device(ids, torch.ones_like(ids))
    assert len(h) == 4 and h.batch is not None
    on = srv.finalize(h)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert launch_counts() == launches        # the CPU runs the plain version
    # the batch's cluster ids are checked on the device, once, with no
    # host check inside the bucket stage
    assert rec.counter("serve.cidx_check") == checks + 1

    s = rec.spans()
    assert Counter(x.name for x in s) == Counter({
        "serve.query_device": 1, "serve.coarse": 1, "tower": 1, "beam": 1,
        "beam.encode": 1, "beam.step": M + 1, "beam.topk": M,
        "beam.reorder": M - 1, "serve.bucket": 1, "serve.pool": 1,
        "serve.finalize": 1, "finalize.fetch": 1, "finalize.map": 1})
    assert "bucket.bounds_check" not in {x.name for x in s}
    assert {x.batch for x in s} == {h.batch}
    parent = {x.name: s[x.parent].name if x.parent >= 0 else None for x in s}
    assert parent == {
        "serve.query_device": None, "serve.coarse": "serve.query_device",
        "tower": "serve.coarse", "beam": "serve.coarse",
        "beam.encode": "beam", "beam.step": "beam", "beam.topk": "beam",
        "beam.reorder": "beam", "serve.bucket": "serve.query_device",
        "serve.pool": "serve.query_device", "serve.finalize": None,
        "finalize.fetch": "serve.finalize", "finalize.map": "serve.finalize"}
    by_t = {n: [x.t for x in s if x.name == n]
            for n in ("beam.step", "beam.topk", "beam.reorder")}
    assert by_t == {"beam.step": list(range(M + 1)),
                    "beam.topk": list(range(M)),
                    "beam.reorder": list(range(1, M))}

    # a second batch gets its own id, which its finalize takes
    rec.clear()
    h2 = srv.query_device(ids, torch.ones_like(ids))
    assert h2.batch == h.batch + 1
    srv.finalize(h2)
    roots = [x for x in rec.spans() if x.parent == -1]
    assert [(x.name, x.batch) for x in roots] == [
        ("serve.query_device", h2.batch), ("serve.finalize", h2.batch)]
