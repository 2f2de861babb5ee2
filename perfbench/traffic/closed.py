"""Closed loop: batches of ``batch`` queries, the next batch's device half
(``query_device``) issued before the previous batch's host half
(``finalize``), so two batches are in flight.

Parameters (the cell file's ``traffic.params``): ``batch``;
``max_qps``, the rate the inputs are sized for (a window that outruns
them reuses them from the start and says so); ``warm_batches``;
``trace_batches``, the batches of a traced window; ``keep_rows``, rows
of each batch kept for the comparison besides its longest query;
``check_queries``, the size of the compared sample.

End to end: ``qps``, the queries finalized in the window over its
seconds.
"""

from __future__ import annotations

import math
import time

from perfbench import loop
from perfbench.harness import Run, Window
from perfbench.data import slice_queries


def prepare(ctx, seconds, trace):
    p = ctx.cell["traffic"]["params"]
    B = p["batch"]
    n = (math.ceil(seconds * p["max_qps"] / B) + 2
         + (p["trace_batches"] + 1 if trace else 0))
    ctx.state.update(
        B=B, nb=ctx.cfg["serving"]["num_beams"], n=n,
        queries=ctx.queries(n * B, stream=10, batch=B),
        warm=ctx.queries(p["warm_batches"] * B, stream=11, batch=B))
    ctx.state["served"] = loop.Served(
        ctx.state["queries"].lengths.cpu().numpy(), B, ctx.seed,
        p["keep_rows"])


def _batch(ctx, qs, i):
    st = ctx.state
    j = i % st["n"]
    if i == st["n"]:
        loop.log("closed loop: the window outran its inputs; reusing them")
    return slice_queries(qs, j * st["B"], (j + 1) * st["B"], st["nb"])


def warm(ctx):
    st = ctx.state
    h = None
    for i in range(ctx.cell["traffic"]["params"]["warm_batches"]):
        nxt = loop.issue(ctx.server, _batch(ctx, st["warm"], i))
        if h is not None:
            ctx.server.finalize(h)
        h = nxt
    ctx.server.finalize(h)


class _Stream:
    """Issues batch i, finalizes batch i - 1, keeping their rows.  A
    batch in flight is its handle and the tower output the tap saw."""

    def __init__(self, ctx, traced=False):
        self.ctx, self.st, self.traced = ctx, ctx.state, traced
        self.srv, self.served = ctx.server, ctx.state["served"]
        self.h, self.i = None, 0
        self.on_issue = None    # called with each batch's index once issued

    def issue(self):
        try:
            h = loop.issue(self.srv, _batch(self.ctx, self.st["queries"],
                                            self.i))
            self.h_next = (h, self.ctx.tap.last)
        except Exception:
            self.served.fail(self.st["B"])
            self.h_next = None
        if self.on_issue is not None:
            self.on_issue(self.i)
        self.i += 1

    def finalize(self, before=None):
        """The batch issued before the last; ``before()`` runs first."""
        i, h = self.i - 2, self.h
        self.h = self.h_next
        if h is None:
            return 0.0
        if before is not None:
            before(i)
        t0 = time.perf_counter()
        try:
            with loop.ranged("finalize", self.traced):
                out = self.srv.finalize(h[0])
        except Exception:
            self.served.fail(self.st["B"])
            return time.perf_counter() - t0
        secs = time.perf_counter() - t0
        self.served.keep(i % self.st["n"], out, h[1])
        return secs


def _window(s, seconds, wait=None):
    """Batches for ``seconds``: (batches finalized, elapsed seconds, the
    host seconds of each ``finalize``, the time each batch finished)."""
    fin, done_at = [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        s.issue()
        fin.append(s.finalize(wait))
        done_at.append(time.perf_counter())
        if done_at[-1] >= end:
            break
    return len(fin), done_at[-1] - t0, fin, [t - t0 for t in done_at]


def _blocks(done_at, B, nblk=6):
    """Queries/s in ``nblk`` equal spans of the window, for the log: a
    drift inside the window shows against a shift between runs."""
    span = done_at[-1] / nblk
    idx = [min(int(t / span), nblk - 1) for t in done_at]
    return [round(idx.count(k) * B / span, 1) for k in range(nblk)]


def measure(ctx, seconds):
    st = ctx.state
    s = _Stream(ctx)
    s.issue()
    s.h = s.h_next
    done, elapsed, _, done_at = _window(s, seconds)
    s.h_next = None
    s.i += 1
    s.finalize()                # the batch in flight, after the window
    p = ctx.cell["traffic"]["params"]
    qps = (done * st["B"] - st["served"].failed) / elapsed
    loop.log(f"{done} batches x {st['B']} in {elapsed:.3f}s -> {qps:.1f} q/s"
             f"; by sixths of the window {_blocks(done_at, st['B'])}")
    return Run(metrics={"qps": qps}, attempted=(done + 1) * st["B"],
               failed=st["served"].failed,
               sample=st["served"].sample(st["queries"], st["nb"],
                                          p["check_queries"], ctx.seed))


def traced(ctx, seconds):
    """The untraced window of ``seconds`` (its wall time and the model
    FLOPs of its batches, each ``finalize`` timed once its batch's device
    work is done), then ``trace_batches`` batches under the profiler,
    inside ``pb.window``, whose device work the trace's metrics read."""
    import torch
    st = ctx.state
    p = ctx.cell["traffic"]["params"]
    N = p["trace_batches"]
    s = _Stream(ctx)
    events = {}

    def mark(i):
        if ctx.dev.type == "cuda":
            events[i] = torch.cuda.Event()
            events[i].record()

    def wait(i):
        if i in events:
            events.pop(i).synchronize()

    s.on_issue = mark
    s.issue()
    s.h = s.h_next
    done, wall, fin, _ = _window(s, seconds, wait)
    untraced = range(done)
    s.on_issue = None
    s.traced = True
    with loop.Profiled(ctx.dev) as prof:
        s.issue()               # warms the profiler, before the window
        s.finalize()
        first = s.i
        with prof.window():
            for _ in range(N):
                s.issue()
                s.finalize()
        s.h_next = None
        s.i += 1
        s.finalize()
    tr = prof.read()
    loop.log(f"untraced: {done} batches in {wall:.3f}s; traced: {N} in "
             f"{tr.window_s:.3f}s (the profiler's host work)")
    lens = st["queries"].lengths.reshape(-1, st["B"]).cpu().numpy()
    cidx = st["queries"].cidx.reshape(-1, st["B"] * st["nb"]).cpu().numpy()
    issued = range(first, first + N)
    bb = [ctx.bucket_counts(cidx[i % st["n"]]) for i in issued]
    win = Window(trace=tr, n=N, bucket_bytes=sum(b[0] for b in bb),
                 bucket_flops=sum(b[1] for b in bb), finalize_s=fin,
                 wall_flops=sum(ctx.model_flops(lens[i % st["n"]])
                                for i in untraced),
                 wall_s=wall)
    return Run(metrics={}, attempted=s.i * st["B"],
               failed=st["served"].failed,
               sample=st["served"].sample(st["queries"], st["nb"],
                                          p["check_queries"], ctx.seed),
               window=win)
