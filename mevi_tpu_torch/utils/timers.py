"""Timing / profiling utilities (port of ``mevi_tpu.utils.timers``): the
process-wide span recorder, named wall-clock sections on it that wait
for the device at their boundaries, and a ``torch.profiler`` trace
context for deep dives.

Spans.  ``span(name)`` marks a layer boundary of the program (the
serving path's names: ``serve.*``, ``tower``, ``beam.*``,
``bucket.bounds_check``, ``finalize.*``).  Recording is off by default:
then ``span`` tests one flag and returns a shared no-op context.  After
``enable()`` each span records its name, the index of its parent (the
innermost span open on its thread, -1 for none), its batch id (given,
or its parent's), an optional level ``t`` and its start and end on
``time.perf_counter_ns()``, into a list in memory that a reader takes
at the end (``spans()``, ``summary()``, ``dump(path)``).  While a
``torch.profiler`` capture is active, a recorded span also opens the
profiler range ``mevi.<name>``, so it lies on the trace's clock beside
the device operations launched inside it.

Counters.  ``count(name, n)`` adds to a named counter whether spans are
on or off (the bucket kernels' launches, ``bucket.launches.<mode>``; the
server's device-side cluster id checks, ``serve.cidx_check``);
``counter(name)`` reads it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One recorded span; ``parent`` indexes the same list (-1: a root);
    ``end_ns`` is None while the span is open."""
    name: str
    parent: int
    batch: Optional[int]
    t: Optional[int]
    start_ns: int
    end_ns: Optional[int]


class _NoSpan:
    """The context ``span`` returns while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Open:
    """A span being recorded: its row ``[name, parent, batch, t, start,
    end]`` in the recorder's list, and its profiler range if any."""

    __slots__ = ("rec", "name", "t", "batch", "row", "range")

    def __init__(self, rec, name, t, batch):
        self.rec, self.name, self.t, self.batch = rec, name, t, batch

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("mevi." + self.name)
            self.range.__enter__()
        with rec._lock:
            parent = stack[-1] if stack else -1
            batch = self.batch
            if batch is None and parent >= 0:
                batch = rec._rows[parent][2]
            self.row = [self.name, parent, batch, self.t, 0, None]
            stack.append(len(rec._rows))
            rec._rows.append(self.row)
        self.row[4] = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.row[5] = time.perf_counter_ns()
        self.rec._stack().pop()
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        return False


class Recorder:
    """Spans and counters of one process (module-level ``SPANS``)."""

    def __init__(self):
        self.on = False
        self._rows: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._batches = itertools.count()
        self._counts: Dict[str, int] = defaultdict(int)

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, t: Optional[int] = None,
             batch: Optional[int] = None):
        """Context of a span ``name`` (a no-op while off); ``t``: the
        level or step it belongs to; ``batch``: its batch id, else its
        parent's."""
        if not self.on:
            return _NO_SPAN
        return _Open(self, name, t, batch)

    def record(self, name: str):
        """A span recorded whether or not the recorder is on (the
        sections of :class:`SectionTimers`)."""
        return _Open(self, name, None, None)

    def new_batch(self) -> Optional[int]:
        """A fresh batch id for a batch's root span; None while off."""
        return next(self._batches) if self.on else None

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] += n

    def counter(self, name: str) -> int:
        return self._counts.get(name, 0)

    def counters(self) -> Dict[str, int]:
        return dict(self._counts)

    def spans(self) -> List[Span]:
        with self._lock:
            return [Span(*r) for r in self._rows]

    def clear(self) -> None:
        """Drop the recorded spans (call with no span open); counters
        stay."""
        with self._lock:
            self._rows = []

    def summary(self) -> Dict[str, Dict[str, float]]:
        """For each span name: count, total host ms, and self ms (the
        duration less the part its child spans cover)."""
        return summarize(self.spans())

    def dump(self, path: str) -> None:
        """Write the spans, counters and summary as JSON."""
        with open(path, "w") as fw:
            json.dump({"spans": [s._asdict() for s in self.spans()],
                       "counters": self.counters(),
                       "summary": self.summary()}, fw)


def summarize(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """:meth:`Recorder.summary` of a list of spans (open ones left
    out).  Children nest inside their parent on one thread, so the
    part of a span they cover is the sum of their durations."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0 and s.end_ns is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for s, c in zip(spans, child_ns):
        if s.end_ns is None:
            continue
        d = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        dur = s.end_ns - s.start_ns
        d["count"] += 1
        d["total_ms"] += dur * 1e-6
        d["self_ms"] += (dur - c) * 1e-6
    return out


SPANS = Recorder()
span = SPANS.span
count = SPANS.count
counter = SPANS.counter
enable = SPANS.enable
disable = SPANS.disable
new_batch = SPANS.new_batch


def _sync_all():
    """Wait for the queued work of the current CUDA device, if any."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _block_on(x):
    """Wait for the device work behind ``x`` (a tensor, or a list,
    tuple or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _block_on(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _block_on(v)


class SectionTimers:
    """Named wall-clock sections with device sync at the boundaries.
    Each section is a span of ``SPANS``, recorded whether or not it is
    on (inside the innermost open span, on the same clock)."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self._rows: List[list] = []

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        """Time the body; ``block_on``: tensors whose devices are
        synchronized at the end (else the current device, with
        ``sync``)."""
        if self.sync:
            # drain pending device work so the section measures itself
            _sync_all()
        with SPANS.record(name) as s:
            yield
            if block_on is not None:
                _block_on(block_on)
            elif self.sync:
                _sync_all()
        self._rows.append(s.row)

    @property
    def times(self) -> Dict[str, List[float]]:
        """Seconds of each section, by name."""
        out: Dict[str, List[float]] = defaultdict(list)
        for name, _, _, _, t0, t1 in self._rows:
            out[name].append((t1 - t0) * 1e-9)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "min_ms": 1e3 * min(ts),
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as fw:
            json.dump(self.summary(), fw, indent=1)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace (CPU, and CUDA when present) written
    to ``log_dir`` for TensorBoard; a no-op without a directory."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
