"""Trace-derived stage timing and model FLOPs (port of
``mevi_tpu.utils.profiling``).

Both sides of a peak-share ratio are measured, not hand-rolled:

* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` over one
  call (the counts of the matrix products and attention PyTorch
  dispatched; elementwise work is not counted), in place of XLA's cost
  analysis of the compiled program;
* **device time** from a ``torch.profiler`` capture exported as a chrome
  trace: the CUDA kernels' events (``cat == "kernel"``) summed by name,
  so host time and gaps between kernels are left out.

The peak is the H100 SXM's (NVIDIA's data sheet, dense, at its 700 W
limit); a card set to a lower power limit runs below it.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device, synchronize

H100_SXM_BF16_DENSE_FLOPS = 989e12     # bf16 tensor cores, dense
H100_SXM_HBM_BYTES_PER_S = 3.35e12


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts
    them (a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _trace_file(trace_path: str) -> str:
    """``trace_path`` itself, or the newest ``*.json`` / ``*.json.gz``
    under it."""
    if not os.path.isdir(trace_path):
        return trace_path
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_path, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no chrome trace under {trace_path}")
    return max(paths, key=os.path.getmtime)


def _outermost(events):
    """The events not inside another of the list on the same process and
    thread (complete events: ``ts`` and ``dur`` in us)."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (float(e.get("ts", 0.0)),
                                           -float(e.get("dur", 0.0)))):
        lane = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        if ts >= ends.get(lane, -float("inf")):
            out.append(e)
            ends[lane] = ts + float(e.get("dur", 0.0))
    return out


def device_op_seconds(trace_path: str, category: str = "kernel"
                      ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """Device kernel time of a ``torch.profiler`` chrome trace (a file,
    gzipped or not, or the newest one under a directory): the complete
    events of category ``kernel`` (CUDA kernels; memcpy and memset events
    have their own categories and are left out).  ``category="cpu_op"``
    reads a CPU-only trace instead: the outermost operator events of
    each thread (an operator's nested calls are not counted twice).
    Returns (total seconds, seconds by name, calls by name)."""
    path = _trace_file(trace_path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fr:
        events = json.load(fr).get("traceEvents", [])
    events = [e for e in events
              if e.get("ph") == "X" and e.get("cat") == category]
    if category == "cpu_op":
        events = _outermost(events)
    per_op: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in events:
        name = e.get("name", "?")
        per_op[name] = per_op.get(name, 0.0) + float(e.get("dur", 0.0)) * 1e-6
        calls[name] = calls.get(name, 0) + 1
    return sum(per_op.values()), per_op, calls


class StageTrace(NamedTuple):
    device_s: float              # device kernel seconds a call
    wall_s: float                # host seconds a call (calls end synced)
    per_op: Dict[str, float]     # kernel seconds by name, whole capture
    calls: Dict[str, int]        # launches by name, whole capture


def traced_stage_seconds(fn: Callable[[int], object], n: int = 3,
                         trace_dir: Optional[str] = None, device="cuda"
                         ) -> StageTrace:
    """Run ``fn(i)`` for i < n under ``torch.profiler`` (CPU and CUDA
    activity), the card synchronized before and after, export the chrome
    trace to ``trace_dir`` (a temporary directory by default) and read
    it back with :func:`device_op_seconds`.  Raises without a card when
    ``device`` is CUDA; with ``device="cpu"`` the trace is the host's
    and its "device" time the outermost operators' (``cpu_op``)."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    synchronize(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(trace_dir or tmp, "trace.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            synchronize(dev)
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(out)
        total, per_op, calls = device_op_seconds(
            out, "kernel" if on_card else "cpu_op")
    return StageTrace(total / max(n, 1), wall / max(n, 1), per_op, calls)


def sequential_pipelined_ms(fn: Callable[[int], object], iters: int = 5,
                            warmup: int = 1, device="cuda"
                            ) -> Tuple[float, float]:
    """ms a call of ``fn(i)``: sequential (each call launched, then the
    device synchronized) and pipelined (``iters`` calls launched back to
    back, one synchronize), after ``warmup`` calls.  CUDA events time the
    card; the host clock times the CPU."""
    dev = resolve_device(device)
    for i in range(warmup):
        fn(i)
    synchronize(dev)

    def span(calls):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for i in calls:
                fn(i)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        for i in calls:
            fn(i)
        return (time.perf_counter() - t0) * 1e3
    seq = sum(span([warmup + i]) for i in range(iters)) / iters
    pipe = span(range(iters)) / iters
    return seq, pipe
