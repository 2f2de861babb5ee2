"""Reading a ``torch.profiler`` chrome trace: a frozen copy of the kernel
reader of ``mevi_tpu_torch/utils/profiling.py`` (complete events of the
device categories, seconds by name), extended with attribution.

The harness wraps the server's own calls in ``record_function`` ranges
named ``pb.<layer>``.  A device operation belongs to the innermost range
that was open on the host when it was launched (its runtime launch event
shares its ``correlation`` id); every kernel launched inside a range
counts toward it, whatever kernel it is.  Busy time is the union of the
device operations' intervals inside the traced window; the rest of the
window is idle, and each idle gap is named by the innermost range open
on the host when it began.
"""

from __future__ import annotations

import bisect
import gzip
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "pb."
NAME_CHARS = 120


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fr:
        return [e for e in json.load(fr).get("traceEvents", [])
                if e.get("ph") == "X"]


class Ranges:
    """The harness's host ranges, for innermost-at-time lookups."""

    def __init__(self, events):
        self.r = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"][len(PREFIX):]) for e in events
                         if e.get("cat") == "user_annotation"
                         and e.get("name", "").startswith(PREFIX)),
                        key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.r]

    def stack_at(self, ts: float) -> List[str]:
        """Names of the ranges open at ``ts``, outermost first."""
        i = bisect.bisect_right(self.starts, ts)
        return [n for a, b, n in self.r[:i] if a <= ts < b]

    def named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for a, b, n in self.r if n == name]


class Trace:
    """Device operations of a trace with the host ranges they belong to;
    ``window``: the extent of the ``pb.window`` range, in the trace's
    microseconds."""

    def __init__(self, events):
        self.ranges = Ranges(events)
        launch_ts = {e["args"]["correlation"]: float(e["ts"])
                     for e in events if e.get("cat") in LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        w = self.ranges.named("window")
        if not w:
            raise ValueError("trace has no pb.window range")
        self.window = (w[0][0], w[-1][1])
        self.ops = []       # (ts, end, cat, name, host range stack)
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            ts = float(e["ts"])
            corr = e.get("args", {}).get("correlation")
            at = launch_ts.get(corr)
            stack = self.ranges.stack_at(at) if at is not None else []
            self.ops.append((ts, ts + float(e.get("dur", 0.0)), e["cat"],
                             e.get("name", "?"), stack))
        self.ops.sort()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out = []
        for a, b, *_ in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def layer_ops(self, inside: str, outside: Optional[str] = None,
                  cats=("kernel",)):
        """Device operations launched inside range ``inside`` and not
        inside ``outside``, launched within the window."""
        return [op for op in self.ops if op[2] in cats and inside in op[4]
                and (outside is None or outside not in op[4])
                and "window" in op[4]]

    def layer_seconds(self, inside, outside=None) -> Optional[float]:
        ops = self.layer_ops(inside, outside)
        return sum(b - a for a, b, *_ in ops) * 1e-6 if ops else None

    def device_ops(self, top: int = 10):
        lo, hi = self.window
        by = defaultdict(float)
        for a, b, cat, name, _ in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                by[name[:NAME_CHARS]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle seconds in the window by the innermost host range open
        when each gap began (``harness`` outside every range)."""
        lo, hi = self.window
        by: Dict[str, float] = defaultdict(float)
        t = lo
        for a, b in self.busy_intervals() + [(hi, hi)]:
            if a > t:
                stack = [n for n in self.ranges.stack_at(t) if n != "window"]
                by[stack[-1] if stack else "harness"] += (a - t) * 1e-6
            t = max(t, b)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda x: -x[1])[:top]
