"""Timing / profiling utilities (port of ``mevi_tpu.utils.timers``):
named wall-clock sections that wait for the device at their boundaries,
and a ``torch.profiler`` trace context for deep dives."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


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
    """Named wall-clock sections with device sync at the boundaries."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        """Time the body; ``block_on``: tensors whose devices are
        synchronized at the end (else the current device, with
        ``sync``)."""
        if self.sync:
            # drain pending device work so the section measures itself
            _sync_all()
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _block_on(block_on)
        elif self.sync:
            _sync_all()
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            if not ts:
                continue
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
