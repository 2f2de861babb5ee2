"""One trace of the incremental beam at the serving shapes, lane by lane
(port of ``scripts/trace_beam_only.py``): the companion of
``profile_beam`` that shows where the trace's time lies.  It captures
one ``torch.profiler`` trace of ``n`` = 3 calls of
``nci_beam_search_incremental`` (T5-base NCI 12 + 6 + PAWA 4, batch
``B`` = 512 x 10 beams, bf16; with the PAWA prefix tables unless
``PAWA_TABLES=0``), prints every process / thread (stream) lane with its
total event time and event count, then the kernel breakdown of
``utils.profiling.device_op_seconds``.

    python -m mevi_tpu_torch.scripts.trace_beam_only [--device cuda|cpu]

Ends with one JSON line.  On the CPU: batch 4, a tiny float32 model,
host operators.  The JAX compilation cache and the one-element fetches
have no counterpart.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import torch

from .. import resolve_device, synchronize
from .profile_beam import NB, QLEN, default_batch, serving_nci


def lanes(trace_path):
    """(process name, thread name) -> (seconds, complete events) of a
    chrome trace."""
    from ..utils.profiling import _trace_file
    path = _trace_file(trace_path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fr:
        ev = json.load(fr).get("traceEvents", [])
    pnames, tnames = {}, {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = str(e.get("args", {}).get("name", ""))
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e.get("tid"))] = str(
                e.get("args", {}).get("name", ""))
    out = {}
    for e in ev:
        if e.get("ph") != "X":
            continue
        key = (pnames.get(e.get("pid"), str(e.get("pid"))),
               tnames.get((e.get("pid"), e.get("tid")), str(e.get("tid"))))
        s, n = out.get(key, (0.0, 0))
        out[key] = (s + float(e.get("dur", 0.0)) * 1e-6, n + 1)
    return out


def run(device="cuda", B=None, n=3):
    from ..decode.beam import nci_beam_search_incremental
    from ..utils import profiling as P
    dev = resolve_device(device)
    B = B or default_batch(dev, card=512)
    t0 = time.time()
    model = serving_nci(dev)
    ids = torch.ones((B, QLEN), dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        tables = model.head_level_tables()
        pawa_tables = None
        if os.environ.get("PAWA_TABLES", "1") != "0":
            pawa_tables = model.pawa_prefix_tables(level_tables=tables)
    synchronize(dev)
    print(f"model and tables {time.time() - t0:.1f}s", file=sys.stderr,
          flush=True)

    @torch.inference_mode()
    def beam(i):
        return nci_beam_search_incremental(
            model, ids + (i % 2), mask, NB, level_tables=tables,
            pawa_tables=pawa_tables)

    beam(0)
    beam(1)
    with tempfile.TemporaryDirectory() as tmp:
        tr = P.traced_stage_seconds(beam, n=n, trace_dir=tmp, device=dev)
        lane = lanes(tmp)
    top_lanes = sorted(lane.items(), key=lambda kv: -kv[1][0])[:20]
    for (p, t), (s, k) in top_lanes:
        print(f"lane ({p!r}, {t!r}): {s * 1e3:.1f} ms over {k} events",
              flush=True)
    print(f"[trace] beam: device {tr.device_s * 1e3:.2f} ms/call",
          flush=True)
    top = sorted(tr.per_op.items(), key=lambda kv: -kv[1])[:40]
    for op, s in top:
        print(f"    {s * 1e3 / n:8.3f} ms  {op[:100]}", flush=True)
    return {"batch": B, "calls": n, "pawa_tables": pawa_tables is not None,
            "beam_device_ms": tr.device_s * 1e3,
            "kernels_a_call": sum(tr.calls.values()) / n,
            "lanes": [[p, t, s * 1e3, k] for (p, t), (s, k) in top_lanes],
            "top_ops_ms": [[op, s / n * 1e3] for op, s in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
