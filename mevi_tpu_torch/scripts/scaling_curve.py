"""Trained-pipeline quality against corpus size (port of
``scripts/scaling_curve.py``): one ``mevi_tpu_torch.bench`` process per
corpus size over a ``scripts.quality_full`` bundle (the served path:
trained tower + NCI beam -> the v3 bucket kernel, an int8 corpus by
default), its ``trained_*`` keys collected into one curve, one sidecar
a size (a re-run resumes at the missing sizes; ``SC_FRESH=1`` measures
every size again).

    python -m mevi_tpu_torch.scripts.scaling_curve [--device cuda|cpu]
        [bench flags...]

Environment knobs (the JAX script's): ``SC_SIZES`` (comma ints, default
1000000,2210455,4420911,8841823), ``SC_CAPS`` (comma ints: a cap sweep
at the largest size), ``SC_DTYPE`` (int8), ``SC_OUT`` (default
``build/scaling_curve.json``), ``SC_STAGE_DIR`` (default
``build/scaling_stages``), ``BENCH_CKPT`` (the bundle, default the
workdir of ``scripts.quality_full``), ``SC_TIMEOUT`` (seconds a child,
3000), ``SC_FRESH``.  Flags it does not know (``--nbatch``, ``--batch``)
pass to every child.

Not carried over: the JAX script skips a size whose child times out or
fails and writes the curve without it.  Here such a child stops the run
with a non-zero exit that names the size.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

from .. import resolve_device
from .int8_tax import PACKAGE_ROOT, run_child
from .quality_full import default_workdir

KEEP = ("ndoc", "trained_coarse_hit@1", "trained_coarse_hit@10",
        "trained_fine_recall@100", "trained_fine_mrr@10",
        "trained_fine_recall@100_beam_major",
        "trained_fine_mrr@10_beam_major",
        "trained_ndoc_per_query", "cluster_sizes", "value",
        "corpus_dtype", "batch", "cap")
BUILD_DIR = osp.join(PACKAGE_ROOT, "build")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def jobs_of(sizes, caps):
    """(ndoc, cap or None): each size, then the cap sweep at the
    largest."""
    return [(n, None) for n in sizes] + [(sizes[-1], c) for c in caps]


def tag_of(ndoc, dtype, cap):
    return f"size_{ndoc}_{dtype}" + (f"_cap{cap}" if cap else "")


def run(sizes, dtype="int8", device="cuda", ckpt=None, caps=(),
        side_dir=None, timeout=3000, fresh=False, extra=()):
    """Every job's row (from its sidecar, or from a new child).  Returns
    (the curve dict, {tag: whole bench line} of the children run now).
    A child that fails or times out raises ``SystemExit`` naming its
    size."""
    resolve_device(device)
    ckpt = ckpt or default_workdir()
    side_dir = side_dir or osp.join(BUILD_DIR, "scaling_stages")
    os.makedirs(side_dir, exist_ok=True)
    jobs = jobs_of(list(sizes), list(caps))
    rows, lines = [], {}
    for ndoc, cap in jobs:
        side_p = osp.join(side_dir, f"{tag_of(ndoc, dtype, cap)}.json")
        if osp.exists(side_p) and not fresh:
            log(f"{tag_of(ndoc, dtype, cap)}: cached")
            with open(side_p) as fr:
                rows.append(json.load(fr))
            continue
        t0 = time.time()
        flags = list(extra) + (["--cap", str(cap)] if cap else [])
        try:
            obj = run_child(ndoc, dtype, device, ckpt, flags, timeout)
        except subprocess.TimeoutExpired:
            raise SystemExit(f"size {ndoc}: bench child timed out after "
                             f"{timeout} s") from None
        lines[tag_of(ndoc, dtype, cap)] = obj
        row = {k: obj[k] for k in KEEP if k in obj}
        row["secs"] = round(time.time() - t0, 1)
        with open(side_p, "w") as fw:
            fw.write(json.dumps(row) + "\n")
        log(f"size {ndoc}: fine recall@100 "
            f"{row.get('trained_fine_recall@100')} ({row['secs']}s)")
        rows.append(row)
    return {"metric": "trained_recall_vs_corpus_size", "dtype": dtype,
            "bundle": ckpt, "curve": rows}, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, extra = ap.parse_known_args(argv)
    sizes = [int(s) for s in os.environ.get(
        "SC_SIZES", "1000000,2210455,4420911,8841823").split(",")]
    caps = [int(c) for c in os.environ.get("SC_CAPS", "").split(",") if c]
    out, _ = run(sizes, os.environ.get("SC_DTYPE", "int8"), args.device,
                 os.environ.get("BENCH_CKPT"), caps,
                 os.environ.get("SC_STAGE_DIR"),
                 int(os.environ.get("SC_TIMEOUT", 3000)),
                 bool(os.environ.get("SC_FRESH")), extra)
    out_p = os.environ.get("SC_OUT", osp.join(BUILD_DIR,
                                              "scaling_curve.json"))
    os.makedirs(osp.dirname(osp.abspath(out_p)), exist_ok=True)
    with open(out_p, "w") as fw:
        fw.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
