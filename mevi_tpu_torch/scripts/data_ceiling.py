"""Data-ceiling bounds of a quality workdir's dev set (port of
``scripts/data_ceiling.py``): the Bayes bound and the oracle
single-vector-tower bound (:func:`mevi_tpu_torch.eval.ceiling.
ceiling_report`), so trained numbers read as measured / ceiling.

    python -m mevi_tpu_torch.scripts.data_ceiling [OUT] [--device cuda|cpu]

Reads ``spec.json``, ``dev_docs.npy``, ``dev_tokens.npy`` and
``codes.npy`` from ``CEIL_WORKDIR`` (default: the workdir of
``scripts.quality_full``), scores the first ``CEIL_N`` (1024) dev
queries, prints one JSON line (the JAX line's keys; ``workdir`` is the
absolute path) and writes it to ``OUT`` (default
``<workdir>/CEILING.json``).  ``CEIL_FORCE_CPU`` is not read:
``--device cpu`` takes its place.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import numpy as np

from .. import resolve_device
from .quality_full import default_workdir


def report(workdir, n=1024, device="cuda"):
    """The ceiling line of ``workdir``'s first ``n`` dev queries."""
    from ..data import synth
    from ..eval.ceiling import ceiling_report
    dev = resolve_device(device)
    spec = synth.load_spec(osp.join(workdir, "spec.json"))
    draws = synth.make_draws(spec)
    codes = np.load(osp.join(workdir, "codes.npy"))
    gt = np.load(osp.join(workdir, "dev_docs.npy"))[:n]
    tok = np.load(osp.join(workdir, "dev_tokens.npy"))[:n]
    tab = synth.make_tables(spec)
    t0 = time.time()
    rep = ceiling_report(spec, tab, draws, codes, tok, gt, device=dev)
    rep.update({"workdir": osp.abspath(workdir), "n_dev": len(gt),
                "ndoc": spec.ndoc, "info_dropout": spec.info_dropout,
                "secs": round(time.time() - t0, 1)})
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=None,
                    help="output path (default <workdir>/CEILING.json)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    workdir = os.environ.get("CEIL_WORKDIR", default_workdir())
    rep = report(workdir, int(os.environ.get("CEIL_N", 1024)), args.device)
    with open(args.out or osp.join(workdir, "CEILING.json"), "w") as fw:
        fw.write(json.dumps(rep) + "\n")
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
