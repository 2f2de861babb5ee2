"""int8 against bf16 quality at equal geometry (port of
``scripts/int8_tax.py``): ``mevi_tpu_torch.bench`` run twice on the same
corpus size, seed, batch and codebooks, once over a bf16 corpus and once
over int8, each in a process of its own so that its device memory is
returned, and one artifact with both recall sets and their deltas.

    python -m mevi_tpu_torch.scripts.int8_tax [--ndoc N] [--ckpt DIR]
        [--out PATH] [--timeout S] [--device cuda|cpu] [bench flags...]

``--ndoc`` defaults to the full 8,841,823 documents (the H100 holds the
bf16 corpus; the JAX script halved it for the v5e).  With ``--ckpt`` (a
``scripts.quality_full`` bundle) the trained pipeline's ``trained_*``
recalls are compared too.  Flags it does not know (``--batch``,
``--nbatch``, ``--cap``, ``--bucket_kernel``) pass to both runs.  The
random-weight pipeline's RQ fit is cached by the corpus spec
(``data.synth.fit_rq_codes``), so both runs assign with one fit.  The
artifact goes to ``--out`` (default ``<tempdir>/int8_tax.json``) and to
stdout; a failed run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile

from .. import resolve_device

RECALL_KEYS = (
    "recall100_beam_coarse", "recall100_oracle_coarse",
    "oracle_cluster_coverage", "trained_coarse_hit@1",
    "trained_coarse_hit@10",
    "trained_fine_recall@100", "value", "int8_scale", "ndoc_per_query",
)
PACKAGE_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def run_child(ndoc, dtype, device, ckpt=None, extra=(), timeout=1800):
    """One ``mevi_tpu_torch.bench`` process; returns its result line."""
    cmd = [sys.executable, "-m", "mevi_tpu_torch.bench", "--ndoc", str(ndoc),
           "--dtype", dtype, "--device", device, *extra]
    if ckpt:
        cmd += ["--ckpt", ckpt]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    r = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, timeout=timeout)
    lines = r.stdout.decode().strip().splitlines()
    if r.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise SystemExit(f"bench run failed: ndoc={ndoc} dtype={dtype} "
                         f"rc={r.returncode}")
    return json.loads(lines[-1])


def tax(lines, ndoc):
    """The artifact: both recall sets and int8 - bf16 of each recall and
    hit key."""
    sets = {dt: {k: lines[dt][k] for k in RECALL_KEYS if k in lines[dt]}
            for dt in ("bf16", "int8")}
    out = {"metric": "int8_quality_tax", "ndoc": ndoc, **sets}
    for k in RECALL_KEYS:
        a, b = sets["bf16"].get(k), sets["int8"].get(k)
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and ("recall" in k or "hit" in k):
            out[f"delta_{k}"] = round(float(b) - float(a), 4)
    return out


def run(ndoc, device="cuda", ckpt=None, extra=(), timeout=1800):
    """Both runs; returns (artifact, {dtype: bench line})."""
    resolve_device(device)
    lines = {}
    for dtype in ("bf16", "int8"):
        lines[dtype] = run_child(ndoc, dtype, device, ckpt, extra, timeout)
        print(f"{dtype}: {lines[dtype]}", file=sys.stderr, flush=True)
    return tax(lines, ndoc), lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ndoc", type=int, default=8_841_823)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default=osp.join(tempfile.gettempdir(),
                                              "int8_tax.json"))
    ap.add_argument("--timeout", type=int, default=1800,
                    help="seconds a bench run may take")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, extra = ap.parse_known_args(argv)
    out, _ = run(args.ndoc, args.device, args.ckpt, extra, args.timeout)
    with open(args.out, "w") as fw:
        fw.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
