"""The NCI beam's device time at the serving config, by kernel category
(port of ``scripts/beam_trace.py``): ``nci_beam_search_incremental``
(T5-base NCI 12 + 6 + PAWA 4, RQ 4 x 32, batch ``BT_B`` = 512 x 10
beams, bf16, random weights) traced with ``torch.profiler`` over 3
calls (``utils.profiling.traced_stage_seconds``), its CUDA kernels'
time sorted into categories by :data:`CATEGORIES`, and its share of the
H100 bf16 dense peak from the FLOPs of the same call
(``utils.profiling.flops_of``).

    python -m mevi_tpu_torch.scripts.beam_trace [--device cuda|cpu]

Writes the artifact to ``BT_OUT`` (default ``build/beam_trace.json``;
``BT_LABEL`` names its row) and prints its summary as one JSON line.  On
the CPU: batch 4, a 2 + 2 layer model at d 32 in float32, the host's
outermost operators in place of kernels, and no peak share.

Not carried over: the JAX script's ``fl = None`` when the FLOPs count
fails (here the failure raises), its XLA op categories (fusion, copy,
reshape: a CUDA trace names kernels) and its history of TPU rows.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import torch

from .. import resolve_device, synchronize
from .int8_tax import PACKAGE_ROOT
from .profile_beam import NB, QLEN, default_batch, serving_nci

# kernel (or host operator) name -> category: the first row whose
# patterns one lowercase substring matches
CATEGORIES = (
    ("bucket_kernel", ("bucket_kernel",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "matmul", "xmma", "cublas",
              "fmha", "flash", "aten::mm", "aten::bmm", "aten::addmm",
              "aten::linear", "aten::matmul", "aten::einsum")),
    ("reduction_softmax", ("softmax", "reduce", "norm", "topk", "sort",
                           "argmax", "aten::sum", "aten::mean", "cub::")),
    ("index_cat", ("index", "gather", "scatter", "cat", "embedding",
                   "aten::take", "aten::repeat")),
    ("copy_memcpy", ("memcpy", "copy", "aten::to", "aten::contiguous",
                     "aten::clone")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "aten::add",
                     "aten::mul", "aten::sub", "aten::div", "aten::where",
                     "aten::relu", "aten::rsqrt", "aten::pow", "aten::tanh",
                     "aten::exp", "aten::fill", "aten::zero")),
)
OTHER = "other"


def category(name: str) -> str:
    """The category of one kernel or operator name."""
    n = name.lower()
    for cat, pats in CATEGORIES:
        if any(p in n for p in pats):
            return cat
    return OTHER


def categorize(per_op):
    """Seconds by name -> seconds by category (every category present)."""
    cats = {c: 0.0 for c, _ in CATEGORIES}
    cats[OTHER] = 0.0
    for name, sec in per_op.items():
        cats[category(name)] += sec
    return cats


def trace(device="cuda", B=None, n=3, trace_dir=None):
    """The artifact dict of one traced run."""
    from ..decode.beam import nci_beam_search_incremental
    from ..utils import profiling as P
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B = B or default_batch(dev, "BT_B", card=512)
    t0 = time.time()
    model = serving_nci(dev)
    ids = torch.ones((B, QLEN), dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        tables = model.head_level_tables()

    @torch.inference_mode()
    def beam(i):
        return nci_beam_search_incremental(model, ids + (i % 2), mask, NB,
                                           level_tables=tables)[0]
    beam(0)
    synchronize(dev)
    print(f"model and first call {time.time() - t0:.1f}s", file=sys.stderr,
          flush=True)
    tr = P.traced_stage_seconds(beam, n=n, trace_dir=trace_dir, device=dev)
    fl = P.flops_of(beam, 0)
    if not fl > 0:
        raise RuntimeError(f"FLOPs count of the beam is {fl}")
    peak = (fl / max(tr.device_s, 1e-12) / P.H100_SXM_BF16_DENSE_FLOPS * 100
            if on_card else None)
    top = sorted(tr.per_op.items(), key=lambda kv: -kv[1])[:20]
    return {
        "what": ("NCI beam device time at serving config "
                 f"(batch {B}, {NB} beams, T5-base NCI + PAWA-4, RQ 4x32)"
                 if on_card else f"NCI beam host time, tiny model, batch {B}"),
        "label": os.environ.get("BT_LABEL", "port, eager"),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "beam_device_ms": tr.device_s * 1e3,
        "beam_wall_ms": tr.wall_s * 1e3,
        "beam_gflops": fl / 1e9,
        "beam_mfu_pct": peak,
        "kernels_a_call": sum(tr.calls.values()) / n,
        "trace_breakdown_ms": {k: v / n * 1e3
                               for k, v in categorize(tr.per_op).items()},
        "top_ops_ms": [[op, s / n * 1e3] for op, s in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = trace(args.device)
    out_p = os.environ.get("BT_OUT", osp.join(PACKAGE_ROOT, "build",
                                              "beam_trace.json"))
    os.makedirs(osp.dirname(osp.abspath(out_p)), exist_ok=True)
    with open(out_p, "w") as fw:
        fw.write(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in
                      ("beam_device_ms", "beam_mfu_pct",
                       "trace_breakdown_ms")}), flush=True)
    return out


if __name__ == "__main__":
    main()
