"""A/B of the bucket-scoring kernels (port of ``scripts/profile_bucket.py``).

Builds a serving-geometry synthetic CSR corpus on the card (8,841,823 x
768 int8 by default, ~27,651 non-empty clusters as in the serving index),
draws G = 5,120 buckets doc-weighted, times each kernel mode with CUDA
events (median of ``--reps`` launches, each between two events) and
cross-checks their outputs: the masked modes (fused, v2, v3) give equal
rows and scores within rtol 1e-4 / atol 1e-3 of the first one; raw
scores equal v3's on v3's valid slots (same starts, aligned).  Beside
each mode's ms it reports the bytes the mode must move and its bound
(:func:`bytes_of`, :func:`bound_ms`; ``chip_smoke.py`` phase 1 uses the
same arithmetic).

    python -m mevi_tpu_torch.scripts.profile_bucket [--ndoc N] [--d D]
        [--g G] [--cap CAP] [--reps R] [--kernels fused,v2,v3,raw]
        [--seed S] [--device cuda]

Prints one JSON line: geometry, device name, ms per kernel, and each
kernel's bytes and bound.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import bucket as B
from ..utils.profiling import (H100_SXM_BF16_DENSE_FLOPS as BF16_FLOPS,
                               H100_SXM_HBM_BYTES_PER_S as HBM_BYTES_PER_S)

KERNELS = ("fused", "v2", "v3", "raw")


def bound_ms(nbytes, flops):
    """The larger of bytes over the HBM rate and flops over the bf16
    tensor peak, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def _unique(lo, hi):
    """Rows covered by the union of the [lo, hi) ranges."""
    keep = hi > lo
    if not keep.any():
        return 0
    mark = np.zeros(int(hi.max()) + 2, np.int64)
    np.add.at(mark, lo[keep], 1)
    np.add.at(mark, hi[keep], -1)
    return int((np.cumsum(mark) > 0).sum())


def bytes_of(starts, ends, cap, d, item, G, n_rows, q_item=2):
    """Bytes each mode must move over aligned (``ALIGN``) windows: corpus
    rows read + G*d query bytes + outputs (masked modes G*cap*8: scores
    and rows; raw G*cap*4).  Masked: full window, valid rows, unique
    valid rows; raw: full window, unique window rows (clipped at N - 1).
    ``starts``/``ends`` are numpy arrays; ``valid_slots`` counts the
    valid rows (the masked modes' flops are 2 * d a valid slot)."""
    s = starts.astype(np.int64)
    e = ends.astype(np.int64)
    al = (s // B.ALIGN) * B.ALIGN
    lo, hi = s, np.minimum(e, al + cap)
    valid = np.maximum(hi - lo, 0)
    q_bytes = G * d * q_item
    full = G * cap * d * item
    masked_out = q_bytes + G * cap * 8
    raw_out = q_bytes + G * cap * 4
    return {"full_window": full + masked_out,
            "valid_rows": int(valid.sum()) * d * item + masked_out,
            "unique_rows": _unique(lo, hi) * d * item + masked_out,
            "raw_full_window": full + raw_out,
            "raw_unique_rows": _unique(al, np.minimum(al + cap, n_rows))
            * d * item + raw_out,
            "valid_slots": int(valid.sum())}


def _timed_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of ``reps`` calls: CUDA events on the card, the host
    clock on the CPU."""
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profile(semb, offsets, cidx, q, cap: int, kernels=KERNELS,
            reps: int = 10, device="cuda") -> dict:
    """Time the bucket kernels over ``offsets[cidx]`` buckets and check
    that they agree.

    semb (N, d); offsets (C+1,) int32 flat CSR offsets; cidx (G,) int32;
    q (G, d).  On the card each mode is timed at its launch alone (the
    wrappers' bounds check, a host sync, stays out); on the CPU the
    wrappers' plain versions are timed.  Returns {"device", "ms": {mode:
    ms}, "bytes": {mode: bytes}, "bound_ms": {mode: ms}, "agree": [modes
    checked]}: masked modes with valid-row and unique-row bytes and
    bounds, raw with unique-window ones; raises AssertionError if two
    modes disagree."""
    dev = resolve_device(device)
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    ci = cidx.long()
    st, en = offsets[ci].contiguous(), offsets[ci + 1].contiguous()
    al = B.align_down(st)
    checked = {
        "fused": lambda: B.bucket_scores_fused(semb, offsets, cidx, q, cap,
                                               device=dev),
        "v2": lambda: B.bucket_scores_v2(semb, st, en, q, cap, device=dev),
        "v3": lambda: B.bucket_scores_v3(semb, st, en, q, cap, device=dev),
        "raw": lambda: B.bucket_scores(semb, al, q, cap, device=dev)}
    bare = checked
    if dev.type == "cuda":
        bare = {
            "fused": lambda: B._launch(semb, q, cap, B.ALIGN,
                                       offsets=offsets, cidx=cidx),
            "v2": lambda: B._launch_v2(semb, st, en, q, cap, B.ALIGN),
            "v3": lambda: B._launch(semb, q, cap, B.ALIGN, starts=st,
                                    ends=en),
            "raw": lambda: B._launch_raw(semb, al, q, cap)}
    outs, ms = {}, {}
    for name in kernels:
        outs[name] = checked[name]()
        ms[name] = _timed_ms(bare[name], reps, dev)
    masked = [k for k in kernels if k != "raw"]
    for name in masked[1:]:
        ref_s, ref_r = outs[masked[0]]
        s, r = outs[name]
        if not torch.equal(r, ref_r):
            raise AssertionError(f"{name} rows != {masked[0]} rows")
        torch.testing.assert_close(s, ref_s, rtol=1e-4, atol=1e-3)
    if "raw" in outs and "v3" in outs:
        ok = outs["v3"][1] >= 0
        torch.testing.assert_close(outs["raw"][ok], outs["v3"][0][ok],
                                   rtol=1e-4, atol=1e-3)
    G, d = q.shape
    nb = bytes_of(st.cpu().numpy(), en.cpu().numpy(), cap, d,
                  semb.element_size(), G, semb.shape[0], q.element_size())
    flops_valid, flops_full = 2.0 * nb["valid_slots"] * d, 2.0 * G * cap * d
    nbytes, bounds = {}, {}
    for name in kernels:
        if name == "raw":
            nbytes[name] = {"unique_window": nb["raw_unique_rows"]}
            bounds[name] = {"unique_window": bound_ms(nb["raw_unique_rows"],
                                                      flops_full)}
        else:
            nbytes[name] = {k: nb[k] for k in ("valid_rows", "unique_rows")}
            bounds[name] = {k: bound_ms(nb[k], flops_valid)
                            for k in ("valid_rows", "unique_rows")}
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"device": name, "ms": ms, "bytes": nbytes, "bound_ms": bounds,
            "agree": masked + (["raw"] if "raw" in outs and "v3" in outs
                               else [])}


def synthetic_csr(n: int, g: int, seed: int, nonempty: int = 27_651):
    """Random cuts of n rows into ``nonempty`` clusters and g
    doc-weighted cluster ids: (offsets (C+1,) int32, cidx (g,) int32)."""
    rng = np.random.default_rng(seed)
    ncl = min(nonempty, n)
    cuts = np.sort(rng.choice(n - 1, size=ncl - 1, replace=False)) + 1
    offsets = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    sizes = np.diff(offsets)
    cidx = rng.choice(ncl, size=g, p=sizes / sizes.sum())
    return offsets.astype(np.int32), cidx.astype(np.int32)


def int8_corpus(n: int, d: int, dev: torch.device, seed: int,
                chunk: int = 1 << 20) -> torch.Tensor:
    """(n, d) uniform int8 rows in [-127, 127], made on ``dev`` chunk by
    chunk (no host copy of the corpus)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    out = torch.empty((n, d), dtype=torch.int8, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        out[s:s + m] = torch.randint(-127, 128, (m, d), generator=g,
                                     device=dev, dtype=torch.int8)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ndoc", type=int, default=8_841_823)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--g", type=int, default=5120)
    ap.add_argument("--cap", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    semb = int8_corpus(args.ndoc, args.d, dev, args.seed)
    offsets, cidx = synthetic_csr(args.ndoc, args.g, args.seed)
    q = torch.randn((args.g, args.d), generator=torch.Generator(
        device=dev).manual_seed(args.seed + 1), device=dev).to(
            torch.bfloat16)
    res = profile(semb, torch.from_numpy(offsets).to(dev),
                  torch.from_numpy(cidx).to(dev), q, args.cap,
                  kernels=args.kernels.split(","), reps=args.reps,
                  device=dev)
    print(json.dumps({"geometry": {"ndoc": args.ndoc, "d": args.d,
                                   "g": args.g, "cap": args.cap},
                      "reps": args.reps, **res}))


if __name__ == "__main__":
    main()
