"""CSR bucket scorer: the fine-rerank hot path (port of
``mevi_tpu.ops.bucket``).

Replaces the four TPU kernels of ``mevi_tpu/ops/bucket.py`` with
hand-written CUDA for sm_90a in ``csrc/bucket.cu``:

* ``_kernel_v3`` (``bucket_scores_v3``, bounds given) and
  ``_fused_kernel`` (``bucket_scores_fused``, bounds looked up from the
  CSR offsets): one kernel in two bounds modes;
* ``_kernel_v2`` (``bucket_scores_v2``): v3's contract through a
  2-stage ``cp.async`` pipeline over tiles of each bucket's valid rows;
* ``_kernel`` (``bucket_scores``, v1): raw unmasked window scores from
  given starts, the first kernel's third mode.

Masked contract (v3, fused, v2): for G (query, beam) buckets with CSR
bounds ``[s, e)`` and window start ``al = floor(s / align) * align``,
``scores[g, j] = q[g] . semb[al + j]`` (float32 accumulation) where
``s <= al + j < e`` and ``-1e30`` elsewhere; ``rows[g, j] = al + j`` or
-1.  ``align=8`` is the TPU contract (the JAX server's outputs);
``align=1`` is ``eval.searcher._beam_scores``'s ``[s, s + cap)`` window.
Raw contract (v1): ``scores[g, j] = q[g] . semb[min(start_g + j, N - 1)]``
for every ``j < cap``, as ``bucket_scores_reference``; the caller masks.

Bound on an H100: a gather-GEMV at 2 flops per corpus element read, so
device memory bandwidth.  The masked kernels read only the rows inside
each bucket (``sum_g valid_g * d * itemsize`` bytes), never the full
``G * cap * d`` window, and need no slack rows past the last real row;
the raw kernel reads the whole clipped window.  See the source note in
``csrc/bucket.cu`` for the designs.

A wrapper takes the plain PyTorch version below only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Each wrapper
counts its launches in the counter ``bucket.launches.<mode>`` of
``utils.timers`` (:func:`launch_counts`).  Each checks its bounds or
cluster ids before the launch by fetching a reduction of them, which
waits for the device's queue: the span ``bucket.bounds_check``.  A
caller that has proven them (``serve.BucketServer``: its CSR at build,
its ids on the device) skips that wait with ``host_check=False``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from .. import resolve_device
from ..utils.timers import count, counter, span
from .nvcc import KernelLibrary, build_library

ALIGN = 8
NEG = -1e30
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bucket.cu"
_SEMB_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_CHUNK = 256          # buckets per gathered block in the plain path
CIDX_ERROR = ("cidx must index offsets, and offsets must rise from >= 0 "
              "to <= N")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernel's oracle)
# ---------------------------------------------------------------------------

def bucket_scores_v3_plain(semb, starts, ends, qemb, cap: int,
                           align: int = ALIGN):
    """Gather, float32 einsum, mask: mirrors
    ``bucket_scores_v2_reference``.  Gathers at most ``_PLAIN_CHUNK``
    buckets at a time to bound its memory."""
    starts = starts.long()
    ends = ends.long()
    al = torch.div(starts, align, rounding_mode="floor") * align
    pos = torch.arange(cap, device=semb.device)
    rows = al[:, None] + pos
    ok = (rows >= starts[:, None]) & (rows < ends[:, None])
    scores = torch.empty(rows.shape, dtype=torch.float32, device=semb.device)
    q = qemb.float()
    for g0 in range(0, rows.shape[0], _PLAIN_CHUNK):
        r = rows[g0:g0 + _PLAIN_CHUNK].clamp(0, semb.shape[0] - 1)
        block = semb[r].float()                         # (g, cap, d)
        scores[g0:g0 + _PLAIN_CHUNK] = torch.einsum(
            "gd,gcd->gc", q[g0:g0 + _PLAIN_CHUNK], block)
    scores = torch.where(ok, scores, torch.full_like(scores, NEG))
    rows = torch.where(ok, rows, torch.full_like(rows, -1))
    return scores, rows.to(torch.int32)


def bucket_scores_fused_plain(semb, offsets, cidx, qemb, cap: int,
                              align: int = ALIGN):
    """Fused-mode oracle: bounds ``offsets[cidx]``, ``offsets[cidx+1]``
    (flat (C+1,) offsets), then :func:`bucket_scores_v3_plain`."""
    ci = cidx.long()
    return bucket_scores_v3_plain(semb, offsets[ci], offsets[ci + 1], qemb,
                                  cap, align)


# v2 computes v3's function (the JAX oracle of both is
# ``bucket_scores_v2_reference``)
bucket_scores_v2_plain = bucket_scores_v3_plain


def bucket_scores_plain(semb, starts, qemb, cap: int):
    """Raw (v1) oracle: mirrors ``bucket_scores_reference``, rows
    ``start + j`` clipped to ``[0, N - 1]``, float32 einsum, no mask."""
    rows = starts.long()[:, None] + torch.arange(cap, device=semb.device)
    rows = rows.clamp(0, semb.shape[0] - 1)
    scores = torch.empty(rows.shape, dtype=torch.float32, device=semb.device)
    q = qemb.float()
    for g0 in range(0, rows.shape[0], _PLAIN_CHUNK):
        block = semb[rows[g0:g0 + _PLAIN_CHUNK]].float()   # (g, cap, d)
        scores[g0:g0 + _PLAIN_CHUNK] = torch.einsum(
            "gd,gcd->gc", q[g0:g0 + _PLAIN_CHUNK], block)
    return scores


def align_down(x, align: int = ALIGN):
    """``floor(x / align) * align`` (numpy, torch or int)."""
    return (x // align) * align


# ---------------------------------------------------------------------------
# the kernel: build, load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build_kernel() -> KernelLibrary:
    """Build ``csrc/bucket.cu`` with nvcc into ``build/`` (file named by
    the source's hash) unless it is there, and load it with ctypes."""
    # --split-compile 0: the kernel instances are optimised on every
    # core (92 instances of one source)
    k = build_library(_SRC, "mevi_bucket", ("--split-compile", "0"))
    lib = k.lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mevi_bucket_scores.argtypes = [p, i, i, p, p, p, p, p, i, i, i, i,
                                       p, p, p]
    lib.mevi_bucket_scores.restype = i
    lib.mevi_bucket_scores_raw.argtypes = [p, i, i, ctypes.c_longlong, p, p,
                                           i, i, i, p, p]
    lib.mevi_bucket_scores_raw.restype = i
    lib.mevi_bucket_scores_v2.argtypes = [p, i, i, p, p, p, i, i, i, i, p,
                                          p, p]
    lib.mevi_bucket_scores_v2.restype = i
    lib.mevi_cuda_error_string.argtypes = [i]
    lib.mevi_cuda_error_string.restype = ctypes.c_char_p
    return k


def _check(semb, qemb, cap, align, index_tensors, device):
    dev = resolve_device(device)
    for name, t in [("semb", semb), ("qemb", qemb)] + index_tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index_tensors:
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if semb.dtype not in _SEMB_CODES:
        raise ValueError(f"semb dtype {semb.dtype} not supported")
    if qemb.dtype not in _Q_CODES:
        raise ValueError(f"qemb dtype {qemb.dtype} not supported")
    if semb.ndim != 2 or qemb.ndim != 2 or qemb.shape[1] != semb.shape[1]:
        raise ValueError("semb (N, d) and qemb (G, d) must share d")
    d = semb.shape[1]
    epv = 16 // semb.element_size()
    if d % epv or d * 4 > 48 * 1024:
        raise ValueError(f"d={d} must be a multiple of {epv} and <= 12288")
    if cap <= 0 or align <= 0:
        raise ValueError("cap and align must be positive")
    return dev


def _outputs(semb, qemb, cap, with_rows=True):
    if semb.data_ptr() % 16:
        raise ValueError("semb must be 16-byte aligned")
    G = qemb.shape[0]
    scores = torch.empty((G, cap), dtype=torch.float32, device=semb.device)
    rows = (torch.empty((G, cap), dtype=torch.int32, device=semb.device)
            if with_rows else None)
    return G, scores, rows


def _raise_on(lib, err):
    if err:
        raise RuntimeError("bucket kernel launch failed: "
                           + lib.mevi_cuda_error_string(err).decode())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(semb, qemb, cap, align, starts=None, ends=None, offsets=None,
            cidx=None):
    """v3 (``starts``/``ends``) or fused (``offsets``/``cidx``) mode."""
    G, scores, rows = _outputs(semb, qemb, cap)
    if G == 0:
        return scores, rows
    lib = build_kernel().lib
    ptr = (lambda t: None if t is None else t.data_ptr())
    _raise_on(lib, lib.mevi_bucket_scores(
        semb.data_ptr(), _SEMB_CODES[semb.dtype], semb.shape[1],
        ptr(starts), ptr(ends), ptr(offsets), ptr(cidx), qemb.data_ptr(),
        _Q_CODES[qemb.dtype], G, cap, align, scores.data_ptr(),
        rows.data_ptr(), _stream(semb)))
    return scores, rows


def _launch_v2(semb, starts, ends, qemb, cap, align):
    G, scores, rows = _outputs(semb, qemb, cap)
    if G == 0:
        return scores, rows
    lib = build_kernel().lib
    _raise_on(lib, lib.mevi_bucket_scores_v2(
        semb.data_ptr(), _SEMB_CODES[semb.dtype], semb.shape[1],
        starts.data_ptr(), ends.data_ptr(), qemb.data_ptr(),
        _Q_CODES[qemb.dtype], G, cap, align, scores.data_ptr(),
        rows.data_ptr(), _stream(semb)))
    return scores, rows


def _launch_raw(semb, starts, qemb, cap):
    G, scores, _ = _outputs(semb, qemb, cap, with_rows=False)
    if G == 0:
        return scores
    lib = build_kernel().lib
    _raise_on(lib, lib.mevi_bucket_scores_raw(
        semb.data_ptr(), _SEMB_CODES[semb.dtype], semb.shape[1],
        semb.shape[0], starts.data_ptr(), qemb.data_ptr(),
        _Q_CODES[qemb.dtype], G, cap, scores.data_ptr(), _stream(semb)))
    return scores



def bucket_scores_v3(semb, starts, ends, qemb, cap: int, align: int = ALIGN,
                     device="cuda", host_check: bool = True):
    """Bucket scores from given CSR bounds.

    semb (N, d) bf16/f32/int8; starts, ends (G,) int32; qemb (G, d)
    bf16/f32 -> (scores (G, cap) f32, rows (G, cap) int32).
    ``host_check=False``: the caller guarantees ``0 <= s <= e <= N``, and
    the bounds are not fetched to check it."""
    dev = _check_bounds(semb, starts, ends, qemb, cap, align, device,
                        host_check)
    if dev.type == "cpu":
        return bucket_scores_v3_plain(semb, starts, ends, qemb, cap, align)
    out = _launch(semb, qemb, cap, align, starts=starts, ends=ends)
    count("bucket.launches.v3")
    return out


def _check_bounds(semb, starts, ends, qemb, cap, align, device,
                  host_check=True):
    dev = _check(semb, qemb, cap, align,
                 [("starts", starts), ("ends", ends)], device)
    if starts.shape != ends.shape or starts.shape[0] != qemb.shape[0]:
        raise ValueError("starts, ends and qemb must have G rows")
    if host_check and starts.numel():
        with span("bucket.bounds_check"):
            lo, hi, bad = torch.stack([starts.min().long(),
                                       ends.max().long(),
                                       (ends < starts).sum()]).tolist()
        if lo < 0 or hi > semb.shape[0] or bad:
            raise ValueError("bounds must satisfy 0 <= s <= e <= N")
    return dev


def bucket_scores_v2(semb, starts, ends, qemb, cap: int, align: int = ALIGN,
                     device="cuda"):
    """Bucket scores from given CSR bounds through the pipelined kernel:
    the contract, arguments and outputs of :func:`bucket_scores_v3`."""
    dev = _check_bounds(semb, starts, ends, qemb, cap, align, device)
    if dev.type == "cpu":
        return bucket_scores_v2_plain(semb, starts, ends, qemb, cap, align)
    out = _launch_v2(semb, starts, ends, qemb, cap, align)
    count("bucket.launches.v2")
    return out


def bucket_scores(semb, starts, qemb, cap: int, device="cuda"):
    """Raw (v1) bucket scores: ``scores[g, j] = q[g] . semb[min(starts[g]
    + j, N - 1)]`` for every ``j < cap``, unmasked (the caller masks;
    see ``eval.searcher.mask_pool_topk``).

    semb (N, d) bf16/f32/int8; starts (G,) int32 in ``[0, N)`` (the
    aligned window starts, ``align_down(bucket start)``); qemb (G, d)
    bf16/f32 -> scores (G, cap) f32."""
    dev = _check(semb, qemb, cap, 1, [("starts", starts)], device)
    if starts.shape[0] != qemb.shape[0]:
        raise ValueError("starts and qemb must have G rows")
    if starts.numel():
        with span("bucket.bounds_check"):
            lo, hi = torch.stack([starts.min(), starts.max()]).tolist()
        if lo < 0 or hi >= semb.shape[0]:
            raise ValueError("starts must lie in [0, N)")
    if dev.type == "cpu":
        return bucket_scores_plain(semb, starts, qemb, cap)
    out = _launch_raw(semb, starts, qemb, cap)
    count("bucket.launches.raw")
    return out


def bucket_scores_fused(semb, offsets, cidx, qemb, cap: int,
                        align: int = ALIGN, device="cuda",
                        host_check: bool = True):
    """Bucket scores with the CSR lookup inside the kernel.

    offsets (C+1,) int32 flat CSR offsets; cidx (G,) int32 packed
    cluster ids (the same ids the JAX fused kernel takes); the rest as
    :func:`bucket_scores_v3`.  ``host_check=False``: the caller
    guarantees that the offsets rise from >= 0 to <= N and that every
    id lies in ``[0, C)``, and neither is fetched to check it."""
    dev = _check(semb, qemb, cap, align,
                 [("offsets", offsets), ("cidx", cidx)], device)
    if cidx.shape[0] != qemb.shape[0]:
        raise ValueError("cidx and qemb must have G rows")
    if offsets.shape[0] < 2:
        raise ValueError("offsets must hold C + 1 >= 2 entries")
    if host_check and cidx.numel():
        with span("bucket.bounds_check"):
            lo, hi, first, last, bad = torch.stack([
                cidx.min().long(), cidx.max().long(), offsets[0].long(),
                offsets[-1].long(),
                (offsets[1:] < offsets[:-1]).sum()]).tolist()
        if (lo < 0 or hi >= offsets.shape[0] - 1 or first < 0
                or last > semb.shape[0] or bad):
            raise ValueError(CIDX_ERROR)
    if dev.type == "cpu":
        return bucket_scores_fused_plain(semb, offsets, cidx, qemb, cap,
                                         align)
    out = _launch(semb, qemb, cap, align, offsets=offsets, cidx=cidx)
    count("bucket.launches.fused")
    return out


LAUNCH_MODES = ("v3", "fused", "v2", "raw")


def launch_counts() -> Dict[str, int]:
    """Kernel launches of each wrapper in this process so far, by mode
    (the plain versions on the CPU launch none)."""
    return {m: counter("bucket.launches." + m) for m in LAUNCH_MODES}
