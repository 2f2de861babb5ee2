"""CSR layout for RQ cluster -> document buckets (port of
``mevi_tpu.index.csr``).

* ``offsets``: int32 (C+1,), C = K**M leaf clusters,
* ``doc_ids``: int32 (N,), document ids sorted by cluster index,

so a beam's member docs are one padded gather (:func:`gather_bucket`).

Cluster index = big-endian radix-K packing of the code tuple:
``idx = ((c0*K + c1)*K + c2)*K + ...``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device


class CSRIndex(NamedTuple):
    offsets: torch.Tensor    # (C + 1,) int32
    doc_ids: torch.Tensor    # (N,) int32
    levels: int
    kary: int

    @property
    def num_clusters(self) -> int:
        return self.kary ** self.levels

    @property
    def num_docs(self) -> int:
        return int(self.doc_ids.shape[0])


def pack_codes(codes, kary: int):
    """(…, M) codes -> (…,) int32 radix-K cluster indices (numpy or
    torch, matching the input)."""
    if isinstance(codes, torch.Tensor):
        idx = torch.zeros(codes.shape[:-1], dtype=torch.int32,
                          device=codes.device)
        for i in range(codes.shape[-1]):
            idx = idx * kary + codes[..., i].to(torch.int32)
        return idx
    codes = np.asarray(codes)
    idx = np.zeros(codes.shape[:-1], np.int32)
    for i in range(codes.shape[-1]):
        idx = idx * kary + codes[..., i].astype(np.int32)
    return idx


def unpack_codes(idx, levels: int, kary: int):
    """Inverse of :func:`pack_codes`: (…,) -> (…, M) int32."""
    out = [(idx // kary ** (levels - 1 - i)) % kary for i in range(levels)]
    if isinstance(idx, torch.Tensor):
        return torch.stack(out, -1).to(torch.int32)
    return np.stack(out, -1).astype(np.int32)


def build_csr(codes: np.ndarray, kary: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side CSR build from per-doc codes (N, M) by counting sort.

    Returns (offsets (C+1,) int32, doc_ids (N,) int32 sorted by cluster).
    """
    codes = np.asarray(codes)
    n, levels = codes.shape
    C = kary ** levels
    idx = pack_codes(codes, kary).astype(np.int64)
    counts = np.bincount(idx, minlength=C)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    doc_ids = np.argsort(idx, kind="stable").astype(np.int32)
    if offsets[-1] != n:
        raise ValueError("codes out of range for kary")
    return offsets.astype(np.int32), doc_ids


def make_index(codes: np.ndarray, kary: int, device="cuda") -> CSRIndex:
    """:func:`build_csr` on the host, arrays moved to ``device``."""
    dev = resolve_device(device)
    offsets, doc_ids = build_csr(codes, kary)
    return CSRIndex(torch.from_numpy(offsets).to(dev),
                    torch.from_numpy(doc_ids).to(dev), codes.shape[-1], kary)


def gather_bucket(offsets: torch.Tensor, doc_ids: torch.Tensor,
                  cluster_idx: torch.Tensor, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded member-doc gather for a batch of packed cluster indices
    (…,): returns (docs (…, cap) int32 with -1 padding, true sizes (…,)
    int32).  Members past ``cap`` are dropped."""
    ci = cluster_idx.long()
    start = offsets[ci].long()
    size = offsets[ci + 1].long() - start
    pos = torch.arange(cap, device=offsets.device)
    idx = (start[..., None] + pos).clamp(0, doc_ids.shape[0] - 1)
    docs = torch.where(pos < size[..., None], doc_ids[idx].to(torch.int32),
                       torch.full_like(idx, -1, dtype=torch.int32))
    return docs, size.to(torch.int32)


def cluster_sizes(offsets) -> np.ndarray:
    off = np.asarray(offsets)
    return off[1:] - off[:-1]


def size_histogram(offsets) -> dict:
    """Summary stats of the cluster sizes (nonempty count = the
    reference's 'npqclus', ``main_models.py:4308-4378``)."""
    sizes = cluster_sizes(offsets)
    nonempty = sizes[sizes > 0]
    return {
        "num_clusters": int(sizes.size),
        "nonempty": int(nonempty.size),
        "max": int(sizes.max()) if sizes.size else 0,
        "mean_nonempty": float(nonempty.mean()) if nonempty.size else 0.0,
        "p99_nonempty": float(np.percentile(nonempty, 99))
        if nonempty.size else 0.0,
    }
