"""Coarse -> fine retrieval engine (port of ``mevi_tpu.eval.searcher``).

Document embeddings are permuted into CSR order (cluster-sorted) at
index-build time, so a cluster's members are a contiguous row range; per
(query, beam) the fine stage scores that range against the query and the
beams merge by one top-k (clusters are disjoint, so no dedup).  Returned
doc ids are original corpus ids, mapped on the host.

Multi-device (``sharded_fine_rerank``): the matrix is row-sharded over
the mesh's ``corpus`` axis; each rank scores the intersection of every
bucket with its rows through the v3 kernel, keeps a local top-k, and the
shards' candidates merge by an all-gather over the corpus group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..index.csr import build_csr, pack_codes
from ..ops.bucket import (ALIGN, bucket_scores, bucket_scores_fused,
                          bucket_scores_v3)
from ..ops.mips import merge_shards, mips_topk
from ..ops.topk import NEG_INF, topk_stable
from ..parallel.mesh import CORPUS_AXIS, Mesh


class FineIndex(NamedTuple):
    """Serving-side index: CSR + cluster-sorted embeddings."""
    offsets: torch.Tensor      # (C+1,) int32
    doc_ids: torch.Tensor      # (N,) int32, row -> original doc id
    sorted_emb: torch.Tensor   # (N, d) embeddings in CSR order
    levels: int
    kary: int
    host_offsets: Optional[np.ndarray] = None
    host_doc_ids: Optional[np.ndarray] = None


def host_csr(index: FineIndex) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64, doc_ids) on the host, from the build-time copies
    when the index has them (no device fetch)."""
    if index.host_offsets is not None:
        return (np.asarray(index.host_offsets, np.int64),
                np.asarray(index.host_doc_ids))
    return (index.offsets.cpu().numpy().astype(np.int64),
            index.doc_ids.cpu().numpy())


def build_fine_index(codes: np.ndarray, emb, kary: int,
                     dtype=None, device="cuda") -> FineIndex:
    """Serving layout from per-doc codes (N, M) and embeddings (N, d),
    a host array or a tensor; a tensor is gathered into CSR order on its
    own device (a bf16 corpus on the card never passes through numpy).
    The bucket kernel reads only rows inside buckets, so no slack rows
    are appended."""
    dev = resolve_device(device)
    offsets, doc_ids = build_csr(codes, kary)
    if isinstance(emb, torch.Tensor):
        sorted_emb = emb[torch.from_numpy(doc_ids).to(emb.device).long()]
    else:
        sorted_emb = torch.from_numpy(np.ascontiguousarray(emb[doc_ids]))
    if dtype is not None:
        sorted_emb = sorted_emb.to(dtype)
    return FineIndex(torch.from_numpy(offsets).to(dev),
                     torch.from_numpy(doc_ids).to(dev), sorted_emb.to(dev),
                     codes.shape[-1], kary, host_offsets=offsets,
                     host_doc_ids=doc_ids)


def _beam_scores(query_emb, beam_codes, offsets, doc_ids, sorted_emb,
                 kary: int, cap: int, row_offset: int = 0):
    """Scores + original ids for each (query, beam, slot) over the
    unaligned window ``[s, s + cap)``: a plain gather.

    query_emb (B, d); beam_codes (B, nb, M) -> (scores (B, nb*cap) f32,
    ids (B, nb*cap), sizes (B, nb)).  Rows outside ``[row_offset,
    row_offset + local rows)`` are invalid (the sharded case: offsets and
    doc_ids are global, ``sorted_emb`` is the local shard)."""
    B, nb, _ = beam_codes.shape
    n_local = sorted_emb.shape[0]
    cidx = pack_codes(beam_codes, kary).long()
    start = offsets.long()[cidx]
    sizes = offsets.long()[cidx + 1] - start
    pos = torch.arange(cap, device=sorted_emb.device)
    rows = start[..., None] + pos                        # (B, nb, cap)
    local = rows - row_offset
    ok = (pos < sizes[..., None]) & (local >= 0) & (local < n_local)
    local = local.clamp(0, n_local - 1)
    emb = sorted_emb[local].float()                      # (B, nb, cap, d)
    scores = torch.einsum("bd,bncd->bnc", query_emb.float(), emb)
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    global_rows = rows.clamp(0, doc_ids.shape[0] - 1)
    ids = torch.where(ok, doc_ids.long()[global_rows],
                      torch.full_like(rows, -1))
    return scores.reshape(B, nb * cap), ids.reshape(B, nb * cap), sizes


def merge_pool(scores, ids, nb: int, cap: int, pool: int,
               rank: str = "score") -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-(beam, slot) candidates into a top-``pool`` list.

    ``rank="score"``: global top-k by score.  ``rank="beam_major"``:
    lexicographic (beam rank, then score): per-beam descending sort,
    then one stable sort on the beam index (invalid slots keyed past
    every beam).  Ties keep the lower position first, as in JAX."""
    B = scores.shape[0]
    k = min(pool, scores.shape[-1])
    if rank == "beam_major":
        s_s, p = topk_stable(scores.reshape(B, nb, cap), cap)
        i_s = torch.gather(ids.reshape(B, nb, cap), -1, p)
        beam_idx = torch.arange(nb, device=scores.device)[None, :, None]
        key = torch.where(s_s > NEG_INF / 2, beam_idx,
                          torch.full_like(beam_idx, nb)).reshape(B, -1)
        order = torch.sort(key, dim=-1, stable=True).indices[:, :k]
        top_scores = torch.gather(s_s.reshape(B, -1), -1, order)
        top_ids = torch.gather(i_s.reshape(B, -1), -1, order)
    else:
        top_scores, posn = topk_stable(scores, k)
        top_ids = torch.gather(ids, -1, posn)
    top_ids = torch.where(top_scores <= NEG_INF / 2,
                          torch.full_like(top_ids, -1), top_ids)
    return top_scores, top_ids


# bytes of float32 rows fine_rerank gathers at a time
_RERANK_BLOCK_BYTES = 1 << 28


@torch.inference_mode()
def fine_rerank(query_emb, beam_codes, offsets, doc_ids, sorted_emb,
                kary: int, cap: int, pool: int, rank: str = "score"):
    """In-cluster MIPS re-rank of the coarse beam's clusters (plain
    gather path).  Returns (top scores (B, pool), top doc ids (B, pool),
    ndoc (B,) total member count of the query's clusters).

    Each query's (nb, cap, d) window is gathered and upcast to float32
    (an int8 or bf16 corpus included), a few queries at a time so that a
    gathered block stays under 256 MiB (at 10 beams, cap 512, d 768:
    16 queries); every query's pool is its own, so the blocks change no
    output."""
    B, nb = beam_codes.shape[:2]
    step = max(1, _RERANK_BLOCK_BYTES
               // (nb * cap * sorted_emb.shape[1] * 4))
    parts = []
    for s in range(0, max(B, 1), step):
        scores, ids, sizes = _beam_scores(
            query_emb[s:s + step], beam_codes[s:s + step], offsets, doc_ids,
            sorted_emb, kary, cap)
        parts.append((*merge_pool(scores, ids, nb, cap, pool, rank),
                      sizes.sum(-1)))
    return tuple(torch.cat(t) for t in zip(*parts))


def shard_bounds(offsets, cidx, cap: int, lo: int, n_local: int):
    """v3 kernel bounds (``align=1``) of each bucket's window ``[S,
    min(E, S + cap))`` intersected with a shard's rows ``[lo, lo +
    n_local)``, in the shard's local rows: ``_beam_scores``'s sharded
    window.  offsets (C+1,) global CSR offsets; cidx (G,) cluster ids ->
    (starts, ends) (G,) int32."""
    ci = cidx.long()
    s = offsets.long()[ci]
    e = torch.minimum(offsets.long()[ci + 1], s + cap)
    return ((s - lo).clamp(0, n_local).to(torch.int32).contiguous(),
            (e - lo).clamp(0, n_local).to(torch.int32).contiguous())


@torch.inference_mode()
def shard_pool(query_emb, beam_codes, offsets, doc_ids, emb_shard,
               mesh: Mesh, kary: int, cap: int, pool: int, device="cuda"):
    """One rank's fine stage over its corpus shard, merged over the
    corpus group: the v3 kernel (``align=1``) over the shard's bucket
    bounds, a local top-k, an all-gather of every shard's candidates
    (shard-major, as ``lax.all_gather``) and a stable top-k.  The
    kernel's slot of a valid row is ``_beam_scores``'s shifted by a
    constant within each bucket, so the order of valid candidates, and
    the tie order, are the JAX function's.  Returns (scores (B, k) f32,
    doc ids (B, k) int64, -1 past ``NEG_INF / 2``), k = min(pool,
    nb * cap), equal on every rank of the corpus group."""
    B, nb, M = beam_codes.shape
    n_local = emb_shard.shape[0]
    lo = mesh.index(CORPUS_AXIS) * n_local
    cidx = pack_codes(beam_codes.reshape(-1, M), kary)
    s, e = shard_bounds(offsets, cidx, cap, lo, n_local)
    q_rep = query_emb.repeat_interleave(nb, 0).contiguous()
    scores, rows = bucket_scores_v3(emb_shard, s, e, q_rep, cap, align=1,
                                    device=device)
    rows = rows.long()
    ids = torch.where(rows >= 0, doc_ids.long()[(rows + lo).clamp(
        0, doc_ids.shape[0] - 1)], torch.full_like(rows, -1))
    k = min(pool, nb * cap)
    loc_s, posn = topk_stable(scores.reshape(B, -1), k)
    return merge_shards(loc_s, torch.gather(ids.reshape(B, -1), -1, posn),
                        mesh, k)


def sharded_fine_rerank(query_emb, beam_codes, index_shard: FineIndex,
                        mesh: Mesh, cap: int, pool: int, device="cuda"):
    """Multi-device fine re-rank (``searcher.sharded_fine_rerank``).

    ``index_shard``: global offsets and doc ids with this rank's shard of
    the cluster-sorted matrix as ``sorted_emb`` (shard ``i`` owns rows
    ``[i * rows_per, (i + 1) * rows_per)``, see ``shard_rows``);
    ``query_emb`` (B, d) and ``beam_codes`` (B, nb, M): this rank's data
    slice.  Returns (top scores (B, k), top doc ids (B, k), ndoc (B,)),
    k = min(pool, nb * cap)."""
    scores, ids = shard_pool(query_emb, beam_codes, index_shard.offsets,
                             index_shard.doc_ids, index_shard.sorted_emb,
                             mesh, index_shard.kary, cap, pool, device)
    cidx = pack_codes(beam_codes, index_shard.kary).long()
    off = index_shard.offsets.long()
    return scores, ids, (off[cidx + 1] - off[cidx]).sum(-1)


class FineReranker:
    """Reusable fine re-rank through the bucket kernel; maps CSR rows
    back to original doc ids on the host.

    ``overflow='scan'`` (default): a query whose clusters exceed ``cap``
    members falls back to an exact full-corpus scan (``mips_topk``);
    ``'truncate'`` keeps the capped result.  ``align``: the bucket
    window's start alignment, 8 (the JAX package's on-device contract,
    the default) or 1 (its ``_beam_scores`` window).  ``bucket_kernel``:
    ``"v3"`` (bounds gathered before the kernel) or ``"fused"`` (looked
    up inside it)."""

    def __init__(self, index: FineIndex, cap: int, pool: int,
                 overflow: str = "scan", rank: str = "score",
                 bucket_kernel: str = "v3", align: int = ALIGN,
                 device="cuda"):
        if overflow not in ("scan", "truncate"):
            raise ValueError(overflow)
        if rank not in ("score", "beam_major"):
            raise ValueError(rank)
        if bucket_kernel not in ("v3", "fused"):
            raise ValueError(bucket_kernel)
        self.device = resolve_device(device)
        self.index = index
        self.cap, self.pool, self.align = cap, pool, align
        self.overflow, self.rank = overflow, rank
        self.bucket_kernel = bucket_kernel
        self.kary = index.kary
        semb = index.sorted_emb
        if semb.device.type != self.device.type:
            raise ValueError(f"index is on {semb.device}, not {self.device}")
        # int8 corpus: queries stay float (casting them to int8 would
        # zero them); the kernel upcasts the corpus rows
        if semb.dtype == torch.int8:
            self.q_dt = (torch.float32 if self.device.type == "cpu"
                         else torch.bfloat16)
        else:
            self.q_dt = semb.dtype
        self.offsets_h, self.doc_ids_h = host_csr(index)
        if self.offsets_h[-1] > semb.shape[0]:
            raise ValueError("offsets run past the corpus rows")
        self.offsets_d = torch.from_numpy(
            self.offsets_h.astype(np.int32)).to(self.device)

    def _scan_overflow(self, query_emb, scores, ids, over_mask):
        """Replace overflowing queries' results with an exact scan."""
        q = torch.as_tensor(query_emb).to(self.device, self.q_dt)
        k = scores.shape[-1]
        s_all, rows = mips_topk(q, self.index.sorted_emb, k=k)
        rows_h = rows.cpu().numpy()
        n_real = len(self.doc_ids_h)
        ids_all = np.where((rows_h >= 0) & (rows_h < n_real),
                           self.doc_ids_h[np.clip(rows_h, 0, n_real - 1)], -1)
        scores = np.where(over_mask[:, None], s_all.cpu().numpy()[:, :k],
                          scores)
        ids = np.where(over_mask[:, None], ids_all[:, :k], ids)
        return scores, ids

    @torch.inference_mode()
    def __call__(self, query_emb, beam_codes):
        """query_emb (B, d); beam_codes (B, nb, M) -> (scores (B, pool),
        original doc ids (B, pool), ndoc (B,)) as numpy arrays."""
        codes_h = np.asarray(torch.as_tensor(beam_codes).cpu())
        B, nb, M = codes_h.shape
        ci_h = pack_codes(codes_h.reshape(-1, M), self.kary).astype(np.int64)
        sizes_h = (self.offsets_h[ci_h + 1]
                   - self.offsets_h[ci_h]).reshape(B, nb)
        over = ((sizes_h > self.cap).any(axis=1)
                if self.overflow == "scan" else np.zeros(B, bool))
        q = torch.as_tensor(query_emb).to(self.device, self.q_dt)
        q_rep = q.repeat_interleave(nb, 0).contiguous()
        semb = self.index.sorted_emb
        if self.bucket_kernel == "fused":
            cidx = torch.from_numpy(ci_h.astype(np.int32)).to(self.device)
            scores, rows = bucket_scores_fused(
                semb, self.offsets_d, cidx, q_rep, self.cap, self.align,
                device=self.device)
        else:
            # the cluster ids are on the host already: bounds for free
            s = torch.from_numpy(self.offsets_h[ci_h].astype(np.int32))
            e = torch.from_numpy(self.offsets_h[ci_h + 1].astype(np.int32))
            scores, rows = bucket_scores_v3(
                semb, s.to(self.device), e.to(self.device), q_rep, self.cap,
                self.align, device=self.device)
        top_scores, top_rows = merge_pool(
            scores.reshape(B, -1), rows.reshape(B, -1), nb, self.cap,
            self.pool, self.rank)
        top_rows_h = top_rows.cpu().numpy()
        top_ids = np.where(top_rows_h >= 0,
                           self.doc_ids_h[np.clip(top_rows_h, 0, None)],
                           -1).astype(np.int32)
        top_scores = top_scores.cpu().numpy()
        if over.any():
            top_scores, top_ids = self._scan_overflow(
                query_emb, top_scores, top_ids, over)
        return top_scores, top_ids, sizes_h.sum(-1)


# ---------------------------------------------------------------------------
# the raw-score path: v1 kernel -> mask -> per-query pool
# ---------------------------------------------------------------------------

def bucket_scores_dispatch(sorted_emb, starts_aligned, query_emb, cap: int,
                           device="cuda"):
    """Raw (G, cap) bucket scores from aligned window starts: the v1
    CUDA kernel for tensors on the card, its plain version on the CPU
    (``ops.bucket.bucket_scores`` chooses by ``device``)."""
    return bucket_scores(sorted_emb, starts_aligned, query_emb, cap,
                         device=device)


@torch.inference_mode()
def mask_pool_topk(scores, starts_aligned, bucket_start, bucket_end,
                   cap: int, pool: int, nq: int, per_query: int):
    """Mask raw scores to the true bucket bounds and pool each query's
    top-k.

    Slot j of bucket g holds CSR row ``starts_aligned[g] + j``; valid iff
    that row lies in [bucket_start, bucket_end).  The first
    ``nq * per_query`` buckets are real (the rest is padding).  Returns
    (top scores (nq, pool), top CSR rows (nq, pool), -1 invalid); stable
    selection, so ties keep the lower slot first as ``lax.top_k`` does.
    """
    pos = torch.arange(cap, device=scores.device)
    rows = starts_aligned.long()[:, None] + pos
    ok = ((rows >= bucket_start.long()[:, None])
          & (rows < bucket_end.long()[:, None]))
    g_real = nq * per_query
    sc = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    sc = sc[:g_real].reshape(nq, -1)
    rw = torch.where(ok, rows, torch.full_like(rows, -1))[:g_real]
    rw = rw.reshape(nq, -1)
    top_scores, posn = topk_stable(sc, min(pool, sc.shape[-1]))
    top_rows = torch.gather(rw, -1, posn)
    top_rows = torch.where(top_scores <= NEG_INF / 2,
                           torch.full_like(top_rows, -1), top_rows)
    return top_scores, top_rows.to(torch.int32)


# ---------------------------------------------------------------------------
# coarse metrics helper
# ---------------------------------------------------------------------------

def coarse_ranks(beam_codes: np.ndarray, gt_codes: np.ndarray,
                 kary: int) -> np.ndarray:
    """Rank of each gt doc's cluster in the beam list, -1 if absent.

    beam_codes (B, nb, M); gt_codes (B, max_gt, M) with -1 padding
    (``main_models.py:3772-3774``)."""
    beam_idx = pack_codes(np.asarray(beam_codes), kary)       # (B, nb)
    gt_valid = np.asarray(gt_codes)[..., 0] >= 0
    gt_idx = pack_codes(np.maximum(np.asarray(gt_codes), 0), kary)
    eq = gt_idx[:, :, None] == beam_idx[:, None, :]
    eq &= gt_valid[:, :, None]
    return np.where(eq.any(-1), eq.argmax(-1), -1)
