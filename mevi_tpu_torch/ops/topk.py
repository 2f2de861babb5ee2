"""Running / merged top-k (port of ``mevi_tpu.ops.topk``).

Selection is a stable descending sort: on ties the lower position wins,
as with ``lax.top_k``."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

NEG_INF = -1e30


def topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two (…, m) score/id sets into top-k (…, k)."""
    scores = torch.cat([scores_a, scores_b], -1)
    ids = torch.cat([ids_a, ids_b], -1)
    top, pos = topk_stable(scores, k)
    return top, torch.gather(ids, -1, pos)


def streaming_topk(score_chunk_fn: Callable[[int], Tuple[torch.Tensor,
                                                         torch.Tensor]],
                   num_chunks: int, k: int, batch_shape: Tuple[int, ...],
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over items scored lazily in ``num_chunks`` chunks;
    ``score_chunk_fn(c)`` -> (scores (*batch_shape, chunk), ids (chunk,)),
    ids < 0 masked."""
    run_s = torch.full(batch_shape + (k,), NEG_INF, dtype=torch.float32,
                       device=device)
    run_i = torch.full(batch_shape + (k,), -1, dtype=torch.int64,
                       device=device)
    for c in range(num_chunks):
        scores, ids = score_chunk_fn(c)
        ids = ids.to(torch.int64)
        scores = torch.where(ids >= 0, scores.float(),
                             torch.full_like(scores, NEG_INF,
                                             dtype=torch.float32))
        bids = ids.expand(batch_shape + (ids.shape[-1],))
        run_s, run_i = merge_topk(run_s, run_i, scores, bids, k)
    return run_s, run_i


def chunk_ids_clamped(c: int, chunk: int, num_items: int, device=None
                      ) -> Tuple[int, torch.Tensor]:
    """Start and ids of chunk ``c`` of ``num_items`` rows, the start
    clamped so a ``chunk``-row slice stays in bounds.  Returns
    (clamped_start, ids (chunk,) int64): rows that an earlier chunk
    already covered, and rows past ``num_items`` (only when
    ``num_items < chunk``), carry id -1 so they are masked."""
    requested = c * chunk
    start = min(requested, max(num_items - chunk, 0))
    ids = start + torch.arange(chunk, device=device)
    valid = (ids >= requested) & (ids < num_items)
    return start, torch.where(valid, ids, torch.full_like(ids, -1))
