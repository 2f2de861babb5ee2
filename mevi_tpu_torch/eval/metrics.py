"""Retrieval metrics with the reference's exact (idiosyncratic) semantics
(the port's copy of ``mevi_tpu.eval.metrics``; numpy only).

Given one query with ground-truth docs ``g_1..g_n`` and a ranked prediction
list, let ``v_i`` be the 0-based rank of ``g_i`` in the predictions (None if
absent), ``V = {v_i != None}`` and ``m = min(V)``:

* ``recall@k  = |{v in V : v < k}| / n``    (note: denominator is **all** gts)
* ``mrr@k     = 1 / (m + 1) if m < k else 0``
* ``hitrate@k = [m < k]``

All three are averaged over queries.  A query with no hit contributes 0.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def per_query_metrics(
    ranks: Sequence[Optional[int]],
    recall_ks: Sequence[int],
) -> Dict[str, Dict[int, float]]:
    """Metrics for one query from gt ranks (None = gt not retrieved)."""
    v_valid = [v for v in ranks if v is not None]
    min_valid = min(v_valid) if v_valid else None
    out = {"recall": {}, "mrr": {}, "hitrate": {}}
    for k in recall_ks:
        if v_valid:
            out["recall"][k] = sum(v < k for v in v_valid) / len(ranks)
            out["mrr"][k] = 1.0 / (min_valid + 1) if min_valid < k else 0.0
            out["hitrate"][k] = float(min_valid < k)
        else:
            out["recall"][k] = out["mrr"][k] = out["hitrate"][k] = 0.0
    return out


def evaluate_ranks(
    gts: Mapping[str, Sequence],
    preds: Mapping[str, Sequence],
    recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100, 1000),
) -> Dict[str, Dict[int, float]]:
    """Corpus-level metrics from per-query gt lists and ranked predictions.

    Matches ``evaluate.py:27-47`` (ranks mode).
    """
    agg = {"recall": {k: 0.0 for k in recall_ks},
           "mrr": {k: 0.0 for k in recall_ks},
           "hitrate": {k: 0.0 for k in recall_ks}}
    for q, gt in gts.items():
        plist = list(preds.get(q, ()))
        pos = {p: i for i, p in enumerate(plist)}
        ranks = [pos.get(g) for g in gt]
        m = per_query_metrics(ranks, recall_ks)
        for name in agg:
            for k in recall_ks:
                agg[name][k] += m[name][k]
    n = max(len(gts), 1)
    for name in agg:
        for k in recall_ks:
            agg[name][k] /= n
    return agg


def evaluate_scores(
    gts: Mapping[str, Sequence],
    scores: Mapping[str, Mapping],
    recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 1000),
) -> Dict[str, Dict[int, float]]:
    """Scores mode of ``evaluate.py:33-38``: rank docs by descending score."""
    preds = {}
    for q, sc in scores.items():
        items = sorted(sc.items(), key=lambda x: -x[1])
        preds[q] = [p for p, _ in items]
    return evaluate_ranks(gts, preds, recall_ks)


def metrics_from_rank_matrix(
    gt_ranks: np.ndarray,
    gt_counts: np.ndarray,
    recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100, 1000),
) -> Dict[str, Dict[int, float]]:
    """Vectorized metrics from a dense rank matrix.

    Args:
      gt_ranks: int array (nq, max_gt); 0-based rank of each gt in the
        prediction list, or -1 if not retrieved / padding slot.
      gt_counts: int array (nq,); number of real gts per query (the
        recall denominator, ``len(v)`` in evaluate.py:13).
    """
    gt_ranks = np.asarray(gt_ranks)
    gt_counts = np.asarray(gt_counts)
    nq = gt_ranks.shape[0]
    valid = gt_ranks >= 0
    big = np.iinfo(np.int64).max
    min_rank = np.where(valid, gt_ranks, big).min(axis=1)       # (nq,)
    any_valid = valid.any(axis=1)
    out = {"recall": {}, "mrr": {}, "hitrate": {}}
    denom = np.maximum(gt_counts, 1)
    for k in recall_ks:
        hits_k = (valid & (gt_ranks < k)).sum(axis=1)
        recall = np.where(any_valid, hits_k / denom, 0.0)
        mrr = np.where(any_valid & (min_rank < k), 1.0 / (min_rank + 1), 0.0)
        hit = (any_valid & (min_rank < k)).astype(np.float64)
        out["recall"][k] = float(recall.mean()) if nq else 0.0
        out["mrr"][k] = float(mrr.mean()) if nq else 0.0
        out["hitrate"][k] = float(hit.mean()) if nq else 0.0
    return out


def ranks_of_gts(pred_ids: np.ndarray, gt_ids: np.ndarray) -> np.ndarray:
    """0-based rank of each gt id in each prediction row; -1 if absent.

    Args:
      pred_ids: (nq, pool) int ids, -1 for padding.
      gt_ids:   (nq, max_gt) int ids, -1 for padding.
    Returns:
      (nq, max_gt) int ranks, -1 where gt is padding or not retrieved.
    """
    pred_ids = np.asarray(pred_ids)
    gt_ids = np.asarray(gt_ids)
    # (nq, max_gt, pool) equality — fine at eval sizes; chunk if ever needed.
    eq = gt_ids[:, :, None] == pred_ids[:, None, :]
    eq &= gt_ids[:, :, None] >= 0
    found = eq.any(axis=-1)
    first = eq.argmax(axis=-1)
    return np.where(found, first, -1)
