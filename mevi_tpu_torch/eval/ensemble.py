"""Ensemble score fusion of the ANN and seq2seq candidate lists (the
port's copy of ``mevi_tpu.eval.ensemble``; numpy only).

Reproduces ``MEVI/ensemble_marco.py:152-240`` exactly:

* per query, each coarse beam cluster gets its rank in the beam list;
* every candidate doc (ANN list then fine list — later entries overwrite
  earlier in the score dict, as in the reference) is scored

      fused = score + alpha / (beta * crank + 1)

  where ``crank`` is the rank of the doc's RQ cluster in the coarse list
  (``num_clusters`` if absent), and docs outside all predicted clusters
  are multiplied by ``(1 - gamma * alpha)`` (``ensemble_marco.py:235-238``);
* defaults alpha=0.6, beta=0.03, gamma=0.02 (``ensemble_marco.py:251-253``).

The NQ variant scores hit@k against answer sets via the inverted
doc -> query-index arrays (``ensemble_nqdpr.py:9-47``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .metrics import evaluate_scores


def cluster_rankings(
    preds: Mapping[str, Sequence[int]],
    coarse_clusters: Mapping[str, Sequence[Sequence[int]]],
    mapping: Mapping[int, Tuple[int, ...]],
) -> Tuple[Dict[str, List[int]], int]:
    """Per-query cluster rank of each predicted doc
    (``ensemble_marco.py:181-209``).  Returns (rankings, num_clusters)."""
    num_clusters = None
    out = {}
    for q, plist in preds.items():
        cr = {tuple(c): i for i, c in enumerate(coarse_clusters[q])}
        if num_clusters is None:
            num_clusters = len(cr)
        elif num_clusters != len(cr):
            raise ValueError(f"query {q!r} has {len(cr)} coarse clusters, "
                             f"others {num_clusters}")
        out[q] = [cr.get(tuple(mapping[p]) if p != -1 else -1, len(cr))
                  for p in plist]
    return out, (num_clusters or 0)


def fuse_scores(
    ance_preds: Mapping[str, Sequence[int]],
    ance_scores: Mapping[str, Sequence[float]],
    cranks_ance: Mapping[str, Sequence[int]],
    num_clusters: int,
    alpha: float = 0.6,
    beta: float = 0.03,
    gamma: float = 0.02,
    fine_preds: Optional[Mapping[str, Sequence[int]]] = None,
    fine_scores: Optional[Mapping[str, Sequence[float]]] = None,
    cranks_fine: Optional[Mapping[str, Sequence[int]]] = None,
) -> Dict[str, Dict[int, float]]:
    """Fused per-doc scores (``ensemble_marco.py:221-238``)."""
    out: Dict[str, Dict[int, float]] = {}
    for q, apreds in ance_preds.items():
        preds = list(apreds)
        scores = list(ance_scores[q])
        cranks = list(cranks_ance[q])
        if fine_preds is not None:
            preds += list(fine_preds[q])
            scores += list(fine_scores[q])
            cranks += list(cranks_fine[q])
        sq: Dict[int, float] = {}
        for p, s, crank in zip(preds, scores, cranks):
            fused = s + alpha / (beta * crank + 1)
            if crank == num_clusters:
                fused *= (1 - gamma * alpha)
            sq[p] = fused
        out[q] = sq
    return out


def run_ensemble(
    gts: Mapping[str, Sequence[int]],
    ance_preds, ance_scores,
    coarse_clusters,
    mapping,
    fine_preds=None, fine_scores=None,
    alphas: Sequence[float] = (0.6,),
    betas: Sequence[float] = (0.03,),
    gammas: Sequence[float] = (0.02,),
    recall_ks: Sequence[int] = (10, 50, 1000),
):
    """Grid over (alpha, beta, gamma); returns {(a,b,g): metrics}."""
    cranks_ance, num_clusters = cluster_rankings(
        ance_preds, coarse_clusters, mapping)
    cranks_fine = None
    if fine_preds is not None:
        cranks_fine, n2 = cluster_rankings(
            fine_preds, coarse_clusters, mapping)
        if n2 != num_clusters:
            raise ValueError("fine and ANN lists see different cluster "
                             "counts")
    results = {}
    for a in alphas:
        for b in betas:
            for g in gammas:
                scores = fuse_scores(
                    ance_preds, ance_scores, cranks_ance, num_clusters,
                    a, b, g, fine_preds, fine_scores, cranks_fine)
                results[(a, b, g)] = evaluate_scores(gts, scores,
                                                     recall_ks)
    return results


# --------------------------------------------------------------------------
# NQ answer-set evaluation (ensemble_nqdpr.py:9-47)
# --------------------------------------------------------------------------

def rrf_fuse(leg_preds: Sequence[Mapping[str, Sequence[int]]],
             k: int = 60) -> Dict[str, Dict[int, float]]:
    """Reciprocal-rank fusion of ranked lists: fused(doc) =
    sum over legs of 1/(k + rank).  A rank-space alternative to the
    reference's score-space fusion (``ensemble_marco.py:235-238``);
    beyond-parity option — robust when leg score scales differ."""
    out: Dict[str, Dict[int, float]] = {}
    queries = set()
    for leg in leg_preds:
        queries.update(leg.keys())
    for q in queries:
        sq: Dict[int, float] = {}
        for leg in leg_preds:
            for r, doc in enumerate(leg.get(q, ())):
                sq[doc] = sq.get(doc, 0.0) + 1.0 / (k + r + 1)
        out[q] = sq
    return out


class AnswerIndex:
    """Inverted doc -> answering-query arrays
    (``test_inverse_{offsets,array}.bin``,
    ``dataprocess/NQ_dpr/get_inverse_answers.py:10-27``)."""

    def __init__(self, offsets: np.ndarray, array: np.ndarray):
        self.offsets = np.asarray(offsets)
        self.array = np.asarray(array)

    @classmethod
    def from_files(cls, offsets_path: str, array_path: str):
        return cls(np.fromfile(offsets_path, np.int64),
                   np.fromfile(array_path, np.int32))

    @classmethod
    def from_answer_sets(cls, doc_answers: Sequence[Sequence[int]]):
        """Build from per-doc lists of answering query indices."""
        offsets = np.zeros(len(doc_answers) + 1, np.int64)
        np.cumsum([len(a) for a in doc_answers], out=offsets[1:])
        array = np.concatenate(
            [np.asarray(a, np.int32) for a in doc_answers]
            or [np.zeros(0, np.int32)])
        return cls(offsets, array)

    def doc_answers_query(self, doc: int, qind: int) -> bool:
        s, e = self.offsets[doc], self.offsets[doc + 1]
        return bool(np.isin(qind, self.array[s:e]).item())

    def query_clusters(self, cluster_of_doc: np.ndarray,
                       n_queries: int) -> "tuple[np.ndarray, np.ndarray]":
        """Invert to query -> sorted unique clusters containing an
        answering doc (CSR).  One O(nnz) pass replaces the per-beam
        cluster-member python loop at eval time
        (``main_models.py:3744-3756`` did the same walk per query)."""
        nnz = len(self.array)
        # doc index of every (doc, query) pair
        doc_of = np.repeat(np.arange(len(self.offsets) - 1),
                           np.diff(self.offsets))
        q = self.array[:nnz]
        clus = cluster_of_doc[doc_of]
        order = np.lexsort((clus, q))
        q_s, c_s = q[order], clus[order]
        # unique (query, cluster) pairs
        keep = np.ones(len(q_s), bool)
        keep[1:] = (q_s[1:] != q_s[:-1]) | (c_s[1:] != c_s[:-1])
        q_u, c_u = q_s[keep], c_s[keep]
        offsets = np.zeros(n_queries + 1, np.int64)
        np.add.at(offsets, q_u + 1, 1)
        np.cumsum(offsets, out=offsets)
        return offsets, c_u.astype(np.int64)

    def first_hit_rank(self, qind: int,
                       ranked_docs: Sequence[int]) -> Optional[int]:
        """First rank whose doc answers the query
        (``ensemble_nqdpr.py:26-33`` / ``main_models.py:4069-4071``)."""
        r = self.first_hit_ranks(np.asarray([qind]),
                                 np.asarray(ranked_docs)[None, :])
        return None if r[0] < 0 else int(r[0])

    def _ensure_keys(self, min_stride: int):
        """Sorted (doc, query) composite keys: membership of any
        (doc, q) pair becomes one global binary search — the whole
        batch vectorizes as a single ``np.searchsorted``.  The stride
        must exceed every query index that will ever be probed (not
        just those present in the array), else a probe with
        qind >= stride aliases into the next doc's key range and
        reports a false hit — so callers pass the probe-side maximum
        and keys are rebuilt when it grows."""
        stride = max(int(self.array.max()) + 2 if len(self.array) else 2,
                     min_stride)
        if getattr(self, "_keys", None) is None or self._stride < stride:
            doc_of = np.repeat(np.arange(len(self.offsets) - 1,
                                         dtype=np.int64),
                               np.diff(self.offsets))
            self._stride = stride
            self._keys = np.sort(doc_of * self._stride + self.array)

    def first_hit_ranks(self, qinds: np.ndarray,
                        ranked_docs: np.ndarray) -> np.ndarray:
        """Batched :meth:`first_hit_rank`: qinds (B,), ranked_docs
        (B, P) with -1 padding -> (B,) first answering rank or -1.
        One vectorized searchsorted over all (B*P) pairs replaces the
        per-query per-rank python walk."""
        ranked = np.asarray(ranked_docs)
        qinds = np.asarray(qinds, np.int64)
        self._ensure_keys(int(qinds.max()) + 2 if qinds.size else 2)
        valid = ranked >= 0
        n_docs = len(self.offsets) - 1
        doc = np.clip(ranked, 0, n_docs - 1).astype(np.int64)
        k = doc * self._stride + qinds[:, None]
        pos = np.searchsorted(self._keys, k)
        in_range = pos < len(self._keys)
        hit = np.zeros(ranked.shape, bool)
        hit[in_range] = self._keys[pos[in_range]] == k[in_range]
        hit &= valid
        found = hit.any(axis=1)
        first = hit.argmax(axis=1)
        return np.where(found, first, -1)


def nq_hit_metrics(
    answer_index: AnswerIndex,
    query_indices: Sequence[int],
    ranked_docs: Sequence[Sequence[int]],
    recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100),
) -> Dict[str, Dict[int, float]]:
    """HitRate/MRR over answer sets (each query has a single 'virtual' gt:
    the first answering doc)."""
    from .metrics import per_query_metrics
    agg = {"recall": {k: 0.0 for k in recall_ks},
           "mrr": {k: 0.0 for k in recall_ks},
           "hitrate": {k: 0.0 for k in recall_ks}}
    n = 0
    for qind, docs in zip(query_indices, ranked_docs):
        rank = answer_index.first_hit_rank(int(qind), docs)
        m = per_query_metrics([rank], recall_ks)
        for name in agg:
            for k in recall_ks:
                agg[name][k] += m[name][k]
        n += 1
    for name in agg:
        for k in recall_ks:
            agg[name][k] /= max(n, 1)
    return agg
