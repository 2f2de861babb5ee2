"""Plain fine stage: cluster membership, the capped window of each
(query, cluster) bucket, in-window scores and the per-query pool.

A document belongs to the cluster of its packed code; within a cluster
members are in document-id order, clusters in id order (a stable sort of
the cluster ids).  Bucket ``(q, b)`` over cluster ``c`` with members at
sorted positions ``[s, e)`` covers the ``cap`` positions from ``al =
floor(s / align) * align``: slot ``j`` holds position ``al + j`` when
``s <= al + j < e``, nothing otherwise (the serving contract's aligned
window).  A query's pool is the ``pool`` best of its buckets' slots by
score, ties to the lower (bucket, slot) position.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import F32


class Membership:
    """Clusters of every document, from the packed codes (N,) int64."""

    def __init__(self, cluster: torch.Tensor, n_clusters: int):
        self.order = torch.argsort(cluster, stable=True)
        counts = torch.bincount(cluster, minlength=n_clusters)
        self.offsets = torch.zeros(n_clusters + 1, dtype=torch.long,
                                   device=cluster.device)
        self.offsets[1:] = torch.cumsum(counts, 0)

    def windows(self, cidx: torch.Tensor, cap: int, align: int):
        """cidx (n, nb) -> documents (n, nb, cap) int64, -1 where a slot
        holds nothing."""
        ci = cidx.long().to(self.order.device)
        s, e = self.offsets[ci], self.offsets[ci + 1]
        pos = (s // align * align)[..., None] + torch.arange(
            cap, device=ci.device)
        ok = (pos >= s[..., None]) & (pos < e[..., None])
        docs = self.order[pos.clamp(max=self.order.shape[0] - 1)]
        return torch.where(ok, docs, torch.full_like(docs, -1))


def window_scores(docs, q, rows_of, P=F32, block: int = 1 << 17):
    """Scores (n, nb, cap) float32 of ``q`` (n, d) against each slot's
    row, -inf where a slot is empty; ``rows_of(doc ids)`` gives the
    corpus rows as stored."""
    n = docs.shape[0]
    flat = docs.reshape(n, -1)
    out = torch.full(flat.shape, float("-inf"), device=docs.device)
    qi, si = torch.nonzero(flat >= 0, as_tuple=True)
    qq = P.q(q.to(docs.device))
    for a in range(0, qi.shape[0], block):
        rows = P.q(rows_of(flat[qi[a:a + block], si[a:a + block]]))
        out[qi[a:a + block], si[a:a + block]] = (
            rows * qq[qi[a:a + block]]).sum(-1)
    return out.reshape(docs.shape)


def pool_topk(docs, scores, pool: int):
    """(ids (n, k), scores (n, k)) host arrays, k = pool: the best slots
    by score, ties to the lower flat position; -1 past the filled ones."""
    n = docs.shape[0]
    s = scores.reshape(n, -1)
    d = docs.reshape(n, -1)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    k = min(pool, s.shape[1])
    top_s = torch.gather(s, 1, order[:, :k])
    top_d = torch.gather(d, 1, order[:, :k])
    top_d = torch.where(torch.isfinite(top_s), top_d,
                        torch.full_like(top_d, -1))
    return top_d.cpu().numpy(), top_s.cpu().numpy()


def pool_readings(port_ids, port_scores, docs, scores, q_norm, pool: int):
    """Judge one query's served pool against its windows.  ``docs``,
    ``scores``: this query's window documents and reference scores
    (flat, -1 / -inf where empty).  Returns (faults, largest score error
    over |q|, largest gap by which a document the pool missed scores
    above the worst one it kept, over |q|)."""
    valid = docs >= 0
    win_docs, win_s = docs[valid], scores[valid]
    score_of = dict(zip(win_docs.tolist(), win_s.tolist()))
    mult = {}
    for x in win_docs.tolist():
        mult[x] = mult.get(x, 0) + 1
    n_exp = min(pool, int(valid.sum()))
    ok_port = port_ids >= 0
    n_port = int(ok_port.sum())
    faults = 0
    if n_port != n_exp or not ok_port[:n_port].all():
        faults += 1
    kept = port_ids[:n_port]
    if n_port > 1 and (np.diff(port_scores[:n_port]) > 0).any():
        faults += 1
    seen = {}
    for x in kept.tolist():
        seen[x] = seen.get(x, 0) + 1
    if any(mult.get(x, 0) < c for x, c in seen.items()):
        return faults + 1, float("inf"), float("inf")
    if n_port == 0:
        return faults, 0.0, 0.0
    ref_kept = np.array([score_of[x] for x in kept.tolist()])
    err = float(np.abs(port_scores[:n_port] - ref_kept).max()) / q_norm
    # the reference's own pool, as a multiset, less what was kept
    order = np.lexsort((np.flatnonzero(valid), -win_s))[:n_exp]
    missing = dict(seen)
    gap = 0.0
    worst = ref_kept.min()
    for x in win_docs[order].tolist():
        if missing.get(x, 0) > 0:
            missing[x] -= 1
        else:
            gap = max(gap, (score_of[x] - worst) / q_norm)
    return faults, err, gap
