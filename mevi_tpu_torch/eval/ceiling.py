"""Data-ceiling bounds for the synthetic query language (port of
``mevi_tpu.eval.ceiling``).

Queries of :mod:`mevi_tpu_torch.data.synth` name their document through
info tokens, each replaced by a filler with ``spec.info_dropout``, so
retrieval quality on this corpus has a computable ceiling:

* **Bayes bound**: the posterior over docs given a query is uniform over
  the docs consistent with its observed info tokens.  With ``|C|`` such
  docs: ``recall@k = E[min(1, k/|C|)]``, ``mrr@10 = E[H(min(10,|C|))/|C|]``
  and ``hit@10 = E[top10_code_mass/|C|]``.  No retriever beats these.
* **Oracle single-vector tower**: the posterior-mean document embedding
  per query, ranked by exact MIPS over the whole corpus; it bounds what a
  trained tower of the same interface can do.

The slot decoding, the Bayes arithmetic and the oracle embeddings are the
JAX package's numpy.  The two corpus-wide passes run on the device: the
consistent-candidate counts (:func:`candidate_stats`, one (queries,
ndoc) mask a chunk of queries) and the exact-MIPS scan
(:func:`exact_mips_metrics`: rows generated a chunk at a time, a running
top-k whose ties keep the lower doc id, as ``lax.top_k`` does).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device, synchronize
from ..data.synth import SynthSpec, gen_rows, info_positions, tables_to
from ..index.csr import pack_codes
from ..ops.topk import merge_topk


def observed_info(spec: SynthSpec, tok: np.ndarray) -> np.ndarray:
    """(n, qlen) query tokens -> (n, n_info) observed slot values, -1
    where the info token was dropped (slot j's region is
    [2 + j*kary, 2 + (j+1)*kary); fillers lie above every region)."""
    pos = info_positions(spec)
    n = tok.shape[0]
    out = np.full((n, spec.n_info), -1, np.int32)
    for j, p in enumerate(pos):
        v = tok[:, p].astype(np.int64) - (2 + j * spec.kary)
        ok = (v >= 0) & (v < spec.kary)
        out[:, j] = np.where(ok, v, -1).astype(np.int32)
    return out


def doc_attrs(spec: SynthSpec, draws: np.ndarray) -> np.ndarray:
    """(ndoc, 4) draws -> (ndoc, n_info) attributes in the query tokens'
    slot order: h1, h2, h3, row digits LSB-first."""
    rd = spec._row_digits
    attrs = np.empty((len(draws), 3 + rd), np.int32)
    attrs[:, :3] = draws[:, :3]
    r = draws[:, 3].astype(np.int64)
    for k in range(rd):
        attrs[:, 3 + k] = (r % spec.kary).astype(np.int32)
        r //= spec.kary
    return attrs


def candidate_stats(spec: SynthSpec, draws: np.ndarray, codes: np.ndarray,
                    obs: np.ndarray, gt_docs: np.ndarray,
                    top_codes: int = 10, chunk: int = 64, device="cuda",
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per query: (|C|, top-``top_codes`` candidate-code mass, gt-code
    candidate mass) as int64 numpy.  ``codes``: (ndoc, M) RQ codes.  The
    (chunk, ndoc) consistency mask and the per-query code histograms are
    built on ``device``."""
    dev = resolve_device(device)
    attrs = as_device_tensor(doc_attrs(spec, draws), dev)
    cidx = as_device_tensor(pack_codes(codes, spec.kary).astype(np.int64),
                            dev)
    C = spec.kary ** codes.shape[1]
    obs_d = as_device_tensor(obs, dev)
    gt_c = cidx[as_device_tensor(np.asarray(gt_docs, np.int64), dev)]
    n = obs.shape[0]
    counts = np.zeros(n, np.int64)
    topmass = np.zeros(n, np.int64)
    gtmass = np.zeros(n, np.int64)
    for s in range(0, n, chunk):
        o = obs_d[s:s + chunk]
        m = torch.ones((o.shape[0], attrs.shape[0]), dtype=torch.bool,
                       device=dev)
        for j in range(spec.n_info):
            oj = o[:, j:j + 1]
            m &= (oj < 0) | (attrs[None, :, j] == oj)
        qi, di = m.nonzero(as_tuple=True)
        cc = torch.bincount(qi * C + cidx[di], minlength=o.shape[0] * C
                            ).view(o.shape[0], C)
        counts[s:s + chunk] = m.sum(1).cpu().numpy()
        topmass[s:s + chunk] = cc.topk(min(top_codes, C), dim=1
                                       ).values.sum(1).cpu().numpy()
        gtmass[s:s + chunk] = cc.gather(
            1, gt_c[s:s + chunk, None])[:, 0].cpu().numpy()
    return counts, topmass, gtmass


def bayes_bounds(spec: SynthSpec, draws: np.ndarray, codes: np.ndarray,
                 tok: np.ndarray, gt_docs: np.ndarray, ks=(1, 10, 100),
                 device="cuda") -> Dict[str, float]:
    """Information-theoretic ceiling of any retriever on these queries."""
    obs = observed_info(spec, tok)
    counts, topmass, _ = candidate_stats(spec, draws, codes, obs, gt_docs,
                                         device=device)
    assert (counts >= 1).all(), "gt doc must be consistent with its query"
    out = {f"bayes_recall@{k}":
           round(float(np.minimum(1.0, k / counts).mean()), 4)
           for k in ks}
    H = np.cumsum(1.0 / np.arange(1, 11))            # H[m-1] = sum 1/i
    m = np.minimum(counts, 10)
    out["bayes_mrr@10"] = round(float((H[m - 1] / counts).mean()), 4)
    # coarse: the 10 best codes cover topmass candidates; gt uniform in C
    out["bayes_coarse_hit@10"] = round(
        float((np.minimum(topmass, counts) / counts).mean()), 4)
    out["mean_candidates"] = round(float(counts.mean()), 1)
    out["median_candidates"] = float(np.median(counts))
    out["p_all_observed"] = round(float((obs >= 0).all(1).mean()), 4)
    return out


def oracle_tower_embeddings(spec: SynthSpec, tables, obs: np.ndarray,
                            ) -> np.ndarray:
    """Posterior-mean document embedding per query -> (n, d) f32.

    Hierarchy slots: observed -> centroid row; dropped -> Zipf-prior mean
    centroid.  Pool: mean of the pool rows consistent with the observed
    row digits (all dropped -> the global pool mean)."""
    ctrs, pool = (np.asarray(t, np.float32) for t in tables)
    n = obs.shape[0]
    q = np.zeros((n, spec.d), np.float32)
    for j, a in enumerate(spec.zipf):
        p = 1.0 / np.arange(1, spec.kary + 1) ** a
        p /= p.sum()
        prior_mean = p @ ctrs[j]
        oj = obs[:, j]
        q += np.where(oj[:, None] >= 0,
                      ctrs[j][np.maximum(oj, 0)], prior_mean[None])
    rd = spec._row_digits
    rows_all = np.arange(spec.pool_n, dtype=np.int64)
    digs = np.stack([(rows_all // spec.kary ** k) % spec.kary
                     for k in range(rd)], 1)         # (pool_n, rd)
    od = obs[:, 3:3 + rd]
    for i in range(n):
        oi = od[i]
        if (oi >= 0).all():
            r = int(sum(int(oi[k]) * spec.kary ** k for k in range(rd)))
            q[i] += pool[r]
        else:
            m = np.ones(spec.pool_n, bool)
            for k in range(rd):
                if oi[k] >= 0:
                    m &= digs[:, k] == oi[k]
            q[i] += pool[m].mean(0)
    return q


@torch.inference_mode()
def exact_mips_topk(q, spec: SynthSpec, tables, draws, k: int = 100,
                    chunk_docs: int = 1 << 16, device="cuda",
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` (scores, doc ids) of float32 queries over every corpus
    row, the rows generated on ``device`` a chunk at a time; ties keep
    the lower doc id.  The last chunk may be short."""
    dev = resolve_device(device)
    tables = tables_to(tables, dev)
    qd = as_device_tensor(np.asarray(q, np.float32), dev)
    dr = as_device_tensor(draws, dev)
    n = qd.shape[0]
    run_s = torch.full((n, k), -float("inf"), device=dev)
    run_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, spec.ndoc, chunk_docs):
        rows = gen_rows(tables, dr[s:s + chunk_docs])
        ids = torch.arange(s, s + rows.shape[0], device=dev)
        run_s, run_i = merge_topk(run_s, run_i, qd @ rows.T,
                                  ids.expand(n, -1), k)
    return run_s, run_i


def exact_mips_metrics(q: np.ndarray, spec: SynthSpec, tables, draws,
                       gt_docs: np.ndarray, k: int = 100,
                       chunk_docs: int = 1 << 16, device="cuda",
                       ) -> Dict[str, float]:
    """Exact-MIPS recall/MRR of query vectors against the full corpus
    (rows generated on the device chunk-wise; no (ndoc, d) host temp)."""
    _, ids = exact_mips_topk(q, spec, tables, draws, k, chunk_docs, device)
    ids = ids.cpu().numpy()
    found = ids == np.asarray(gt_docs)[:, None]
    pos = np.argmax(found, 1)
    hit = found.any(1)
    out = {f"recall@{kk}": round(float(((pos < kk) & hit).mean()), 4)
           for kk in (1, 10, 100) if kk <= k}
    out["mrr@10"] = round(float(
        np.where(hit & (pos < 10), 1.0 / (pos + 1), 0.0).mean()), 4)
    return out


def ceiling_report(spec: SynthSpec, tables, draws: np.ndarray,
                   codes: np.ndarray, tok: np.ndarray,
                   gt_docs: np.ndarray, device="cuda",
                   timings: Optional[dict] = None) -> Dict[str, float]:
    """Full ceiling bundle for a dev set: Bayes bounds + oracle-tower
    exact-MIPS metrics (keys prefixed ``oracle_tower_``).  ``tables``:
    the host (ctrs, pool) of ``make_tables``.  ``timings``, when given,
    receives the seconds of the three parts (``bayes_s``,
    ``oracle_embeddings_s``, ``exact_mips_scan_s``; the device
    synchronized at each end)."""
    dev = resolve_device(device)
    clock = [time.perf_counter()]

    def lap(name):
        synchronize(dev)
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now
    out = bayes_bounds(spec, draws, codes, tok, gt_docs, device=dev)
    lap("bayes_s")
    q = oracle_tower_embeddings(spec, tables, observed_info(spec, tok))
    lap("oracle_embeddings_s")
    m = exact_mips_metrics(q, spec, tables, draws, gt_docs, device=dev)
    lap("exact_mips_scan_s")
    out.update({f"oracle_tower_{k}": v for k, v in m.items()})
    return out
