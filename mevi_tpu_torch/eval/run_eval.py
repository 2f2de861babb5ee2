"""Evaluation driver: coarse beam -> fine re-rank -> metrics + result tsvs
(port of ``mevi_tpu.eval.run_eval``).

Per batch it decodes RQ codes with the constrained beam, re-ranks inside
the predicted clusters with the query tower's embedding (on the card
through the bucket kernel, or streamed from host memory), and keeps the
rank of each ground-truth doc; at the end it gives Recall/MRR/HitRate@k
at the coarse and fine levels, ndoc@cluster, and the coarse / fine /
hard-negative result tsvs the ensemble reads
(``main_models.py:3518-4393``, ``:4227-4235``).

The fine stage on the card is :class:`..searcher.FineReranker` with the
TPU contract's aligned window (``align=8``): a bucket with
``s % 8 + size > cap`` loses up to 7 tail members there, as on the TPU,
while the JAX package's CPU path scores the unaligned ``[s, s + cap)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import InferConfig
from ..data import io
from ..decode.beam import nci_beam_search_incremental
from ..index.csr import pack_codes
from ..models.nci import NCIT5
from .metrics import metrics_from_rank_matrix, ranks_of_gts
from .searcher import FineIndex, FineReranker, coarse_ranks, host_csr
from .streaming import HostStreamFineReranker, streaming_mips_topk


@dataclasses.dataclass
class EvalBatchResult:
    queries: List[str]
    beam_codes: np.ndarray       # (b, nb, M)
    beam_scores: np.ndarray      # (b, nb)
    fine_ids: Optional[np.ndarray] = None     # (b, pool)
    fine_scores: Optional[np.ndarray] = None
    ndoc: Optional[np.ndarray] = None


@dataclasses.dataclass
class EvalOutputs:
    coarse: Optional[dict] = None            # metrics dicts
    fine: Optional[dict] = None
    ndoc_per_query: float = 0.0
    nonempty_hit: float = 0.0
    results: Optional[List[EvalBatchResult]] = None


def pad_batch(arrs: Sequence[np.ndarray], batch: int) -> Tuple:
    """Pad the ragged final batch to the batch size by repeating its last
    row; returns (padded arrays, real count)."""
    real = len(arrs[0])
    if real == batch:
        return tuple(arrs), real
    out = []
    for a in arrs:
        pad = np.repeat(a[-1:], batch - real, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return tuple(out), real


def _coarse_ks(cfg: InferConfig):
    return sorted({k for k in cfg.recall_num
                   if k <= cfg.num_return_sequences}
                  | {cfg.num_return_sequences})


class Evaluator:
    """Batched coarse + fine evaluation over a query set.

    ``model``: the port's :class:`NCIT5` (its head tables are built once
    here).  ``query_rep_fn(ids, mask)`` -> (b, d) query embedding, called
    with tensors on ``device`` (e.g. ``T5Model.first_token_rep``).
    ``host_stream``: ``fine_index.sorted_emb`` lies in host memory (numpy
    array, memmap or CPU tensor) and the fine stage streams bucket panels
    to the card (:class:`HostStreamFineReranker`); full scans stream the
    corpus chunk-wise.  ``timings`` holds each batch's stage times (ms,
    host clock; each stage ends in a fetch to the host)."""

    def __init__(self, model: NCIT5, cfg: InferConfig,
                 fine_index: Optional[FineIndex] = None,
                 query_rep_fn: Optional[Callable] = None,
                 doc_codes: Optional[np.ndarray] = None,
                 host_stream: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.fine_index = fine_index
        self.query_rep_fn = query_rep_fn
        self.doc_codes = doc_codes
        self.host_stream = host_stream
        self.timings: List[dict] = []
        with torch.inference_mode():
            self._tables = model.head_level_tables()
        self._rerank = None
        if fine_index is not None and host_stream:
            offsets, doc_ids = host_csr(fine_index)
            # a bf16 corpus takes bf16 queries, as FineReranker casts them
            semb = fine_index.sorted_emb
            q_dt = (torch.bfloat16 if isinstance(semb, torch.Tensor)
                    and semb.dtype == torch.bfloat16 else None)
            self._rerank = HostStreamFineReranker(
                semb, offsets, doc_ids, fine_index.kary,
                cfg.max_cluster_docs, max(cfg.recall_num), query_dtype=q_dt,
                device=self.device)
        elif fine_index is not None:
            self._rerank = FineReranker(
                fine_index, cfg.max_cluster_docs, max(cfg.recall_num),
                overflow=cfg.overflow, rank=cfg.rank_mode,
                device=self.device)

    @torch.inference_mode()
    def run_batch(self, queries: List[str], query_ids: np.ndarray,
                  query_mask: np.ndarray) -> EvalBatchResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        ids = torch.as_tensor(query_ids).to(self.device)
        mask = torch.as_tensor(query_mask).to(self.device)
        codes, scores, _ = nci_beam_search_incremental(
            self.model, ids, mask, cfg.beams(), cfg.length_penalty,
            level_tables=self._tables)
        nrs = cfg.num_return_sequences
        out = EvalBatchResult(queries, codes[:, :nrs].cpu().numpy(),
                              scores[:, :nrs].cpu().numpy())
        t1 = time.perf_counter()
        if (cfg.recall_level in ("fine", "both")
                and self._rerank is not None):
            qemb = self.query_rep_fn(ids, mask)
            if cfg.eval_all_documents:
                out.fine_scores, out.fine_ids, out.ndoc = \
                    self._full_scan(qemb)
            else:
                out.fine_scores, out.fine_ids, out.ndoc = self._rerank(
                    qemb, out.beam_codes)
        self.timings.append({"coarse_ms": (t1 - t0) * 1e3,
                             "fine_ms": (time.perf_counter() - t1) * 1e3})
        return out

    def _full_scan(self, qemb):
        """eval_all_documents: exact MIPS over the whole corpus
        (``main_models.py:3818-3876``) in CSR row order, rows mapped to
        doc ids by the reranker's ``HostCSR``; on the card through
        :meth:`FineReranker.scan`."""
        csr, k = self._rerank.csr, max(self.cfg.recall_num)
        n_real = len(csr.doc_ids_h)
        if self.host_stream:
            s, rows = streaming_mips_topk(
                qemb, self.fine_index.sorted_emb[:n_real], k=k,
                device=self.device)
            ids = csr.ids(rows)
        else:
            s, ids = self._rerank.scan(qemb, k)
        return s, ids, np.full(qemb.shape[0], n_real, np.int64)

    @staticmethod
    def _trimmed(res: EvalBatchResult, real: int) -> EvalBatchResult:
        """Drop the rows ``pad_batch`` added, from every array."""
        for f in ("beam_codes", "beam_scores", "fine_ids", "fine_scores",
                  "ndoc"):
            if getattr(res, f) is not None:
                setattr(res, f, getattr(res, f)[:real])
        return res

    def evaluate(self, queries: List[str], query_ids: np.ndarray,
                 query_mask: np.ndarray, gt_docids: List[List[int]],
                 batch_size: int = 16,
                 keep_results: bool = False) -> EvalOutputs:
        cfg = self.cfg
        n = len(queries)
        max_gt = max(len(g) for g in gt_docids)
        gt_mat = np.full((n, max_gt), -1, np.int64)
        for i, g in enumerate(gt_docids):
            gt_mat[i, :len(g)] = g
        gt_counts = np.array([len(g) for g in gt_docids])

        all_coarse_ranks, all_fine_ranks, ndocs, results = [], [], [], []
        for s in range(0, n, batch_size):
            sl = slice(s, min(s + batch_size, n))
            (qi, qm), real = pad_batch(
                [query_ids[sl], query_mask[sl]], batch_size)
            res = self._trimmed(self.run_batch(list(queries[sl]), qi, qm),
                                real)
            if res.fine_ids is not None:
                ndocs.append(res.ndoc)
            if keep_results:
                results.append(res)
            if cfg.recall_level in ("coarse", "both"):
                if self.doc_codes is None:
                    raise ValueError("coarse metrics need doc_codes")
                gt_codes = np.where(
                    gt_mat[sl][..., None] >= 0,
                    self.doc_codes[np.maximum(gt_mat[sl], 0)], -1)
                all_coarse_ranks.append(coarse_ranks(
                    res.beam_codes, gt_codes, self.model.dims.kary))
            if res.fine_ids is not None:
                all_fine_ranks.append(ranks_of_gts(res.fine_ids,
                                                   gt_mat[sl]))

        out = EvalOutputs(results=results if keep_results else None)
        if all_coarse_ranks:
            cranks = np.concatenate(all_coarse_ranks)
            out.coarse = metrics_from_rank_matrix(cranks, gt_counts,
                                                  _coarse_ks(cfg))
            out.nonempty_hit = float((cranks >= 0).any(1).mean())
        if all_fine_ranks:
            out.fine = metrics_from_rank_matrix(
                np.concatenate(all_fine_ranks), gt_counts, cfg.recall_num)
        if ndocs:
            out.ndoc_per_query = float(np.concatenate(ndocs).mean())
        return out

    def evaluate_nq(self, queries: List[str], query_ids: np.ndarray,
                    query_mask: np.ndarray, query_indices: Sequence[int],
                    answer_index, batch_size: int = 16,
                    keep_results: bool = False) -> EvalOutputs:
        """NQ answer-set evaluation (``main_models.py:3738-3756,
        4061-4077``): a query hits at the first ranked doc whose answer
        set contains it; coarse hit = first beam whose cluster holds any
        answering doc.  ``answer_index``: an ``ensemble.AnswerIndex``."""
        cfg = self.cfg
        n = len(queries)
        coarse_hits, fine_hits, ndocs, results = [], [], [], []
        q_clus_off = q_clus = None
        if cfg.recall_level in ("coarse", "both") and \
                self.fine_index is not None:
            # invert the answer arrays once to query -> answering clusters
            cluster_of_doc = self._rerank.csr.doc_clusters()
            nq_total = int(answer_index.array.max()) + 1 \
                if len(answer_index.array) else 1
            nq_total = max(nq_total, int(max(query_indices)) + 1)
            q_clus_off, q_clus = answer_index.query_clusters(
                cluster_of_doc, nq_total)
        for s in range(0, n, batch_size):
            sl = slice(s, min(s + batch_size, n))
            (qi, qm), real = pad_batch(
                [query_ids[sl], query_mask[sl]], batch_size)
            res = self._trimmed(self.run_batch(list(queries[sl]), qi, qm),
                                real)
            if res.fine_ids is not None:
                ndocs.append(res.ndoc)
            if keep_results:
                results.append(res)
            qind_b = np.asarray(query_indices[s:s + real], np.int64)
            if q_clus_off is not None:
                for b in range(real):
                    qind = int(qind_b[b])
                    cidx = pack_codes(res.beam_codes[b],
                                      self.fine_index.kary)
                    mine = q_clus[q_clus_off[qind]:q_clus_off[qind + 1]]
                    isin = np.isin(cidx, mine)
                    coarse_hits.append(int(isin.argmax()) if isin.any()
                                       else -1)
            if res.fine_ids is not None:
                fine_hits.extend(answer_index.first_hit_ranks(
                    qind_b, res.fine_ids[:real]).tolist())

        out = EvalOutputs(results=results if keep_results else None)
        ones = np.ones(n, np.int64)
        if coarse_hits:
            out.coarse = metrics_from_rank_matrix(
                np.asarray(coarse_hits)[:, None], ones, _coarse_ks(cfg))
        if fine_hits:
            out.fine = metrics_from_rank_matrix(
                np.asarray(fine_hits)[:, None], ones, cfg.recall_num)
        if ndocs:
            out.ndoc_per_query = float(np.concatenate(ndocs).mean())
        return out


def write_result_files(outputs: EvalOutputs, gt_docids: List[List[int]],
                       coarse_path: Optional[str] = None,
                       fine_path: Optional[str] = None,
                       hardneg_path: Optional[str] = None,
                       hard_neg_k: int = 0) -> None:
    """Write the ensemble-facing tsvs (``main_models.py:4227-4235``).

    ``hard_neg_k``: cap the hard-negative list per query
    (``--save_hard_neg``, ``main_models.py:4046-4053``); 0 = pool size.
    """
    if outputs.results is None:
        raise ValueError("write_result_files needs "
                         "evaluate(keep_results=True)")
    qi = 0
    coarse_rows, fine_rows, hn_rows = [], [], []
    for res in outputs.results:
        for b in range(len(res.queries)):
            gts = gt_docids[qi]
            if coarse_path:
                coarse_rows.append((
                    res.queries[b],
                    [c.tolist() for c in res.beam_codes[b]],
                    gts, res.beam_scores[b].tolist()))
            if res.fine_ids is not None:
                ids = [int(d) for d in res.fine_ids[b] if d >= 0]
                if fine_path:
                    fine_rows.append((res.queries[b],
                                      int(res.ndoc[b]), ids, gts))
                if hardneg_path:
                    k = hard_neg_k or len(ids)
                    hn_rows.append((
                        res.queries[b], [],
                        ids[:k], res.fine_scores[b][:min(
                            k, len(ids))].tolist()))
            qi += 1
    if coarse_path:
        io.write_coarse_results(coarse_path, coarse_rows)
    if fine_path:
        io.write_fine_results(fine_path, fine_rows)
    if hardneg_path:
        io.write_hardneg_results(hardneg_path, hn_rows)
