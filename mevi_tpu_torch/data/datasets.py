"""Host-side datasets and batch iterators (port of
``mevi_tpu.data.datasets``).

The data pipeline is explicit numpy on the host (tokenization and
negative sampling never touch the device), emitting fixed-shape batches
that a prefetcher moves to the device while the previous step runs.  The
classes are the JAX package's numpy, so one seed gives the same batches
and negatives in both packages.

Hard-negative semantics (``sample_negatives``, ``main_models.py:
1813-1950``, co_neg_from='clus'):

* candidates = other members of the positive doc's RQ cluster;
* if the cluster is a singleton, fall back to the union of all clusters
  whose code differs in exactly one level;
* if still empty, sample from the whole corpus;
* sample ``co_neg_num`` with replacement when short, without otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..index.csr import build_csr, pack_codes


@dataclasses.dataclass
class NCIDataset:
    """(query tokens, code labels) pairs for seq2seq training."""
    query_ids: np.ndarray     # (n, Lq) int32
    query_mask: np.ndarray    # (n, Lq) int32
    codes: np.ndarray         # (n, M) int32

    def __post_init__(self):
        assert len(self.query_ids) == len(self.codes)

    def __len__(self):
        return len(self.query_ids)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, drop_last: bool = True,
                ) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        order = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        for s in range(0, end, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            yield {
                "query_ids": self.query_ids[idx],
                "query_mask": self.query_mask[idx],
                "codes": self.codes[idx],
            }


class ClusterNegativeSampler:
    """Hard negatives from the positive's RQ cluster (CSR-backed)."""

    def __init__(self, doc_codes: np.ndarray, kary: int):
        self.kary = kary
        self.levels = doc_codes.shape[-1]
        self.doc_codes = np.asarray(doc_codes)
        self.offsets, self.doc_ids = build_csr(doc_codes, kary)
        self.num_docs = len(doc_codes)

    def cluster_members(self, cluster_idx: int) -> np.ndarray:
        s, e = self.offsets[cluster_idx], self.offsets[cluster_idx + 1]
        return self.doc_ids[s:e]

    def _hamming1_members(self, code: np.ndarray) -> np.ndarray:
        outs = []
        for lvl in range(self.levels):
            for c in range(self.kary):
                if c == code[lvl]:
                    continue
                alt = code.copy()
                alt[lvl] = c
                outs.append(self.cluster_members(
                    int(pack_codes(alt, self.kary))))
        return np.concatenate(outs) if outs else np.zeros(0, np.int32)

    def sample(self, pos_doc: int, n_neg: int,
               rng: np.random.Generator) -> np.ndarray:
        code = self.doc_codes[pos_doc]
        members = self.cluster_members(int(pack_codes(code, self.kary)))
        cands = members[members != pos_doc]
        if len(cands) == 0:
            cands = self._hamming1_members(code)
            cands = cands[cands != pos_doc]
        if len(cands) == 0:
            cands = rng.choice(self.num_docs, size=n_neg + 1,
                               replace=False)
            cands = cands[cands != pos_doc][:n_neg]
        if len(cands) >= n_neg:
            return rng.choice(cands, size=n_neg, replace=False)
        return rng.choice(cands, size=n_neg, replace=True)


@dataclasses.dataclass
class TwinDataset:
    """Twin-tower contrastive batches: query + (pos, negs) doc tokens."""
    query_ids: np.ndarray     # (n, Lq)
    query_mask: np.ndarray
    pos_doc: np.ndarray       # (n,) int — positive doc id
    doc_tokens: np.ndarray    # (ndoc, Ld) corpus doc tokens
    doc_masks: np.ndarray
    sampler: ClusterNegativeSampler
    n_neg: int = 7            # --co_neg_num default (main.py:537)

    def __len__(self):
        return len(self.query_ids)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - (n % batch_size), batch_size):
            idx = order[s:s + batch_size]
            rows = []
            for q in idx:
                pos = int(self.pos_doc[q])
                negs = self.sampler.sample(pos, self.n_neg, rng)
                rows.append(np.concatenate([[pos], negs]))
            docs = np.stack(rows).reshape(-1)         # (b * (1+neg),)
            yield {
                "query_ids": self.query_ids[idx],
                "query_mask": self.query_mask[idx],
                "doc_ids": self.doc_tokens[docs],
                "doc_mask": self.doc_masks[docs],
                "doc_index": docs.reshape(len(idx), 1 + self.n_neg),
            }


class FileNegativeSampler:
    """Hard negatives from a precomputed per-query list
    (``co_neg_from='file'`` / 'simans', ``main_models.py:1873-1928``):
    uniform sampling, or score-weighted ('simans') when scores given."""

    def __init__(self, negatives: Dict[str, Sequence[int]],
                 scores: Optional[Dict[str, Sequence[float]]] = None,
                 num_docs: int = 0):
        self.negatives = negatives
        self.scores = scores
        self.num_docs = num_docs

    @classmethod
    def from_hardneg_tsv(cls, path: str, num_docs: int = 0):
        from .io import parse_result_tsv
        preds, scores, _ = parse_result_tsv(
            path, {"query": 0, "pred": 2, "score": 3})
        return cls(preds, scores, num_docs)

    def sample(self, query: str, pos_doc: int, n_neg: int,
               rng: np.random.Generator) -> np.ndarray:
        cands = [c for c in self.negatives.get(query, ())
                 if c != pos_doc]
        if not cands:
            out = rng.integers(0, max(self.num_docs, 1), n_neg + 1)
            return out[out != pos_doc][:n_neg]
        if self.scores is not None and query in self.scores:
            w = np.asarray([s for c, s in zip(self.negatives[query],
                                              self.scores[query])
                            if c != pos_doc], np.float64)
            w = np.exp(w - w.max())
            w /= w.sum()
            return rng.choice(cands, size=min(n_neg, len(cands)),
                              replace=len(cands) < n_neg, p=w)
        replace = len(cands) < n_neg
        return rng.choice(cands, size=n_neg, replace=replace)


@dataclasses.dataclass
class JointDataset:
    """Batches for the joint NCI+codebook+twin step (``--codebook 1``
    training, ``main_models.py:2197-2584``): per query — query tokens,
    the positive passage's tokens, and ``n_neg`` in-cluster hard
    negatives' tokens.  Codes are assigned at run time from the live
    tower + codebooks unless ``doc_codes`` is given."""
    query_ids: np.ndarray     # (n, Lq)
    query_mask: np.ndarray
    pos_doc: np.ndarray       # (n,) int positive doc id
    doc_tokens: np.ndarray    # (ndoc, Ld)
    doc_masks: np.ndarray
    sampler: Optional[ClusterNegativeSampler] = None
    n_neg: int = 7
    # precomputed per-doc codes (``pq_runtime_label=0``): batches carry
    # 'codes' and the joint step skips the runtime assignment labels
    doc_codes: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.query_ids)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - (n % batch_size), batch_size):
            idx = order[s:s + batch_size]
            pos = self.pos_doc[idx]
            batch = {
                "query_ids": self.query_ids[idx],
                "query_mask": self.query_mask[idx],
                "pos_doc_ids": self.doc_tokens[pos],
                "pos_doc_mask": self.doc_masks[pos],
            }
            if self.doc_codes is not None:
                batch["codes"] = self.doc_codes[pos].astype(np.int32)
            if self.sampler is not None and self.n_neg > 0:
                negs = np.stack([
                    self.sampler.sample(int(p), self.n_neg, rng)
                    for p in pos])                       # (b, n_neg)
                batch["neg_doc_ids"] = self.doc_tokens[negs]
                batch["neg_doc_mask"] = self.doc_masks[negs]
            yield batch


def alternating_batches(iter_a, iter_b, ratio: Tuple[int, int],
                        ) -> Iterator[Tuple[str, Dict]]:
    """Interleave two batch streams by a (a_count, b_count) ratio (the
    reference's within-epoch NCI/twin alternation,
    ``main_models.py:899-948``).  Yields ('a'|'b', batch); stops when
    either stream is exhausted."""
    a_n, b_n = ratio
    ia, ib = iter(iter_a), iter(iter_b)
    try:
        while True:
            for _ in range(a_n):
                yield "a", next(ia)
            for _ in range(b_n):
                yield "b", next(ib)
    except StopIteration:
        return


def _to_device(batch, dev: torch.device):
    """Every numpy array of a batch dict as a tensor on ``dev``; host to
    card copies go through pinned memory, without blocking."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if dev.type == "cuda":
                v = v.pin_memory().to(dev, non_blocking=True)
        out[k] = v
    return out


def device_prefetch(iterator, size: int = 2, device="cuda"):
    """Move host batches (dicts of arrays) to ``device`` ahead of
    consumption: up to ``size`` batches are in flight."""
    import collections
    dev = resolve_device(device)
    queue = collections.deque()
    for batch in iterator:
        queue.append(_to_device(batch, dev))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def host_prefetch(iterator, size: int = 4):
    """Assemble host batches in a background thread.

    Batch assembly (memmap reads, in-cluster negative draws) overlaps the
    device step, as the reference's ``DataLoader(num_workers=4)``
    (``main_models.py:3493-3515``).  Worker exceptions re-raise at the
    consumer.  If the consumer abandons the generator mid-epoch (break /
    exception / GC), the worker notices via a shutdown event and exits
    instead of blocking forever on a full queue."""
    import queue
    import threading
    buf = queue.Queue(maxsize=size)
    SENTINEL = object()
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        buf.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:          # noqa: BLE001 - forwarded
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    buf.put(SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = buf.get()
            if item is SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
