"""The benchmark's inputs, made from ``--seed``: a frozen copy of the
synthetic corpus of ``mevi_tpu_torch/data/synth.py`` (a 3-level
shared-sons hierarchy with per-level Zipf skew plus a leaf-noise pool,
unit-norm rows made on the device from MB-scale tables), the document
codes, the query tokens and lengths, and the doc-weighted cluster picks.

Kept here, and not imported from the program, so that no later change to
the program can move the data.  Departures from the copied generator:

* the draws are made on the device with a ``torch.Generator``, in a few
  large calls (the program draws them on the host with numpy);
* a document's code is the hierarchy it was drawn from, ``(h1, h2, h3,
  pool_row mod kary)``, not an RQ fit of its row: the fit is program code
  (``ops/rq.py``), costs seconds of set-up a run, and recovers this
  hierarchy at best;
* a row's norm is taken in float64, so that a row regenerated alone (the
  reference's rows) is bit for bit the row the corpus holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def seed_of(seed: int, stream: int) -> int:
    """A non-negative 63-bit seed for one stream of ``seed``'s draws."""
    return (int(seed) * 1_000_003 + stream * 7_919) & SEED_MASK


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, stream))
    return g


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """The configuration's ``corpus`` and ``index`` groups."""
    ndoc: int
    d: int
    kary: int
    levels: int
    pool_n: int
    scales: tuple
    zipf: tuple
    eps: float

    @classmethod
    def from_config(cls, cfg) -> "CorpusSpec":
        c, ix = cfg["corpus"], cfg["index"]
        return cls(ndoc=c["ndoc"], d=c["d"], kary=ix["kary"],
                   levels=ix["levels"], pool_n=c["pool_rows"],
                   scales=tuple(c["level_scales"]),
                   zipf=tuple(c["level_zipf"]), eps=c["leaf_noise_std"])


@dataclasses.dataclass
class Corpus:
    """Tables (ctrs (3, K, d), pool (pool_n, d)) and draws (ndoc, 4) on
    the device; ``cluster`` (ndoc,) int64 packed codes."""
    spec: CorpusSpec
    ctrs: torch.Tensor
    pool: torch.Tensor
    draws: torch.Tensor
    cluster: torch.Tensor

    def codes(self) -> torch.Tensor:
        """(ndoc, levels) int32 codes, most significant level first."""
        K, M = self.spec.kary, self.spec.levels
        c = self.cluster
        return torch.stack([(c // K ** (M - 1 - i)) % K for i in range(M)],
                           1).to(torch.int32)


def make_corpus(spec: CorpusSpec, seed: int, device) -> Corpus:
    if spec.levels != 4:
        raise ValueError("the generator plants 3 hierarchy levels and a "
                         "leaf level: levels must be 4")
    g = generator(seed, 1, device)
    ctrs = torch.randn((3, spec.kary, spec.d), generator=g, device=device)
    ctrs *= torch.tensor(spec.scales, device=device)[:, None, None]
    pool = torch.randn((spec.pool_n, spec.d), generator=g,
                       device=device) * spec.eps
    cols = []
    for a in spec.zipf:
        p = 1.0 / torch.arange(1, spec.kary + 1, dtype=torch.float64,
                               device=device) ** a
        cdf = torch.cumsum(p / p.sum(), 0)
        u = torch.rand(spec.ndoc, generator=g, device=device,
                       dtype=torch.float64)
        cols.append(torch.searchsorted(cdf, u, right=True).clamp(
            max=spec.kary - 1))
    cols.append(torch.randint(0, spec.pool_n, (spec.ndoc,), generator=g,
                              device=device))
    draws = torch.stack(cols, 1).to(torch.int32)
    K = spec.kary
    d64 = draws.long()
    cluster = ((d64[:, 0] * K + d64[:, 1]) * K + d64[:, 2]) * K + d64[:, 3] % K
    return Corpus(spec, ctrs, pool, draws, cluster)


def gen_rows(corpus: Corpus, draws: torch.Tensor) -> torch.Tensor:
    """(n, 4) draws -> (n, d) unit-norm float32 rows."""
    dr = draws.to(corpus.ctrs.device).long()
    c = corpus.ctrs
    v = c[0][dr[:, 0]] + c[1][dr[:, 1]] + c[2][dr[:, 2]] + corpus.pool[dr[:, 3]]
    return v / torch.linalg.vector_norm(v.double(), dim=1,
                                        keepdim=True).float()


def fill_rows(corpus: Corpus, doc_order: torch.Tensor, dtype,
              chunk: int = 1 << 18) -> torch.Tensor:
    """The rows of documents ``doc_order`` (n,) in that order, as one
    ``(n rounded up to 8, d)`` buffer of ``dtype``, zero past ``n``."""
    n = doc_order.shape[0]
    dev = corpus.ctrs.device
    buf = torch.zeros((n + (-n) % 8, corpus.spec.d), dtype=dtype, device=dev)
    order = doc_order.to(dev).long()
    for s in range(0, n, chunk):
        rows = gen_rows(corpus, corpus.draws[order[s:s + chunk]])
        buf[s:s + rows.shape[0]] = rows.to(dtype)
    return buf


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def length_table(dist: Dict, n: int) -> np.ndarray:
    """``n`` query lengths, the same set for every seed.  ``dist``:
    ``{"kind": "fixed", "tokens"}``, every query ``tokens`` long."""
    if dist["kind"] != "fixed":
        raise ValueError(f"query length distribution {dist['kind']!r}")
    return np.full(n, dist["tokens"], np.int64)


@dataclasses.dataclass
class Queries:
    """``n`` queries padded to ``qlen``: ids and mask (n, qlen) int32,
    lengths (n,), and ``nb`` doc-weighted cluster picks a query, (n * nb,)
    int32, all on the device."""
    ids: torch.Tensor
    mask: torch.Tensor
    lengths: torch.Tensor
    cidx: torch.Tensor


def make_queries(corpus: Corpus, n: int, qlen: int, vocab: int,
                 length_dist: Dict, nb: int, seed: int, stream: int,
                 batch: int) -> Queries:
    """Tokens uniform over ``[0, vocab)``, lengths from ``length_dist``
    (the same set in every block of ``batch`` queries, shuffled by the
    seed), mask 1 over a query's length; each query's ``nb`` clusters are
    those of ``nb`` documents drawn uniformly (doc-weighted clusters: a
    random beam's own clusters are mostly empty)."""
    dev = corpus.ctrs.device
    g = generator(seed, stream, dev)
    ids = torch.randint(0, vocab, (n, qlen), generator=g, device=dev)
    table = torch.from_numpy(length_table(length_dist, batch)).to(dev)
    nblk = -(-n // batch)
    perm = torch.argsort(torch.rand((nblk, batch), generator=g, device=dev),
                         dim=1)
    lengths = table[perm].reshape(-1)[:n]
    mask = torch.arange(qlen, device=dev)[None, :] < lengths[:, None]
    ids = torch.where(mask, ids, torch.zeros_like(ids))
    docs = torch.randint(0, corpus.spec.ndoc, (n * nb,), generator=g,
                         device=dev)
    return Queries(ids.to(torch.int32), mask.to(torch.int32), lengths,
                   corpus.cluster[docs].to(torch.int32))


def slice_queries(q: Queries, lo: int, hi: int, nb: int) -> List[torch.Tensor]:
    """(ids, mask, cidx) of queries ``[lo, hi)``."""
    return [q.ids[lo:hi], q.mask[lo:hi], q.cidx[lo * nb:hi * nb]]
