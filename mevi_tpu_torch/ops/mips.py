"""Exact MIPS top-k over a device-resident document matrix (port of
``mevi_tpu.ops.mips``): a chunked ``q @ Dᵀ`` (a plain matrix product,
left to ``torch.matmul``) with a running top-k, so the full (nq, ndoc)
score matrix never exists; ``sharded_mips_topk`` runs it on each corpus
shard of a mesh and merges the shards' candidates by an all-gather."""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.mesh import CORPUS_AXIS, Mesh, all_gather_list
from .topk import NEG_INF, streaming_topk, topk_stable


def _scores(queries, docs, dist_mode: str):
    """(nq, d) x (nd, d) -> (nq, nd) float32 similarity.  Inputs are
    upcast to float32 first: products of bf16 / int8 values are exact
    there, which is what the JAX package's f32-accumulating dot gives."""
    q = queries.float()
    dd = docs.float()
    ip = q @ dd.T
    if dist_mode == "ip":
        return ip
    return 2.0 * ip - q.square().sum(-1, keepdim=True) - \
        dd.square().sum(-1)[None, :]


@torch.inference_mode()
def mips_topk(queries: torch.Tensor, docs: torch.Tensor, k: int,
              chunk: int = 8192, dist_mode: str = "ip",
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: (scores (nq, k) f32, row ids (nq, k) int64)."""
    nq = queries.shape[0]
    nd = docs.shape[0]
    chunk = min(chunk, nd)
    k = min(k, nd)
    num_chunks = -(-nd // chunk)

    def score_chunk(c):
        s = c * chunk
        block = docs[s:s + chunk]
        ids = torch.arange(s, s + block.shape[0], device=docs.device)
        return _scores(queries, block, dist_mode), ids

    return streaming_topk(score_chunk, num_chunks, k, (nq,),
                          device=queries.device)


@torch.inference_mode()
def sharded_mips_topk(queries: torch.Tensor, docs_shard: torch.Tensor,
                      k: int, mesh: Mesh, n_rows: int, chunk: int = 8192,
                      dist_mode: str = "ip",
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus row-sharded across the ``corpus`` axis.

    ``docs_shard``: this rank's rows of the (padded) corpus, shard ``i``
    holding global rows ``[i * rows_per, (i + 1) * rows_per)`` (as
    :func:`~mevi_tpu_torch.parallel.mesh.shard_rows` lays them out);
    ``n_rows``: the real rows of the corpus.  ``queries``: this rank's
    data slice.  Each shard's top-k (global ids) is gathered over the
    corpus group, shard-major as ``lax.all_gather`` lays it out, and
    merged by a stable top-k, so ties go to the lower shard.  Returns
    (scores (nq, k) f32, ids (nq, k) int64) for this rank's queries.

    Pad rows (at or past ``n_rows``) are never scored: the JAX function
    scores the zero pad rows (0) and can return their ids, which lie past
    the corpus; here every slot a shard cannot fill is -1e30 with id -1.
    """
    rows_per = docs_shard.shape[0]
    lo = mesh.index(CORPUS_AXIS) * rows_per
    real = max(0, min(rows_per, n_rows - lo))
    nq = queries.shape[0]
    scores = torch.full((nq, k), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    ids = torch.full((nq, k), -1, dtype=torch.int64, device=queries.device)
    if real:
        s, i = mips_topk(queries, docs_shard[:real], k, chunk, dist_mode)
        scores[:, :s.shape[1]] = s
        ids[:, :i.shape[1]] = torch.where(i >= 0, i + lo, i)
    return merge_shards(scores, ids, mesh, k)


def merge_shards(scores, ids, mesh: Mesh, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every corpus shard's candidates (nq, m) gathered over the corpus
    group, shard-major as ``lax.all_gather`` lays them out, then a stable
    top-k (ties go to the lower shard); ids -1 where the score is at or
    below ``NEG_INF / 2``."""
    all_s = torch.cat(all_gather_list(scores, mesh, CORPUS_AXIS), -1)
    all_i = torch.cat(all_gather_list(ids, mesh, CORPUS_AXIS), -1)
    top, pos = topk_stable(all_s, k)
    top_ids = torch.gather(all_i, -1, pos)
    return top, torch.where(top <= NEG_INF / 2,
                            torch.full_like(top_ids, -1), top_ids)
