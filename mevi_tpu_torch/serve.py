"""Serving pipeline (port of ``mevi_tpu.serve``):

    query tokens -> T5 tower embedding (first_token_rep)
                 -> NCI tree-constrained beam (coarse clusters)
                 -> CSR bucket fine stage (hand-written CUDA kernel)
                 -> per-query pool top-k -> host doc-id map

``serve_batch`` is the all-torch reference server (plain gather fine
stage over the unaligned ``[s, s + cap)`` window); ``BucketServer`` is
the counterpart of ``PallasServer`` and scores through the bucket kernel
with the TPU contract's aligned window (``align=8``), so its outputs
equal ``PallasServer``'s.  ``ShardedBucketServer`` is the multi-device
server (``make_sharded_server``): queries sharded over the mesh's data
axis, the corpus over its corpus axis.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .decode.beam import nci_beam_search_incremental
from .decode.beam_graph import BeamGraph
from .eval.searcher import (FineIndex, HostCSR, _beam_scores, merge_pool,
                            shard_pool)
from .index.csr import pack_codes
from .models.nci import NCIT5
from .models.t5 import T5Model
from .ops.bucket import ALIGN, CIDX_ERROR, bucket_scores_v3
from .parallel.mesh import DATA_AXIS, Mesh, gather_rows
from .utils.timers import count, new_batch, span


def _query_dtype(corpus_dtype):
    """int8 corpus: queries stay float (bf16, as the JAX server)."""
    return torch.bfloat16 if corpus_dtype == torch.int8 else corpus_dtype


@torch.inference_mode()
def serve_batch(qtower: T5Model, nci: NCIT5, query_ids, query_mask,
                offsets, doc_ids, sorted_emb, num_beams: int = 10,
                cap: int = 512, pool: int = 1000,
                length_penalty: float = 0.8, rank: str = "score"):
    """Returns (doc scores (b, pool), doc ids (b, pool), beam codes
    (b, nb, M), beam scores (b, nb)) as tensors.  ``rank``: see
    ``merge_pool``."""
    qemb = qtower.first_token_rep(query_ids, query_mask)
    codes, beam_scores, _ = nci_beam_search_incremental(
        nci, query_ids, query_mask, num_beams, length_penalty)
    scores, ids, _ = _beam_scores(
        qemb.to(_query_dtype(sorted_emb.dtype)), codes, offsets, doc_ids,
        sorted_emb, nci.dims.kary, cap)
    top_scores, top_ids = merge_pool(scores, ids, num_beams, cap, pool, rank)
    return top_scores, top_ids, codes, beam_scores


class Handle(tuple):
    """:meth:`BucketServer.query_device`'s result, unpacked as (top
    scores, top CSR rows, beam codes, beam scores) on the device.
    ``fault``: a 0-dim bool device tensor, true if a cluster id of the
    batch lay outside the CSR (:meth:`BucketServer.finalize` then
    raises); ``batch``: the batch id of its spans (None while spans are
    off), which ``finalize`` gives its own.  Built, it queues copies of
    the four tensors and ``fault`` into pinned host memory (``host``)
    behind the work queued so far, and records the CUDA event ``ready``
    after them; on the CPU ``host`` holds the tensors themselves and
    ``ready`` is None."""

    def __new__(cls, outs, fault, batch=None):
        self = super().__new__(cls, outs)
        self.fault, self.batch = fault, batch
        self.host, self.ready = (*outs, fault), None
        if fault.device.type == "cuda":
            self.host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in self.host)
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(fault.device))
        return self


class BucketServer:
    """Three-stage server: (1) query tower + NCI beam + cluster ids,
    (2) the v3 bucket kernel, (3) per-query pool top-k; ``finalize``
    maps CSR rows to original doc ids on the host.

    ``inv_scale``: dequantization factor of an int8 corpus, folded into
    the query rows so scores stay calibrated.  ``rank_mode``: "score" or
    "beam_major" (see ``merge_pool``).  The window is the TPU contract's
    (``align=8``).  ``csr``: the index's ``eval.searcher.HostCSR``,
    proven at build, so each batch checks only its cluster ids, on the
    device.

    ``pawa_tables`` (off by default, as ``MEVI_PAWA_TABLES`` in the JAX
    server): build ``NCIT5.pawa_prefix_tables`` once, next to the head
    tables, so the beam replaces PAWA's net and delta matmul at levels
    1..M-2 by per-prefix row gathers.  When ``kary^(M-2)`` exceeds the
    tables' entry limit the server says so on stderr, serves through the
    plain beam and leaves ``self.pawa_tables`` None.

    On CUDA the beam replays from one CUDA graph per batch shape
    (``decode.beam_graph.BeamGraph``); elsewhere it runs eagerly."""

    def __init__(self, qtower: T5Model, nci: NCIT5, index: FineIndex,
                 num_beams: int = 10, cap: int = 512, pool: int = 1000,
                 length_penalty: float = 0.8, inv_scale: float = 1.0,
                 rank_mode: str = "score", pawa_tables: bool = False,
                 device="cuda"):
        if rank_mode not in ("score", "beam_major"):
            raise ValueError(rank_mode)
        self.device = resolve_device(device)
        self.qtower, self.nci = qtower, nci
        self.num_beams, self.cap, self.pool = num_beams, cap, pool
        self.length_penalty = length_penalty
        self.rank_mode = rank_mode
        self.kary = nci.dims.kary
        self.M = nci.dims.code_len
        self.sorted_emb = index.sorted_emb
        if self.sorted_emb.device.type != self.device.type:
            raise ValueError(f"index is on {self.sorted_emb.device}")
        self.csr = HostCSR.of(index, self.device)
        self.q_dt = _query_dtype(self.sorted_emb.dtype)
        self.inv_scale = torch.tensor(inv_scale, dtype=self.q_dt,
                                      device=self.device)
        # per-level head tables built once per params (the adaptor slab
        # is (L, dm, dm*(K+1)), ~233 MB in bf16 at full width)
        with torch.inference_mode():
            self.level_tables = nci.head_level_tables()
        self.pawa_tables = None
        if pawa_tables and nci.dims.use_pawa:
            try:
                with torch.inference_mode():
                    self.pawa_tables = nci.pawa_prefix_tables(
                        self.level_tables)
            except ValueError as e:
                print(f"BucketServer: PAWA prefix tables disabled: {e}",
                      file=sys.stderr)
        # the beam looked up at each call, so that a patch of this
        # module's name reaches the server
        self.beam = BeamGraph(
            lambda *a, **k: nci_beam_search_incremental(*a, **k),
            nci, num_beams, length_penalty, level_tables=self.level_tables,
            pawa_tables=self.pawa_tables)

    @torch.inference_mode()
    def coarse(self, query_ids, query_mask):
        """Stage 1: (codes (B, nb, M), beam scores (B, nb), cidx (B*nb,)
        int32, q_rep (B*nb, d))."""
        with span("serve.coarse"):
            with span("tower"):
                qemb = self.qtower.first_token_rep(query_ids, query_mask)
            codes, beam_scores = self.beam(query_ids, query_mask)
            cidx = pack_codes(codes.reshape(-1, self.M), self.kary)
            q_rep = (qemb.to(self.q_dt) * self.inv_scale).repeat_interleave(
                self.num_beams, 0).contiguous()
        return codes, beam_scores, cidx, q_rep

    @torch.inference_mode()
    def bucket(self, cidx, q_rep):
        """Stage 2: the bucket kernel -> (scores, rows), each (G, cap),
        and ``fault``, a 0-dim bool device tensor: true if an id of
        ``cidx`` lay outside ``[0, C)``.  Such ids are clamped into it
        before any read, and the CSR was checked at build, so the kernel
        reads only corpus rows; nothing waits for the device."""
        with span("serve.bucket"):
            count("serve.cidx_check")
            cl = cidx.clamp(0, self.csr.nclusters - 1)
            fault = (cl != cidx).any()
            ci = cl.long()
            off = self.csr.offsets_d
            scores, rows = bucket_scores_v3(
                self.sorted_emb, off[ci], off[ci + 1], q_rep, self.cap,
                ALIGN, device=self.device, host_check=False)
            return scores, rows, fault

    @torch.inference_mode()
    def pool_topk(self, scores, rows, B: int):
        """Stage 3: per-query pool -> (top scores, top CSR rows)."""
        with span("serve.pool"):
            return merge_pool(scores.reshape(B, -1), rows.reshape(B, -1),
                              self.num_beams, self.cap, self.pool,
                              self.rank_mode)

    def query_device(self, query_ids, query_mask,
                     cidx_override: Optional[torch.Tensor] = None):
        """Device half: the three stages, queued on the device with no
        host sync (once a batch shape's beam is captured), so the host
        can finalize the batch before while they run; results stay on
        the device.  ``cidx_override`` (at least B*nb int32 cluster ids,
        extra rows ignored) replaces the beam's clusters, to drive the
        bucket stage with occupied clusters when the NCI weights are
        random.  Returns a :class:`Handle` for :meth:`finalize`, which
        raises if a cluster id lay outside the CSR."""
        B = query_ids.shape[0]
        batch = new_batch()
        with span("serve.query_device", batch=batch):
            codes, beam_scores, cidx, q_rep = self.coarse(query_ids,
                                                          query_mask)
            if cidx_override is not None:
                cidx = cidx_override[:B * self.num_beams].to(
                    self.device, torch.int32).contiguous()
            scores, rows, fault = self.bucket(cidx, q_rep)
            top_scores, top_rows = self.pool_topk(scores, rows, B)
            # the host copies are queued behind this batch's own work: a
            # fetch made at finalize would wait behind the next batch's
            return Handle((top_scores, top_rows, codes, beam_scores), fault,
                          batch)

    def finalize(self, handle: Handle):
        """Host half: fetch, map CSR rows to doc ids.  Returns (doc
        scores (B, pool), original doc ids (B, pool), beam codes
        (B, nb, M), beam scores (B, nb), ndoc (B,)) as numpy arrays.
        Raises ``ValueError`` before mapping if the handle's ``fault``
        is set."""
        with span("serve.finalize", batch=handle.batch):
            with span("finalize.fetch"):
                if handle.ready is not None:
                    handle.ready.synchronize()
                *outs, fault = handle.host
                top_scores, top_rows, codes, beam_scores = (
                    t.numpy() for t in outs)
                if fault.item():
                    raise ValueError(CIDX_ERROR)
            with span("finalize.map"):
                s, e = self.csr.bounds(pack_codes(codes, self.kary))
                return (top_scores.astype(np.float32),
                        self.csr.ids(top_rows), codes.astype(np.int32),
                        beam_scores.astype(np.float32), (e - s).sum(-1))

    def query(self, query_ids, query_mask):
        """Returns (doc scores (B, pool), original doc ids (B, pool),
        beam codes (B, nb, M), beam scores (B, nb), ndoc (B,))."""
        return self.finalize(self.query_device(query_ids, query_mask))


class ShardedBucketServer:
    """Multi-device server (``serve.make_sharded_server``): each rank runs
    the query tower and the NCI beam on its data slice of the batch (head
    tables built once, as :class:`BucketServer`), then the fine stage over
    its corpus shard through the v3 kernel (``align=1``, the JAX
    function's unaligned window), merged over the corpus group
    (``eval.searcher.shard_pool``).

    ``index_shard``: global offsets and doc ids with this rank's rows of
    the cluster-sorted matrix as ``sorted_emb`` (``parallel.mesh.
    shard_rows``).  An int8 shard is scored with bf16 queries, as the JAX
    server casts them.  Like the JAX sharded server it has no
    ``inv_scale``, ``rank_mode``, PAWA prefix tables or override."""

    def __init__(self, qtower: T5Model, nci: NCIT5, mesh: Mesh,
                 index_shard: FineIndex, num_beams: int = 10, cap: int = 512,
                 pool: int = 1000, length_penalty: float = 0.8):
        self.mesh, self.device = mesh, mesh.device
        self.qtower, self.nci = qtower, nci
        self.num_beams, self.cap, self.pool = num_beams, cap, pool
        self.length_penalty = length_penalty
        self.kary = nci.dims.kary
        self.index = index_shard
        if index_shard.sorted_emb.device != self.device:
            raise ValueError(f"shard is on {index_shard.sorted_emb.device}, "
                             f"not {self.device}")
        self.q_dt = _query_dtype(index_shard.sorted_emb.dtype)
        with torch.inference_mode():
            self.level_tables = nci.head_level_tables()

    @torch.inference_mode()
    def coarse(self, query_ids, query_mask):
        """Tower + beam on this rank's queries: (query reps (b, d) in the
        scoring dtype, codes (b, nb, M), beam scores (b, nb))."""
        qemb = self.qtower.first_token_rep(query_ids, query_mask)
        codes, beam_scores, _ = nci_beam_search_incremental(
            self.nci, query_ids, query_mask, self.num_beams,
            self.length_penalty, level_tables=self.level_tables)
        return qemb.to(self.q_dt), codes, beam_scores

    def fine(self, qemb, codes):
        """The sharded fine stage: (scores (b, k), doc ids (b, k))."""
        return shard_pool(qemb, codes, self.index.offsets,
                          self.index.doc_ids, self.index.sorted_emb,
                          self.mesh, self.kary, self.cap, self.pool,
                          self.device)

    def __call__(self, query_ids, query_mask):
        """This rank's data slice of a batch -> (scores (b, k), doc ids
        (b, k), codes (b, nb, M), beam scores (b, nb)) on the device,
        equal on every rank of the corpus group."""
        qemb, codes, beam_scores = self.coarse(query_ids, query_mask)
        scores, ids = self.fine(qemb, codes)
        return scores, ids, codes, beam_scores


@torch.inference_mode()
def gather_batch(outputs, mesh: Mesh):
    """Every data rank's slice of a batch's outputs, concatenated in
    data order: the whole batch, on every rank."""
    return tuple(gather_rows(t, mesh, DATA_AXIS) for t in outputs)
