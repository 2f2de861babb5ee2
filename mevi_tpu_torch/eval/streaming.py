"""Host-streaming search for corpora held in host memory (port of
``mevi_tpu.eval.streaming``).

* :func:`streaming_mips_topk` — exact MIPS top-k over a corpus that stays
  in host memory (numpy array, memmap or CPU tensor).  Fixed-size chunks
  go to the card through two pinned staging buffers and a copy stream:
  chunk j+1 is filled on the host and copied while chunk j is scored and
  merged into the running top-k on the compute stream
  (``ops.topk.merge_topk``).
* :class:`HostStreamFineReranker` — fine re-rank with the cluster-sorted
  matrix in host memory: per sub-batch, each (query, beam) bucket's rows
  (contiguous in CSR order) are sliced on the host into a
  (b, nb * cap, d) panel, staged the same way and scored on the card.
  Same call contract as :class:`..searcher.FineReranker`.

Scores are float32 sums of float32 products of the upcast values: int8
rows are cast as the JAX package casts them to the query's type, and a
float32 query is exact as with its ``HIGHEST`` precision.  That needs
TF32 off for float32 matrix products
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
Selection is stable everywhere: on tied scores the lower position wins,
as with ``lax.top_k``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..index.csr import pack_codes
from ..ops.topk import NEG_INF, merge_topk, topk_stable
from .searcher import HostCSR

# numpy has no bfloat16: such rows move as their 16-bit patterns
_BITS = {torch.bfloat16: torch.int16}
_NP_TYPES = {np.dtype(np.float32): torch.float32,
             np.dtype(np.int8): torch.int8}
_SCORE_BYTES = 1 << 28      # float32 panel rows upcast at a time


def host_rows(emb) -> Tuple[np.ndarray, torch.dtype]:
    """A host matrix as (numpy array of its rows' bits, torch dtype):
    a numpy array or memmap as it is (no copy), a CPU tensor through a
    numpy view of the same bytes."""
    if isinstance(emb, torch.Tensor):
        if emb.device.type != "cpu":
            raise ValueError(f"host matrix is on {emb.device}, not the CPU")
        return emb.view(_BITS.get(emb.dtype, emb.dtype)).numpy(), emb.dtype
    arr = np.asarray(emb)
    if arr.dtype not in _NP_TYPES:
        raise ValueError(f"host matrix dtype {arr.dtype} not supported")
    return arr, _NP_TYPES[arr.dtype]


class _Staging:
    """Host -> device copies of fixed-shape blocks through two pinned host
    buffers and a copy stream.  A host buffer is refilled only after the
    copy out of it has finished, and a device buffer is overwritten only
    after the compute stream has read it.  On the CPU: two plain buffers,
    used in place."""

    def __init__(self, shape, dtype, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(2)]
        self.bits = [h.view(_BITS.get(dtype, dtype)).numpy()
                     for h in self.host]
        if self.cuda:
            self.dev = [torch.empty(shape, dtype=dtype, device=device)
                        for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
        self.copied = [None, None]    # event: last copy out of host[i] done
        self.read = [None, None]      # event: last reader of dev[i] done

    def host_buffer(self, slot: int) -> np.ndarray:
        """``slot``'s host buffer (a numpy view of its bits), once the last
        async copy out of it has finished."""
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        return self.bits[slot]

    def ship(self, slot: int, n: int) -> torch.Tensor:
        """Start the copy of the first ``n`` rows of ``slot``'s host buffer
        to the card; returns their device view, to be read on the current
        stream after :meth:`wait`."""
        if not self.cuda:
            return self.host[slot][:n]
        with torch.cuda.stream(self.stream):
            if self.read[slot] is not None:
                self.stream.wait_event(self.read[slot])
            self.dev[slot][:n].copy_(self.host[slot][:n], non_blocking=True)
            self.copied[slot] = self.stream.record_event()
        return self.dev[slot][:n]

    def wait(self, slot: int):
        """The current stream waits for ``slot``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])

    def done(self, slot: int):
        """The work queued so far on the current stream is the last reader
        of ``slot``'s device buffer."""
        if self.cuda:
            self.read[slot] = torch.cuda.current_stream(
                self.device).record_event()


def _merge_chunk(run_s, run_i, q, block, start: int, k: int):
    """Score one corpus chunk and fold it into the running top-k."""
    scores = q.float() @ block.float().T
    ids = torch.arange(start, start + block.shape[0], dtype=torch.int32,
                       device=block.device)
    return merge_topk(run_s, run_i, scores, ids.expand(q.shape[0], -1), k)


@torch.inference_mode()
def streaming_mips_topk(query_emb, emb_host, k: int, chunk: int = 1 << 16,
                        device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact MIPS top-k over a host-resident corpus, streamed chunk-wise
    to ``device`` with double buffering.

    query_emb (nq, d) tensor or numpy (bf16/f32); emb_host (nd, d) numpy
    array, memmap or CPU tensor (f32/bf16/int8); ``chunk`` rows a copy.
    Returns (scores (nq, k) float32, row ids (nq, k) int32, -1 past nd)
    as numpy arrays."""
    dev = resolve_device(device)
    q = torch.as_tensor(query_emb).to(dev)
    bits, dtype = host_rows(emb_host)
    nd, d = bits.shape
    chunk = min(chunk, nd)
    run_s = torch.full((q.shape[0], k), NEG_INF, dtype=torch.float32,
                       device=dev)
    run_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev)
    stage = _Staging((chunk, d), dtype, dev)
    starts = list(range(0, nd, chunk))

    def put(j):
        s = starts[j]
        n = min(chunk, nd - s)
        stage.host_buffer(j % 2)[:n] = bits[s:s + n]
        return stage.ship(j % 2, n)

    cur = put(0)
    for j, s in enumerate(starts):
        nxt = put(j + 1) if j + 1 < len(starts) else None
        stage.wait(j % 2)
        run_s, run_i = _merge_chunk(run_s, run_i, q, cur, s, k)
        stage.done(j % 2)
        cur = nxt
    return run_s.cpu().numpy(), run_i.cpu().numpy()


def _bucket_score(q, panel, rows, k: int):
    """(b, d) x (b, m, d) -> per-query top-k over valid slots (row >= 0):
    (scores (b, k) f32, CSR rows (b, k), -1 invalid)."""
    b, m, d = panel.shape
    scores = torch.empty((b, m), dtype=torch.float32, device=panel.device)
    group = max(1, _SCORE_BYTES // (m * d * 4))
    qf = q.float()
    for i in range(0, b, group):
        scores[i:i + group] = torch.einsum(
            "bd,bcd->bc", qf[i:i + group], panel[i:i + group].float())
    scores = torch.where(rows >= 0, scores, torch.full_like(scores, NEG_INF))
    top, pos = topk_stable(scores, k)
    top_rows = torch.gather(rows, -1, pos)
    return top, torch.where(top <= NEG_INF / 2, torch.full_like(top_rows, -1),
                            top_rows)


class HostStreamFineReranker:
    """Fine re-rank with the cluster-sorted matrix in host memory.

    Per sub-batch, each (query, beam) bucket's member rows (contiguous in
    CSR order, at most ``cap``) are sliced on the host into a
    (b, nb * cap, d) panel in pinned memory, copied on a side stream while
    the previous sub-batch is scored, and scored in float32 on the card
    (the reference's per-cluster memmap -> device gather,
    ``main_models.py:3915-3991``, batched).  Clusters past ``cap`` are
    cut to their first ``cap`` rows.  Returns original doc ids.  The CSR
    is ``csr``, a :class:`..searcher.HostCSR`, proven at build.

    Host memory: two panels of ``sub_batch * nb * cap * d * itemsize``
    bytes (4 GB each for bf16 at cap 4096, 10 beams, d 768 and the
    default 64), and as much again on the card."""

    def __init__(self, sorted_emb_host, offsets, doc_ids, kary: int,
                 cap: int, pool: int, query_dtype=None, sub_batch: int = 64,
                 device="cuda"):
        self.device = resolve_device(device)
        self.emb, self.emb_dtype = host_rows(sorted_emb_host)
        self.csr = HostCSR(offsets, doc_ids, self.emb.shape[0], self.device)
        self.kary, self.cap, self.pool = kary, cap, pool
        self.sub_batch = sub_batch
        self.q_dt = query_dtype
        self._stages = None

    def _staging(self, shape):
        if self._stages is None or self._stages[0].host[0].shape != shape:
            self._stages = (_Staging(shape, self.emb_dtype, self.device),
                            _Staging(shape[:2], torch.int32, self.device))
        return self._stages

    @torch.inference_mode()
    def __call__(self, query_emb, beam_codes):
        """query_emb (B, d); beam_codes (B, nb, M) -> (scores (B, k),
        original doc ids (B, k), ndoc (B,)) as numpy arrays,
        k = min(pool, nb * cap)."""
        q_all = torch.as_tensor(query_emb).to(self.device)
        if self.q_dt is not None:
            q_all = q_all.to(self.q_dt)
        codes = np.asarray(torch.as_tensor(beam_codes).cpu())
        B, nb = codes.shape[:2]
        cap = self.cap
        starts, ends = self.csr.bounds(pack_codes(codes, self.kary))
        sizes = ends - starts
        k = min(self.pool, nb * cap)
        sub = min(self.sub_batch, B)
        panels, rows = self._staging((sub, nb * cap, self.emb.shape[1]))
        firsts = list(range(0, B, sub))

        def put(j):
            s0 = firsts[j]
            b = min(B, s0 + sub) - s0
            panel = panels.host_buffer(j % 2)
            rw = rows.host_buffer(j % 2)
            rw[:b] = -1
            for bi in range(b):
                for jj in range(nb):
                    st = int(starts[s0 + bi, jj])
                    n = min(int(sizes[s0 + bi, jj]), cap)
                    if n:
                        panel[bi, jj * cap:jj * cap + n] = self.emb[st:st + n]
                        rw[bi, jj * cap:jj * cap + n] = np.arange(st, st + n)
            return panels.ship(j % 2, b), rows.ship(j % 2, b)

        outs = []
        cur = put(0)
        for j, s0 in enumerate(firsts):
            nxt = put(j + 1) if j + 1 < len(firsts) else None
            panels.wait(j % 2)
            rows.wait(j % 2)
            panel_d, rows_d = cur
            outs.append(_bucket_score(q_all[s0:s0 + panel_d.shape[0]],
                                      panel_d, rows_d, k))
            panels.done(j % 2)
            rows.done(j % 2)
            cur = nxt
        out_s = torch.cat([o[0] for o in outs]).cpu().numpy()
        out_i = self.csr.ids(torch.cat([o[1] for o in outs]).cpu().numpy())
        return out_s, out_i, sizes.sum(-1)
