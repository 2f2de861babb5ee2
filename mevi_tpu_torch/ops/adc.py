"""ADC (asymmetric distance computation) top-k scan over RQ/PQ codes
(port of ``mevi_tpu.ops.adc``).

* build time: codes (n, M) -> a one-hot code matrix (n, M*K) int8 (for
  RQ 4x32, 128 bytes a document against 1,536 for a bf16 embedding);
* query time: per-level tables ``T[m, k] = <q, codebook[m, k]>`` (an
  (M*K, d) x (d, B) product), then ``scores = onehot @ T``, one
  (n, M*K) x (M*K, B) product per row chunk with a running top-k.

For inner product the decomposition is exact against the
reconstruction: ``<q, sum_m c_m> = sum_m <q, c_m>``.  Tables and
products are float32 on every device (the JAX package rounds the tables
to bf16 for its accelerator's matrix unit and keeps float32 on the CPU).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from .topk import chunk_ids_clamped, streaming_topk


def build_adc_codes(codes: np.ndarray, kary: int) -> np.ndarray:
    """(n, M) int codes -> (n, M*K) int8 one-hot code matrix (host)."""
    codes = np.asarray(codes)
    n, M = codes.shape
    out = np.zeros((n, M * kary), np.int8)
    rows = np.arange(n)
    for m in range(M):
        out[rows, m * kary + codes[:, m]] = 1
    return out


def adc_tables(qemb: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query level tables: (B, d) x (M, K, d) -> (M*K, B) float32."""
    M, K, d = codebooks.shape
    return codebooks.reshape(M * K, d).float() @ qemb.float().T


@torch.inference_mode()
def adc_topk(onehot: torch.Tensor, tables: torch.Tensor, k: int,
             chunk: int = 262144) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k by ADC scores: onehot (n, M*K) int8, tables
    (M*K, B) -> (scores (B, k) f32, doc ids (B, k) int64).  Ties keep
    the lower doc id first."""
    n = onehot.shape[0]
    B = tables.shape[1]
    chunk = min(chunk, n)
    num_chunks = -(-n // chunk)
    k = min(k, n)
    t = tables.float()

    def score_chunk(c):
        start, ids = chunk_ids_clamped(c, chunk, n, onehot.device)
        block = onehot[start:start + chunk].float()
        return (block @ t).T, ids                      # (B, chunk)

    return streaming_topk(score_chunk, num_chunks, k, (B,),
                          device=onehot.device)


def adc_search(qemb, codebooks, onehot, k: int, chunk: int = 262144,
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Tables + scan: qemb (B, d) -> (scores, ids) (B, k) on ``device``."""
    dev = resolve_device(device)
    tables = adc_tables(as_device_tensor(qemb, dev),
                        as_device_tensor(codebooks, dev))
    return adc_topk(as_device_tensor(onehot, dev), tables, k, chunk)


def fill_onehot_matrix(codes: np.ndarray, kary: int, chunk: int = 1 << 19,
                       device="cuda") -> torch.Tensor:
    """The (n, M*K) int8 one-hot code matrix made on the device from the
    host codes (which travel as int8: kary <= 127), chunk by chunk.
    Rows are padded to a multiple of ``chunk`` with zeros (no code
    set), as the JAX package's."""
    dev = resolve_device(device)
    if kary > 127:
        raise ValueError(f"kary {kary} > 127 does not travel as int8")
    codes = np.asarray(codes)
    n, M = codes.shape
    rows = -(-n // chunk) * chunk
    codes_dev = torch.from_numpy(codes.astype(np.int8)).to(dev)
    buf = torch.zeros((rows, M * kary), dtype=torch.int8, device=dev)
    view = buf.view(rows, M, kary)
    eye = torch.arange(kary, dtype=torch.int8, device=dev)
    for s in range(0, n, chunk):
        cd = codes_dev[s:s + chunk]
        view[s:s + cd.shape[0]] = (cd[:, :, None] == eye).to(torch.int8)
    return buf
