"""Exhaustive code-sequence scorer, the ``_generate_all`` oracle (port of
``mevi_tpu.decode.brute``).

The reference scores all K^M code sequences level by level in
sub-batches (``generation_utils.py:1013-1136``) for its topic-model
mode; here it is also the oracle of the beam searches.

Scoring matches the beam: the sum over levels of log-softmax(level slice
and EOS) at the code token, plus the final EOS log-prob, normalized by
``(M+1)**length_penalty``.
"""

from __future__ import annotations

from itertools import product
from typing import Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from ..models.nci import NCIDims, NCIT5, make_labels


def all_code_sequences(kary: int, levels: int) -> np.ndarray:
    """(K^M, M) int32: every code sequence, in lexicographic order."""
    return np.array(list(product(range(kary), repeat=levels)),
                    np.int32).reshape(-1, levels)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each query's rows repeated ``n`` times (a broadcast view for one
    query: no copy of its cross-attention K/V per block)."""
    if x.shape[0] == 1:
        return x.expand(n, *x.shape[1:])
    return x.repeat_interleave(n, 0)


@torch.inference_mode()
def score_sequences(model: NCIT5, input_ids, attention_mask, codes,
                    length_penalty: float = 0.8, batch: int = 1024,
                    device="cuda") -> torch.Tensor:
    """Log-prob score of each code sequence for each query, blocks of
    ``batch`` sequences tiled over the queries.  Returns (nq, n_seq)
    float32 normalized scores on ``device``."""
    dev = resolve_device(device)
    dims: NCIDims = model.dims
    K, M, L = dims.kary, dims.code_len, dims.max_output_length
    ids = as_device_tensor(input_ids, dev)
    mask = as_device_tensor(attention_mask, dev)
    codes = as_device_tensor(codes, dev).to(torch.int32)
    nq = ids.shape[0]
    enc_hidden = model.encode(ids, mask)
    memory, mem_mask, _ = model.build_memory(enc_hidden, mask)
    cross_kvs = model.project_cross_kvs(memory)
    norm = torch.tensor(float(M + 1)).pow(torch.tensor(float(length_penalty)))

    outs = []
    for s in range(0, codes.shape[0], batch):
        block = codes[s:s + batch]
        nb = block.shape[0]
        _, dec_in = make_labels(block, K, L)
        dec = dec_in.repeat(nq, 1)                       # (nq * nb, L)
        kvs = [(_rows(k, nb), _rows(v, nb)) for k, v in cross_kvs]
        mm = None if mem_mask is None else _rows(mem_mask, nb)
        compact, _ = model.compact_logits(dec, None, mm, kvs)
        logp = torch.log_softmax(compact.float(), -1)
        cols = torch.cat([block.repeat(nq, 1),
                          torch.full((nq * nb, 1), K, dtype=torch.int32,
                                     device=dev)], 1).long()   # EOS column
        steps = torch.gather(logp[:, :M + 1, :], 2, cols[:, :, None])[..., 0]
        outs.append(steps.sum(1).reshape(nq, nb) / norm.to(dev))
    return torch.cat(outs, 1)


def brute_force_topk(model: NCIT5, input_ids, attention_mask, k: int,
                     length_penalty: float = 0.8, batch: int = 1024,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k code sequences by exhaustive scoring (a stable sort:
    on ties the lexicographically lower sequence first).  Returns (codes
    (nq, k, M) int32, scores (nq, k) float32) on the host."""
    dims: NCIDims = model.dims
    codes = all_code_sequences(dims.kary, dims.code_len)
    scores = score_sequences(model, input_ids, attention_mask, codes,
                             length_penalty, batch, device).cpu().numpy()
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return codes[order], np.take_along_axis(scores, order, axis=1)
