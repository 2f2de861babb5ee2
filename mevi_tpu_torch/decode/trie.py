"""Trie-constrained beam search, the non-RQ (hierarchical k-means id)
mode (port of ``mevi_tpu.decode.trie``).

The reference supports variable-length document ids from hierarchical
k-means (``--id_class bert_k30_c30_1``) and walks a python trie per beam
per step (``generation_utils.py:801-819``).  Here the trie is two dense
tables:

* ``child[node, c]``: child node id for code c, -1 if absent,
* ``terminal[node]``: True when a document id ends at this node (EOS
  is then a legal next token),

and the beam is a fixed-depth loop: alive beams extend through
``child``; EOS-taking beams move to a per-query done-pool ranked by the
length-penalized score (``BeamHypotheses``: every hypothesis normalized
by ``(steps + 1) ** length_penalty``).  Each step runs the decoder panel
over all positions (``NCIT5.compact_logits_at``), as the JAX package
does.  Selection is a stable descending sort (``lax.top_k``'s tie
order: the lower index first).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from ..models.nci import NCIT5
from ..ops.topk import topk_stable

NEG = -1e9


def build_trie(ids: Sequence[Sequence[int]], kary: int,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense trie tables from document id sequences.

    Returns (child (num_nodes, kary) int32 with -1 absent,
    terminal (num_nodes,) bool).  Node 0 is the root.
    """
    child_rows: List[np.ndarray] = [np.full(kary, -1, np.int32)]
    terminal: List[bool] = [False]
    for seq in ids:
        node = 0
        for c in seq:
            nxt = child_rows[node][c]
            if nxt < 0:
                nxt = len(child_rows)
                child_rows[node][c] = nxt
                child_rows.append(np.full(kary, -1, np.int32))
                terminal.append(False)
            node = int(nxt)
        terminal[node] = True
    return np.stack(child_rows), np.asarray(terminal, bool)


@torch.inference_mode()
def trie_beam_search(model: NCIT5, input_ids, attention_mask, child,
                     terminal, num_beams: int, max_steps: int,
                     length_penalty: float = 0.8, device="cuda",
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-decode ids constrained to the trie ``(child, terminal)`` of
    :func:`build_trie`.

    Returns (codes (b, nbeam, max_steps) int32 with -1 past each id's
    end, lengths (b, nbeam) int32, normalized scores (b, nbeam)), on
    ``device``."""
    dev = resolve_device(device)
    dims = model.dims
    K, L = dims.kary, dims.max_output_length
    if max_steps > L - 1:
        raise ValueError(f"max_steps {max_steps} > max_output_length - 1")
    ids = as_device_tensor(input_ids, dev)
    mask = as_device_tensor(attention_mask, dev)
    child = as_device_tensor(child, dev).long()
    terminal = as_device_tensor(terminal, dev).bool()
    B, nb = ids.shape[0], num_beams

    enc_hidden = model.encode(ids, mask)
    memory, mem_mask, _ = model.build_memory(enc_hidden, mask)
    kvs_b = [(k.repeat_interleave(nb, 0), v.repeat_interleave(nb, 0))
             for k, v in model.project_cross_kvs(memory)]
    mem_mask_b = (None if mem_mask is None
                  else mem_mask.repeat_interleave(nb, 0))
    tables = model.head_level_tables()

    f32 = dict(dtype=torch.float32, device=dev)
    tokens = torch.zeros((B * nb, L), dtype=torch.long, device=dev)
    nodes = torch.zeros((B, nb), dtype=torch.long, device=dev)
    beam_scores = torch.full((B, nb), NEG, **f32)
    beam_scores[:, 0] = 0.0
    done_scores = torch.full((B, nb), NEG, **f32)
    done_tokens = torch.zeros((B, nb, L), dtype=torch.long, device=dev)
    done_len = torch.zeros((B, nb), dtype=torch.long, device=dev)
    neg = torch.tensor(NEG, **f32)
    rows_base = torch.arange(B, device=dev)[:, None] * nb

    for t in range(max_steps):
        row, _ = model.compact_logits_at(tokens, t, None, mem_mask_b, kvs_b,
                                         level_tables=tables)
        logp = torch.log_softmax(row.float(), -1).reshape(B, nb, K + 1)
        kids = child[nodes]                            # (B, nb, K)
        code_lp = torch.where(kids >= 0, logp[..., :K], neg)
        eos_lp = torch.where(terminal[nodes], logp[..., K], neg)

        # EOS candidates -> the done pool, normalized like BeamHypotheses
        norm = (beam_scores + eos_lp) / torch.tensor(
            float(t + 1), **f32).pow(torch.tensor(float(length_penalty),
                                                  **f32))
        pool_scores = torch.cat([done_scores, norm], 1)
        pool_tokens = torch.cat([done_tokens, tokens.reshape(B, nb, L)], 1)
        pool_len = torch.cat([done_len, torch.full_like(done_len, t)], 1)
        done_scores, keep = topk_stable(pool_scores, nb)
        done_tokens = torch.gather(pool_tokens, 1,
                                   keep[:, :, None].expand(B, nb, L))
        done_len = torch.gather(pool_len, 1, keep)

        # the non-EOS candidates continue
        flat = (beam_scores[:, :, None] + code_lp).reshape(B, nb * K)
        beam_scores, pos = topk_stable(flat, nb)
        nodes = torch.gather(kids.reshape(B, nb * K), 1, pos)
        tokens = tokens[(rows_base + pos // K).reshape(-1)]
        tokens[:, t + 1] = (pos % K + t * K + 2).reshape(-1)

    order = torch.sort(-done_scores, dim=1, stable=True).indices
    done_scores = torch.gather(done_scores, 1, order)
    done_tokens = torch.gather(done_tokens, 1,
                               order[:, :, None].expand(B, nb, L))
    done_len = torch.gather(done_len, 1, order)

    # tokens back to codes, -1 past each id's end
    offs = torch.arange(max_steps, device=dev) * K + 2
    codes = done_tokens[:, :, 1:max_steps + 1] - offs
    slot = torch.arange(max_steps, device=dev)
    codes = torch.where(slot[None, None, :] < done_len[:, :, None], codes,
                        torch.full_like(codes, -1))
    return (codes.to(torch.int32), done_len.to(torch.int32), done_scores)
