"""Tree-constrained beam search over the RQ code space (port of
``mevi_tpu.decode.beam``).

The decode tree is a full k-ary tree with an EOS leaf layer, so the tree
constraint is the model's compact (level slice + EOS) logits.  Scores
accumulate log-softmax over the valid set; every hypothesis has M code
tokens + EOS, so the final ``score / (M+1)**length_penalty`` is monotone.

Ties: ``lax.top_k`` and the stable ``jnp.argsort`` put the lower index
first; dead beams tie exactly at -1e9.  ``torch.topk`` promises no tie
order, so every selection here is a stable descending sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import device_constant
from ..models.nci import NCIT5, tokens_to_codes
from ..ops.topk import topk_stable as _topk_stable
from ..utils.timers import span


def _length_norm(M: int, length_penalty: float) -> torch.Tensor:
    return torch.tensor(float(M + 1)).pow(torch.tensor(length_penalty))


def _final_order(beam_scores, eos_lp, M: int, length_penalty: float):
    total = beam_scores + eos_lp
    norm = total / device_constant(_length_norm, M, float(length_penalty),
                                  device=total.device)
    order = torch.sort(-norm, dim=-1, stable=True).indices
    return torch.gather(norm, -1, order), order


def _row_index(B: int, nb: int, idx: torch.Tensor) -> torch.Tensor:
    base = torch.arange(B, device=idx.device)[:, None] * nb
    return (base + idx).reshape(-1)


@torch.inference_mode()
def nci_beam_search(model: NCIT5, input_ids, attention_mask,
                    num_beams: int, length_penalty: float = 0.8,
                    ) -> Tuple[torch.Tensor, ...]:
    """Panel beam decode (recomputes all L positions each step): the
    port's own oracle for :func:`nci_beam_search_incremental`.

    Returns (codes (b, nb, M), normalized scores (b, nb),
    enc_hidden (b, Lq, d), dec_hidden (b*nb, L, d))."""
    dims = model.dims
    K, M, L = dims.kary, dims.code_len, dims.max_output_length
    B = input_ids.shape[0]
    nb = num_beams
    dev = input_ids.device
    enc_hidden = model.encode(input_ids, attention_mask)
    memory, mem_mask, _ = model.build_memory(enc_hidden, attention_mask)
    kvs_b = [(k.repeat_interleave(nb, 0), v.repeat_interleave(nb, 0))
             for k, v in model.project_cross_kvs(memory)]
    mem_mask_b = (None if mem_mask is None
                  else mem_mask.repeat_interleave(nb, 0))
    tables = model.head_level_tables()
    tokens = torch.zeros((B * nb, L), dtype=torch.long, device=dev)
    beam_scores = torch.full((B, nb), -1e9, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0

    def step_logp(tokens, t):
        row, dec_hidden = model.compact_logits_at(
            tokens, t, None, mem_mask_b, kvs_b, level_tables=tables)
        return torch.log_softmax(row.float(), -1), dec_hidden

    for t in range(M):
        logp, _ = step_logp(tokens, t)
        flat = (beam_scores[:, :, None]
                + logp[:, :K].reshape(B, nb, K)).reshape(B, nb * K)
        beam_scores, pos = _topk_stable(flat, nb)
        rows = _row_index(B, nb, pos // K)
        tokens = tokens[rows]
        tokens[:, t + 1] = (pos % K + t * K + 2).reshape(-1)

    logp, dec_hidden = step_logp(tokens, M)
    norm, order = _final_order(beam_scores, logp[:, K].reshape(B, nb), M,
                               length_penalty)
    rows = _row_index(B, nb, order)
    tokens = tokens[rows]
    codes = tokens_to_codes(tokens[:, 1:M + 1], K).reshape(B, nb, M)
    return codes.to(torch.int32), norm, enc_hidden, dec_hidden[rows]


def _tree_rows(entry, rows):
    """Row-gather every (k, v) of a per-layer entry tuple."""
    return tuple((k[rows], v[rows]) for k, v in entry)


def _prefix_index(code_hist, p: int, K: int):
    """Base-K index of each row's code prefix (c0..c_{p-1})."""
    pidx = code_hist[:, 0]
    for j in range(1, p):
        pidx = pidx * K + code_hist[:, j]
    return pidx


@torch.inference_mode()
def nci_beam_search_incremental(model: NCIT5, input_ids, attention_mask,
                                num_beams: int, length_penalty: float = 0.8,
                                level_tables=None, pawa_tables=None,
                                ) -> Tuple[torch.Tensor, ...]:
    """KV-cached beam decode: each step runs one token through the
    decoder and PAWA; caches are per-position entry lists, beam-reordered
    by row gather.  Step 0 runs at B rows; the position-0 decoder entry
    stays at B rows and PAWA's at 1 row, broadcast inside attention and
    never reordered; cross K/V stay per query.

    ``level_tables``: ``head_level_tables()`` built once per params by a
    serving loop.  ``pawa_tables``: ``pawa_prefix_tables()`` output;
    PAWA is query-independent, so at the levels it covers its net and
    its delta matmul become per-prefix row gathers, and the net runs
    only at t = M-1 and the EOS step, its cache rebuilt from the
    per-prefix KV tables.  Returns (codes (b, nb, M) int32, normalized
    scores (b, nb), enc_hidden), identical to :func:`nci_beam_search`."""
    with span("beam"):
        dims = model.dims
        K, M = dims.kary, dims.code_len
        B = input_ids.shape[0]
        nb = num_beams
        dev = input_ids.device
        use_tables = pawa_tables is not None and dims.use_pawa
        with span("beam.encode"):
            enc_hidden = model.encode(input_ids, attention_mask)
            memory, mem_mask, _ = model.build_memory(enc_hidden,
                                                     attention_mask)
            cross_kvs = model.project_cross_kvs(memory)
            if level_tables is None:
                level_tables = model.head_level_tables()
            pawa_mem = (model.pawa.precompute_mem_kvs() if dims.use_pawa
                        else None)

        def step(tok, t, dec_entries, pawa_entries, beams, slab=None):
            with span("beam.step", t=t):
                logits, dec_e, pawa_e = model.decode_logits_step_unrolled(
                    tok, t, dec_entries, pawa_entries, cross_kvs, mem_mask,
                    beams=beams, level_tables=level_tables,
                    pawa_mem=pawa_mem, delta_slab=slab)
                return torch.log_softmax(logits.float(), -1), dec_e, pawa_e

        logp0, dec_e0, pawa_e0 = step(
            torch.zeros((B, 1), dtype=torch.long, device=dev), 0, [], [], 1,
            pawa_tables["delta0"] if use_tables else None)
        # exact original flat top-k: beam 0 alive at 0.0, the others at -1e9
        # (with nb > K the tail beams are the same dead hypotheses the panel
        # path produces)
        with span("beam.topk", t=0):
            init0 = torch.full((nb,), -1e9, dtype=torch.float32, device=dev)
            init0[0].fill_(0.0)          # no host scalar copied in
            flat0 = (init0[None, :, None]
                     + logp0[:, None, :K]).reshape(B, nb * K)
            beam_scores, pos0 = _topk_stable(flat0, nb)
            code_hist = torch.zeros((B * nb, M), dtype=torch.long,
                                    device=dev)
            code_hist[:, 0] = (pos0 % K).reshape(-1)
        cur_tok = code_hist[:, :1] + 2
        dec_entries = [dec_e0]
        if use_tables:
            pawa_entries = None          # rebuilt by gather at live steps
            skip_levels = set(pawa_tables["T"])
        else:
            pawa_entries = (None if pawa_e0 is None
                            else [_tree_rows(pawa_e0, slice(0, 1))])
            skip_levels = set()

        def rebuild_pawa(t, extra=None):
            """PAWA entries for positions 0..t-1 from the per-prefix KV
            tables at the current code history, the last one ``extra`` (the
            live entry of the net's run at t = M-1) when given."""
            ents = [pawa_tables["e0"]]
            top = t - 1 if extra is not None else t
            for p in range(1, top):
                ents.append(_tree_rows(pawa_tables["KV"][p],
                                       _prefix_index(code_hist, p, K)))
            if extra is not None:
                ents.append(extra)
            return ents

        pawa_live = None                 # reordered net entry at t = M-1
        for t in range(1, M):
            if t in skip_levels and t < M - 1:
                slab = pawa_tables["T"][t][_prefix_index(code_hist, t, K)]
                logp, dec_e, pawa_e = step(cur_tok, t, dec_entries, None, nb,
                                           slab)
            else:
                if use_tables:
                    pawa_entries = rebuild_pawa(t)
                logp, dec_e, pawa_e = step(cur_tok, t, dec_entries,
                                           pawa_entries, nb)
            with span("beam.topk", t=t):
                flat = (beam_scores[:, :, None]
                        + logp[:, :K].reshape(B, nb, K)).reshape(B, nb * K)
                beam_scores, pos = _topk_stable(flat, nb)
                code = (pos % K).reshape(-1)
                rows = _row_index(B, nb, pos // K)
                code_hist = code_hist[rows]
                code_hist[:, t] = code
            with span("beam.reorder", t=t):
                dec_entries = ([dec_entries[0]]
                               + [_tree_rows(e, rows)
                                  for e in dec_entries[1:]]
                               + [_tree_rows(dec_e, rows)])
                if use_tables:
                    if pawa_e is not None:
                        pawa_live = _tree_rows(pawa_e, rows)
                elif pawa_entries is not None:
                    pawa_entries = ([pawa_entries[0]]
                                    + [_tree_rows(e, rows)
                                       for e in pawa_entries[1:]]
                                    + [_tree_rows(pawa_e, rows)])
            cur_tok = code[:, None] + t * K + 2

        if use_tables:
            # positions 1..M-2 regathered at the final prefixes; M-1 is the
            # reordered live entry of the net run above
            pawa_entries = rebuild_pawa(M, pawa_live)
        logp, _, _ = step(cur_tok, M, dec_entries, pawa_entries, nb)
        norm, order = _final_order(beam_scores, logp[:, K].reshape(B, nb), M,
                                   length_penalty)
        codes = code_hist[_row_index(B, nb, order)].reshape(B, nb, M)
        return codes.to(torch.int32), norm, enc_hidden
