"""Analytic operation and byte counts from the configuration's shapes and
the inputs, and the chip's published peaks.  Nothing here reads what the
program dispatches, so a kernel or a fusion that replaces a product
changes no count.

A multiply-add is 2 operations.  Counted, per the inputs:

* an encoder over each query's real (unmasked) tokens: the q, k, v, o
  and feed-forward products per token, and attention over the query's
  own tokens (scores and context, ``4 * l * d`` per token);
* a query tower by its family's own count (``perfbench/towers/``); the
  T5 tower's decoder at its start token: self-attention and
  feed-forward over one row, cross-attention's q and o on that row, its
  k and v over the encoder's ``l`` states, attention over them;
* the NCI beam's ``M + 1`` decoder steps with a KV cache: step 0 over one
  row a query, steps 1..M over ``num_beams`` rows a query; per row a
  step, the decoder layers (self-attention over ``t + 1`` cached
  positions, cross-attention over the query's ``l`` states, whose k and
  v are projected once a query), the PAWA adaptor's layers (its
  cross-attention over the one memory vector is a constant, not a
  per-row product) and the level head as published: the tied head over
  ``K + 1`` columns and the adaptor delta, a ``(d) x (d, d (K + 1))``
  product contracted with the decoder state.

The bucket stage's least time reads each distinct valid corpus row of a
batch's windows once, the queries once, and writes the (G, cap) scores
and rows once; its operations are ``2 d`` per valid slot.
"""

from __future__ import annotations

import numpy as np

from . import lookup

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def encoder_layer_flops(l, d, d_ff):
    """One post- or pre-norm encoder layer over a query of ``l`` real
    tokens: 4 square products and the feed-forward a token, attention
    over the query."""
    return l * (8 * d * d + 4 * d * d_ff) + 4 * l * l * d


def t5_encoder_flops(lengths, c):
    return sum(c["num_layers"]
               * encoder_layer_flops(int(l), c["d_model"], c["d_ff"])
               for l in lengths)


def tower_flops(lengths, c):
    """The query tower over a batch with these real lengths: its
    family's count (``perfbench/towers/<family>.py``)."""
    return lookup.tower(c["family"]).flops(lengths, c)


def beam_flops(lengths, c, num_beams):
    """The NCI encoder and the cached beam over a batch."""
    d, ff, K, M = c["d_model"], c["d_ff"], c["kary"], c["code_len"]
    pw = c["pawa"]
    n = len(lengths)
    lsum = int(np.sum(lengths))
    total = t5_encoder_flops(lengths, c)
    total += c["num_decoder_layers"] * 4 * lsum * d * d     # cross k, v
    head = 2 * d * (K + 1) + 2 * d * d * (K + 1) + 2 * d * (K + 1)
    for t in range(M + 1):
        rows = n if t == 0 else n * num_beams
        # per query l: cross attention of each row over l states
        cross_att = (1 if t == 0 else num_beams) * 4 * lsum * d
        dec_row = 8 * d * d + 4 * (t + 1) * d + 4 * d * d + 4 * d * ff
        pawa_row = 8 * d * d + 4 * (t + 1) * d + 4 * d * pw["d_ff"]
        total += c["num_decoder_layers"] * (rows * dec_row + cross_att)
        total += pw["num_layers"] * rows * pawa_row
        total += rows * head
    return total


def bucket_counts(cidx, offsets, cap, align, d, itemsize):
    """(bytes, operations) of the bucket stage over one batch's clusters
    ``cidx`` (G,), with CSR ``offsets`` (C + 1,) host arrays."""
    s = offsets[cidx]
    e = offsets[cidx + 1]
    al = s // align * align
    hi = np.minimum(e, al + cap)
    valid = np.maximum(hi - s, 0)
    # distinct valid rows: the union of the intervals [s, hi)
    iv = np.stack([s, hi], 1)[valid > 0]
    distinct = 0
    if len(iv):
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        reach = np.maximum.accumulate(iv[:, 1])
        starts = np.maximum(iv[:, 0], np.concatenate([[iv[0, 0]],
                                                      reach[:-1]]))
        distinct = int(np.maximum(iv[:, 1] - starts, 0).sum())
    G = len(cidx)
    nbytes = distinct * d * itemsize + G * d * itemsize + G * cap * (4 + 4)
    return nbytes, 2 * d * int(valid.sum())


def least_seconds(nbytes, flops):
    return max(nbytes / H100_HBM_BYTES_PER_S, flops / H100_BF16_FLOPS)
