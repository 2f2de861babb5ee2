"""The analytic counts against what the port dispatches and a brute
count."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, harness, weights
from perfbench.tests.tiny import FAMILIES, tiny

# FlopCounterMode counts the products the port dispatches.  The counts
# differ from it by the context products of the cached decode steps'
# attention, which the port forms elementwise (not counted there) and
# which are counted here: 0.25% of the beam at these widths, 0.02% of
# the T5 tower, none of BERT's.
MARGIN = 0.01


def _program(family):
    cell, cfg = tiny("marco.b512", family)
    cfg["dtype"] = "float32"
    from perfbench import data
    corpus = data.make_corpus(data.CorpusSpec.from_config(cfg), 5,
                              torch.device("cpu"))
    server, tap = harness.build_program(cfg, 5, corpus, torch.device("cpu"))
    return cfg, server, tap


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("family", FAMILIES)
def test_tower_flops_match_the_dispatched_products(family):
    cfg, server, tap = _program(family)
    L = cfg["serving"]["query_length"]
    ids = torch.randint(0, 100, (6, L))
    mask = torch.ones_like(ids)
    got = _flops(lambda: tap.rep(ids, mask))
    want = counts.tower_flops([L] * 6, cfg["tower"])
    assert abs(want - got) <= MARGIN * got, (want, got)


def test_beam_flops_match_the_dispatched_products():
    from mevi_tpu_torch.decode.beam import nci_beam_search_incremental
    cfg, server, tap = _program("t5")
    L = cfg["serving"]["query_length"]
    nb = cfg["serving"]["num_beams"]
    ids = torch.randint(0, 100, (6, L))
    mask = torch.ones_like(ids)
    got = _flops(lambda: nci_beam_search_incremental(
        server.nci, ids, mask, nb, level_tables=server.level_tables))
    want = counts.beam_flops([L] * 6, cfg["nci"], nb)
    assert abs(want - got) <= MARGIN * got, (want, got)


def test_bucket_bytes_match_a_brute_count():
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 40, 300)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    cidx = rng.integers(0, 300, 90)
    cap, align, d, item = 16, 8, 32, 2
    rows, valid = set(), 0
    for c in cidx:
        s, e = offsets[c], offsets[c + 1]
        al = s // align * align
        for j in range(cap):
            if s <= al + j < e:
                rows.add(al + j)
                valid += 1
    nbytes, flops = counts.bucket_counts(cidx, offsets, cap, align, d, item)
    assert nbytes == len(rows) * d * item + len(cidx) * (d * item + cap * 8)
    assert flops == 2 * d * valid


def test_weights_are_one_draw_per_kind():
    specs = [("a", (3, 4), "normal", 0.5), ("b", (2,), "ones", None),
             ("c", (5,), "uniform", (-1.0, 1.0)), ("d", (4, 4), "normal", 2.0)]
    w = weights.make(specs, 9, 1, torch.device("cpu"), torch.float32)
    again = weights.make(specs, 9, 1, torch.device("cpu"), torch.float32)
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert torch.equal(w["b"], torch.ones(2))
    assert w["c"].abs().max() <= 1.0
