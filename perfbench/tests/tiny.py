"""A cell and configuration at a size the CPU runs in seconds, with the
shapes of the real ones (4 code levels, PAWA, aligned windows), and the
tower families the tests are held over."""

import copy
import json
import os
from typing import Optional

from perfbench import harness, lookup

FAMILIES = lookup.tower_families()


def cell_of(family: str) -> str:
    """The first cell of ``BENCHMARK.json`` whose configuration's tower
    is of ``family``; else the first cell (its tower then replaced)."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fr:
        names = [w["name"] for w in json.load(fr)["workloads"]]
    for name in names:
        if harness.load_cell(name)[1]["tower"]["family"] == family:
            return name
    return names[0]


# (cell, family): each family in the cell that runs it
CELLS = [(cell_of(f), f) for f in FAMILIES]


def tiny(cell_name: str = "marco.b512", family: Optional[str] = None):
    """The cell at a tiny size, its tower the family's ``TINY`` (by
    default the configuration's own family)."""
    cell, cfg = harness.load_cell(cell_name)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    cfg["corpus"].update(ndoc=3000, d=64, pool_rows=64)
    cfg["index"]["kary"] = 4
    small = dict(d_model=64, d_kv=16, d_ff=128, num_heads=4, num_layers=2)
    cfg["nci"].update(small, vocab_size=128, num_decoder_layers=2, kary=4,
                      pawa={"num_layers": 2, "num_heads": 4, "d_ff": 96,
                            "layer_norm_epsilon": 1e-05})
    cfg["tower"] = copy.deepcopy(
        lookup.tower(family or cfg["tower"]["family"]).TINY)
    cfg["serving"].update(num_beams=3, cap=16, pool=20, query_length=8)
    # shorter than the padded length, so that the masks are exercised
    cfg["query_lengths"] = {"kind": "fixed", "tokens": 5}
    cell["traffic"]["params"].update(batch=4, check_queries=12, max_qps=400,
                                     warm_batches=1, trace_batches=2)
    return cell, cfg
