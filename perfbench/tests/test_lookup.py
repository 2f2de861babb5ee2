"""A configuration's query tower found by its family's name: each
family's module gives its parts, an unknown family is refused by the
file it looked for, and a family added as a file alone runs a cell."""

import os
import re
import time

import numpy as np
import pytest
import torch

from perfbench import counts, harness, lookup
from perfbench.tests.tiny import FAMILIES, tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_every_family_gives_its_parts(family):
    mod, ref = lookup.tower(family), lookup.reference(family)
    for part in (mod.build, mod.flops, ref.tower_specs, ref.rep):
        assert callable(part)
    assert mod.TINY["family"] == family


def test_an_unknown_family_names_the_file_it_looked_for():
    cell, cfg = tiny()
    cfg["tower"]["family"] = "no_such_tower"
    ref = re.escape(os.path.join(lookup.REFERENCE, "no_such_tower.py"))
    port = re.escape(os.path.join(lookup.TOWERS, "no_such_tower.py"))
    with pytest.raises(FileNotFoundError, match=ref):
        harness.run_cell(cell, cfg, 5, 0.1, False, CPU, time.time())
    with pytest.raises(FileNotFoundError, match=port):
        counts.tower_flops([4], cfg["tower"])
    with pytest.raises(FileNotFoundError, match=port):
        lookup.tower("no_such_tower")


def _served(cell, cfg, trace=False):
    # inputs for a rate far below the host's: the window serves every
    # batch, so the sample does not depend on the host's speed
    cell["traffic"]["params"]["max_qps"] = 1
    keep = {}
    res = harness.run_cell(cell, cfg, 2**31 + 17, 1.0, trace, CPU,
                           time.time(), keep=keep)
    return res, keep


def test_a_family_added_as_a_file_alone_runs_a_cell(tmp_path, monkeypatch):
    res, keep = _served(*tiny("nqdpr.b512-cap4096", "bert"), trace=True)
    flops = counts.tower_flops([5, 3, 8], tiny(family="bert")[1]["tower"])
    # the family's two files, copied under another name
    for d, attr in (("towers", "TOWERS"), ("reference", "REFERENCE")):
        src = open(os.path.join(getattr(lookup, attr), "bert.py")).read()
        (tmp_path / d).mkdir()
        (tmp_path / d / "twin.py").write_text(
            src.replace('"family": "bert"', '"family": "twin"'))
        monkeypatch.setattr(lookup, attr, str(tmp_path / d))
    assert lookup.tower_families() == ["twin"]
    twin, twin_keep = _served(*tiny("nqdpr.b512-cap4096", "twin"),
                              trace=True)
    assert twin["correct"], twin["checks"]
    assert twin["window"].wall_flops > 0
    # the same model under another name serves and reads the same
    assert twin_keep["numbers"] == keep["numbers"]
    a, b = keep["sample"], twin_keep["sample"]
    assert torch.equal(a.q, b.q) and np.array_equal(a.pool_ids, b.pool_ids)
    tc = tiny("nqdpr.b512-cap4096", "twin")[1]["tower"]
    assert counts.tower_flops([5, 3, 8], tc) == flops
