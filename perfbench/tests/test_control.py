"""The control (the reference in float8 in the program's place) comes out
not correct, on three seeds, at a size a test run holds; the program
comes out correct on the same samples."""

import time

import pytest
import torch

from perfbench import compare, harness
from perfbench.tests.tiny import CELLS, tiny


@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 77, 2**33 + 1])
@pytest.mark.parametrize("name,family", CELLS)
def test_control_fails_where_the_program_passes(name, family, seed):
    cell, cfg = tiny(name, family)
    keep = {}
    res = harness.run_cell(cell, cfg, seed, 0.3, False, torch.device("cpu"),
                           time.time(), keep=keep)
    assert res["correct"], res["checks"]
    ctrl = compare.control_sample(keep["reference"], keep["sample"])
    nums = compare.readings(keep["reference"], ctrl)
    ok, _ = compare.judge(nums, cell["limits"], 0)
    assert not ok, nums
