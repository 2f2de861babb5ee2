"""The plain reference against the port at tiny sizes, and the
comparison failing on what it must catch."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench import compare, harness
from perfbench.tests.tiny import FAMILIES, tiny

CPU = torch.device("cpu")


def served(cell="marco.b512", family="t5", dtype="bfloat16", seed=11):
    cell, cfg = tiny(cell, family)
    cfg["dtype"] = dtype
    keep = {}
    res = harness.run_cell(cell, cfg, seed, 1.0, False, CPU, time.time(),
                           keep=keep)
    return cell, res, keep


@pytest.mark.parametrize("family", FAMILIES)
def test_port_in_float32_agrees_with_the_reference(family):
    cell, res, keep = served(family=family, dtype="float32")
    n = keep["numbers"]
    assert n["tower_err"] < 1e-4 and n["beam_err"] < 1e-4, n
    assert n["beam_gap"] < 1e-4 and n["pool_err"] < 1e-6, n
    assert n["pool_gap"] == 0 and n["pool_faults"] == 0, n


@pytest.mark.parametrize("family", FAMILIES)
def test_port_in_bfloat16_is_correct(family):
    cell, res, keep = served(family=family)
    assert res["correct"], res["checks"]
    assert keep["sample"].ids.shape[0] == cell["traffic"]["params"][
        "check_queries"]


def _judged(cell, keep, sm):
    nums = compare.readings(keep["reference"], sm)
    return nums, compare.judge(nums, cell["limits"], 0)[0]


def test_a_corrupted_pool_fails():
    cell, res, keep = served()
    sm = keep["sample"]
    ids = sm.pool_ids.copy()
    last = int((ids[0] >= 0).sum()) - 1
    ids[0, [0, last]] = ids[0, [last, 0]]         # best and worst swapped
    nums, ok = _judged(cell, keep, dataclasses.replace(sm, pool_ids=ids))
    assert not ok and nums["pool_err"] > cell["limits"]["pool_err"], nums
    scores = sm.pool_scores.copy()
    scores[1, 0] += 0.05                          # one score off
    nums, ok = _judged(cell, keep, dataclasses.replace(sm,
                                                       pool_scores=scores))
    assert not ok, nums
    cut = sm.pool_ids.copy()
    cut[2, 3:] = -1                               # answers missing
    nums, ok = _judged(cell, keep, dataclasses.replace(sm, pool_ids=cut))
    assert not ok and nums["pool_faults"] > 0, nums


def test_a_wrong_doc_id_map_fails():
    cell, res, keep = served()
    sm = keep["sample"]
    ids = np.where(sm.pool_ids >= 0, sm.pool_ids + 1, -1)
    nums, ok = _judged(cell, keep, dataclasses.replace(sm, pool_ids=ids))
    assert not ok, nums


def test_beam_scores_in_a_lower_precision_fail():
    cell, res, keep = served()
    sm = keep["sample"]
    ctrl = compare.control_sample(keep["reference"], sm)
    low = dataclasses.replace(sm, beam_scores=torch.from_numpy(
        np.asarray(ctrl.beam_scores)) if isinstance(ctrl.beam_scores,
                                                    np.ndarray)
        else ctrl.beam_scores, codes=ctrl.codes)
    nums, ok = _judged(cell, keep, low)
    assert not ok and nums["beam_err"] > cell["limits"]["beam_err"], nums
