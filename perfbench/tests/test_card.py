"""On the card: a tiny cell through the whole run, untraced and traced
(skips without a card)."""

import time

import pytest

from perfbench import harness
from perfbench.tests.tiny import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, trace):
    cell, cfg = tiny()
    res = harness.run_cell(cell, cfg, 2**31 + 3, 0.5, trace, card,
                           time.time())
    assert res["correct"], res["checks"]
    if trace:
        assert res["window"].trace.busy_s() > 0
