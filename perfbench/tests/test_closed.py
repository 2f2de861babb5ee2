"""The closed loop on a host that outruns the inputs it was sized for."""

import time
import weakref

import torch

from perfbench import harness, loop
from perfbench.tests.tiny import tiny


def test_a_traced_window_that_outruns_its_inputs_is_correct():
    cell, cfg = tiny()
    # inputs for 1 query/s: the untraced window and the traced batches
    # run past them and reuse them from the start
    cell["traffic"]["params"]["max_qps"] = 1
    res = harness.run_cell(cell, cfg, 2**31 + 23, 1.0, True,
                           torch.device("cpu"), time.time())
    assert res["correct"], res["checks"]
    w = res["window"]
    assert w.n == cell["traffic"]["params"]["trace_batches"]
    assert w.bucket_bytes > 0 and w.wall_flops > 0


def test_only_the_batches_in_flight_and_the_kept_rows_are_held(monkeypatch):
    outputs, held, kept = [], [], []
    real_rep, real_keep = harness.TowerTap.first_token_rep, loop.Served.keep

    def rep(self, ids, mask):
        q = real_rep(self, ids, mask)
        outputs.append(weakref.ref(q))
        held.append(sum(r() is not None for r in outputs))
        return q

    def keep(self, i, out, q):
        real_keep(self, i, out, q)
        kept.append((self.q[i], len(self.rows[i])))
    monkeypatch.setattr(harness.TowerTap, "first_token_rep", rep)
    monkeypatch.setattr(loop.Served, "keep", keep)
    cell, cfg = tiny("nqdpr.b512-cap4096")
    res = harness.run_cell(cell, cfg, 2**31 + 29, 1.0, False,
                           torch.device("cpu"), time.time())
    assert res["correct"], res["checks"]
    # the batch in flight and the one being issued
    assert len(held) > 3 and max(held) <= 2, held
    # each batch keeps a copy of its compared rows, not a view of its
    # tower output
    assert all(q.shape[0] == n and q._base is None for q, n in kept)
