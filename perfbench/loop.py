"""What the traffic kinds share: issuing a batch through the server,
keeping a few served rows of each for the comparison, assembling the
seed's sample from them, and the profiled window."""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
import traceback
from typing import List

import numpy as np
import torch

from . import compare, data
from .trace import Trace, load_events


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ranged(name: str, on: bool = True):
    """A ``pb.<name>`` profiler range (a no-op when ``on`` is false)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function("pb." + name)


class Served:
    """Rows kept from each served batch: a few drawn from the seed and
    the batch's longest query.  ``rows[i]``: row positions of batch
    ``i``; their outputs, and their rows of the tower output the tap
    saw, are kept as the batch finishes."""

    def __init__(self, lengths: np.ndarray, batch: int, seed: int,
                 per_batch: int):
        rng = np.random.default_rng(data.seed_of(seed, 20))
        nbat = len(lengths) // batch
        self.rows = []
        for i in range(nbat):
            own = lengths[i * batch:(i + 1) * batch]
            pick = set(rng.choice(batch, size=min(per_batch, batch),
                                  replace=False).tolist())
            pick.add(int(np.argmax(own)))
            self.rows.append(np.array(sorted(pick)))
        self.batch = batch
        self.out = {}           # batch index -> (codes, beam, pool ids, scores)
        self.q = {}             # batch index -> its kept tower rows (device)
        self.failed = 0
        self.first_error = None

    def keep(self, i: int, out, q):
        r = self.rows[i]
        scores, ids, codes, beam, _ = out
        self.out[i] = (codes[r], beam[r], ids[r], scores[r])
        # a copy of the kept rows: no view holds the batch's hidden state
        self.q[i] = q.index_select(0, torch.as_tensor(r, device=q.device))

    def fail(self, n: int):
        self.failed += n
        if self.first_error is None:
            self.first_error = traceback.format_exc()
            log(self.first_error)

    def sample(self, queries: data.Queries, nb: int, n: int, seed: int
               ) -> compare.Sample:
        """``n`` of the kept rows, drawn from the seed, with the longest
        query among them."""
        cand = [(i, int(r)) for i in sorted(self.out) for r in self.rows[i]]
        glob = np.array([i * self.batch + r for i, r in cand])
        lens = queries.lengths.cpu().numpy()[glob]
        rng = np.random.default_rng(data.seed_of(seed, 21))
        take = rng.permutation(len(cand))[:n]
        longest = int(np.argmax(lens))
        if longest not in take:
            take[-1] = longest
        take = np.sort(take)
        g = torch.from_numpy(glob[take]).to(queries.ids.device)
        ids = queries.ids[g].cpu()
        mask = queries.mask[g].cpu()
        cidx = queries.cidx.reshape(-1, nb)[g].cpu()
        rows = [cand[j] for j in take]
        pick = [self.out[i] for i, _ in rows]
        pos = [int(np.searchsorted(self.rows[i], r)) for i, r in rows]
        q = torch.stack([self.q[i][k].float().cpu()
                         for (i, _), k in zip(rows, pos)])
        codes = torch.from_numpy(np.stack([p[0][k] for p, k in zip(pick, pos)]))
        beam = torch.from_numpy(np.stack([p[1][k] for p, k in zip(pick, pos)]))
        pid = np.stack([p[2][k] for p, k in zip(pick, pos)])
        psc = np.stack([p[3][k] for p, k in zip(pick, pos)])
        return compare.Sample(ids, mask, cidx, q, codes, beam, pid, psc)


def issue(server, qs: List[torch.Tensor]):
    """The device half of one batch: ``query_device`` with the
    doc-weighted clusters in place of the beam's."""
    ids, mask, cidx = qs
    return server.query_device(ids, mask, cidx_override=cidx)


class Profiled:
    """A ``torch.profiler`` capture of CPU and CUDA activity; ``window()``
    is the ``pb.window`` range whose device work the metrics read."""

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.dev = dev

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.__exit__(*exc)

    @staticmethod
    def window():
        return ranged("window")

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            t0 = time.time()
            self.prof.export_chrome_trace(path)
            events = load_events(path)
        tr = Trace(events)
        log(f"trace: {len(events)} events, {len(tr.ops)} device ops, "
            f"read in {time.time() - t0:.1f}s")
        return tr
