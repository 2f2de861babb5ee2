"""A whole run (set-up, window, comparison) with the timed path broken
underneath comes out not correct: once for each fault a serving cell can
have (a token or an answer altered where it is produced, half of a batch
left out) and for a few more of the served path's stages.  The look for
a card is skipped: the run is on the CPU at a tiny size."""

import time

import pytest
import torch

import mevi_tpu_torch.serve as serve
from perfbench import harness, lookup
from perfbench.tests.tiny import CELLS, tiny


def run(name="marco.b512", family="t5"):
    cell, cfg = tiny(name, family)
    return harness.run_cell(cell, cfg, 2**31 + 99, 0.3, False,
                            torch.device("cpu"), time.time())


@pytest.mark.parametrize("name,family", CELLS)
def test_unbroken_runs_are_correct(name, family):
    assert run(name, family)["correct"]


def _half(t):
    """The first half of the batch's rows, repeated in place of the
    second half."""
    h = (t.shape[0] + 1) // 2
    return torch.cat([t[:h], t[:t.shape[0] - h]])


@pytest.mark.parametrize("name,family", CELLS)
def test_answer_altered_in_the_pool(monkeypatch, name, family):
    real = serve.merge_pool

    def altered(*a, **k):
        s, rows = real(*a, **k)
        rows = rows.clone()
        rows[:, 1] = torch.where(rows[:, 1] >= 0, rows[:, 1] + 1, rows[:, 1])
        return s, rows
    monkeypatch.setattr(serve, "merge_pool", altered)
    assert not run(name, family)["correct"]


def test_code_token_altered_in_the_beam(monkeypatch):
    real = serve.nci_beam_search_incremental

    def altered(*a, **k):
        codes, scores, enc = real(*a, **k)
        codes = codes.clone()
        codes[..., -1] = (codes[..., -1] + 1) % 4
        return codes, scores, enc
    monkeypatch.setattr(serve, "nci_beam_search_incremental", altered)
    assert not run()["correct"]


def test_half_the_batch_left_out_of_the_beam(monkeypatch):
    real = serve.nci_beam_search_incremental

    def half(model, ids, mask, *a, **k):
        return tuple(_half(t) for t in real(model, _half(ids), _half(mask),
                                            *a, **k))
    monkeypatch.setattr(serve, "nci_beam_search_incremental", half)
    assert not run()["correct"]


@pytest.mark.parametrize("name,family", CELLS)
def test_half_the_batch_left_out_of_the_tower(monkeypatch, name, family):
    fam = lookup.tower(family)
    real = fam.build

    def build(*a, **k):
        rep = real(*a, **k)
        return lambda ids, mask: _half(rep(_half(ids), _half(mask)))
    monkeypatch.setattr(fam, "build", build)
    assert not run(name, family)["correct"]


def test_half_the_buckets_left_out(monkeypatch):
    real = serve.bucket_scores_v3

    def half(semb, starts, ends, *a, **k):
        G = starts.shape[0]
        ends = ends.clone()
        ends[G // 2:] = starts[G // 2:]
        return real(semb, starts, ends, *a, **k)
    monkeypatch.setattr(serve, "bucket_scores_v3", half)
    assert not run()["correct"]


def test_wrong_doc_id_map_at_finalize(monkeypatch):
    real = serve.BucketServer.finalize

    def shifted(self, handle):
        out = list(real(self, handle))
        out[1] = (out[1] + 1) * (out[1] >= 0) - (out[1] < 0)
        return tuple(out)
    monkeypatch.setattr(serve.BucketServer, "finalize", shifted)
    assert not run()["correct"]
