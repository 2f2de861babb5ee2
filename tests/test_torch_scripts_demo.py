"""``mevi_tpu_torch.scripts.quality_demo`` against
``scripts/quality_demo.py`` on the CPU, at the JAX script's CPU branch
(5,000 documents, d 64, a 2 + 2 layer NCI, batch 32, 60 steps), the JAX
script run in this process with its intermediate values recorded where
it calls the package:

* the corpus, the codes (given the JAX fit's codebooks), the dev tokens
  and the first train batch are bit-equal to the JAX script's: every
  host draw comes from one ``default_rng(0)`` in the JAX order;
* given the JAX codebooks and the JAX initial parameters (through
  ``mevi_tpu_torch.weights``), the line's hits equal the JAX line's, the
  first loss is within 1e-4 (one forward of equal weights on an equal
  batch), the last within 2e-2 (60 AdamW steps in two frameworks'
  float32 rounding), and the dev beams' top codes agree on at least 95%
  of the queries.
"""

import json
import os
import os.path as osp
import runpy
from unittest import mock

import numpy as np
import pytest
from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIRST_LOSS_TOL = 1e-4
LAST_LOSS_TOL = 2e-2
TOP_BEAM_AGREE = 0.95


def _recorder(store, name, fn, pick=lambda a, k, out: out):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        store.setdefault(name, pick(a, k, out))
        return out
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import contextlib
    import io
    import mevi_tpu.decode.beam as jbeam
    import mevi_tpu.eval.searcher as jsearch
    import mevi_tpu.ops.rq as jrq
    import mevi_tpu.train.trainer as jtrainer
    from flax import traverse_util
    from mevi_tpu_torch.scripts import quality_demo as qd
    rec = {}
    make_step = jtrainer.make_nci_train_step

    def step_maker(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, batch, rng):
            rec.setdefault("first_batch", {kk: np.asarray(v)
                                           for kk, v in batch.items()})
            return step(state, batch, rng)
        return recorded
    out = io.StringIO()
    with mock.patch.dict(os.environ, {
            "DEMO_FORCE_CPU": "1",
            "JAX_COMPILATION_CACHE_DIR":
                str(tmp_path_factory.mktemp("jc"))}), \
            mock.patch.object(jrq, "rq_train", _recorder(
                rec, "cbs", jrq.rq_train,
                lambda a, k, o: np.asarray(o[0], np.float32))), \
            mock.patch.object(jsearch, "build_fine_index", _recorder(
                rec, "corpus", jsearch.build_fine_index,
                lambda a, k, o: (np.asarray(a[0]), np.asarray(a[1])))), \
            mock.patch.object(jtrainer, "init_state", _recorder(
                rec, "init", jtrainer.init_state,
                lambda a, k, o: {kk: np.asarray(v) for kk, v in
                                 traverse_util.flatten_dict(
                                     a[0], sep="/").items()})), \
            mock.patch.object(jtrainer, "make_nci_train_step", step_maker), \
            mock.patch.object(jbeam, "nci_beam_search_incremental",
                              _recorder(rec, "beam",
                                        jbeam.nci_beam_search_incremental,
                                        lambda a, k, o: (np.asarray(a[2]),
                                                         np.asarray(o[0])))), \
            contextlib.redirect_stdout(out):
        runpy.run_path(osp.join(REPO, "scripts", "quality_demo.py"),
                       run_name="__main__")
    jax_line = json.loads(out.getvalue().strip().splitlines()[-1])
    keep = {}
    line = qd.run("cpu", codebooks=rec["cbs"], init_params=rec["init"],
                  keep=keep)
    return jax_line, rec, line, keep


def test_corpus_bit_equal(runs):
    _, rec, _, keep = runs
    codes, emb = rec["corpus"]
    assert keep["emb"].dtype == emb.dtype
    assert keep["emb"].tobytes() == emb.tobytes()
    np.testing.assert_array_equal(keep["codes"], codes)


def test_dev_tokens_bit_equal(runs):
    _, rec, _, keep = runs
    q_dev, _ = rec["beam"]
    assert keep["q_dev"].dtype == q_dev.dtype
    assert keep["q_dev"].tobytes() == q_dev.tobytes()


@pytest.mark.parametrize("name", ["query_ids", "query_mask", "codes"])
def test_first_batch_equal(runs, name):
    _, rec, _, keep = runs
    np.testing.assert_array_equal(keep["first_batch"][name],
                                  rec["first_batch"][name])


def test_line_matches_jax(runs):
    jax_line, _, line, _ = runs
    assert set(line) == set(jax_line)
    for k in ("coarse_hit@1", "coarse_hit@10", "fine_recall@10", "steps",
              "batch", "ndoc", "n_train"):
        assert line[k] == jax_line[k], k
    assert line["loss_first"] == pytest.approx(jax_line["loss_first"],
                                               abs=FIRST_LOSS_TOL)
    assert line["loss_last"] == pytest.approx(jax_line["loss_last"],
                                              abs=LAST_LOSS_TOL)


def test_dev_beams_agree(runs):
    _, rec, _, keep = runs
    _, codes_j = rec["beam"]
    top = (keep["codes_dev"][:, 0] == codes_j[:, 0]).all(-1).mean()
    assert top >= TOP_BEAM_AGREE, top
