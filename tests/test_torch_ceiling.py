"""Port parity: ``mevi_tpu_torch.eval.ceiling`` against
``mevi_tpu.eval.ceiling`` on tiny synth specs, on the CPU.

Slot decoding, candidate counts and Bayes bounds equal; oracle-tower
embeddings equal; exact-MIPS metrics and the full report within 1e-4.
The JAX scan pads its last chunk with copies of doc 0 (ids past the
corpus, masked after the top-k), which can push real docs out of the
top-k; the port scans a short last chunk instead, so the parity cases
use a corpus that the JAX chunk divides."""

import jax.numpy as jnp
import numpy as np
import pytest

from mevi_tpu.data import synth as jsynth
from mevi_tpu.eval import ceiling as JC
from mevi_tpu_torch.data import synth as tsynth
from mevi_tpu_torch.eval import ceiling as TC

CPU = dict(device="cpu")
BASE = dict(ndoc=400, d=24, kary=4, levels=3, pool_n=16,
            scales=(1.0, 0.4, 0.2), zipf=(1.0, 0.6, 0.3), eps=0.05, seed=3,
            qlen=12, n_filler_vocab=32)


def specs(dropout, **kw):
    d = dict(BASE, info_dropout=dropout, **kw)
    return jsynth.SynthSpec(**d), tsynth.SynthSpec(**d)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    js, ts = specs(0.0)
    tab = jsynth.make_tables(js)
    draws = jsynth.make_draws(js)
    _, codes = jsynth.fit_rq_codes(
        js, (jnp.asarray(tab[0]), jnp.asarray(tab[1])), draws, iters=2,
        cache_base=str(tmp_path_factory.mktemp("fit")))
    return tab, draws, codes


def queries(dropout, draws, n, seed):
    js, ts = specs(dropout)
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, js.ndoc, n)
    tok = jsynth.query_tokens(js, draws[gt], rng)
    return js, ts, gt, tok


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_slots_and_candidates_equal(corpus, dropout):
    tab, draws, codes = corpus
    js, ts, gt, tok = queries(dropout, draws, 96, 2)
    obs = TC.observed_info(ts, tok)
    np.testing.assert_array_equal(obs, JC.observed_info(js, tok))
    np.testing.assert_array_equal(TC.doc_attrs(ts, draws),
                                  JC.doc_attrs(js, draws))
    for chunk in (64, 7):
        got = TC.candidate_stats(ts, draws, codes, obs, gt, chunk=chunk,
                                 **CPU)
        want = JC.candidate_stats(js, draws, codes, obs, gt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert TC.bayes_bounds(ts, draws, codes, tok, gt, **CPU) == \
        JC.bayes_bounds(js, draws, codes, tok, gt)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_oracle_tower_embeddings_equal(corpus, dropout):
    tab, draws, _ = corpus
    js, ts, gt, tok = queries(dropout, draws, 64, 4)
    obs = JC.observed_info(js, tok)
    np.testing.assert_array_equal(TC.oracle_tower_embeddings(ts, tab, obs),
                                  JC.oracle_tower_embeddings(js, tab, obs))


@pytest.mark.parametrize("dropout,chunk", [(0.0, 96), (0.3, 100),
                                           (0.3, 1 << 16)])
def test_exact_mips_metrics_match_jax(corpus, dropout, chunk):
    """JAX at a chunk of 100 (divides 400: no pad rows) against the port
    at a dividing, a non-dividing (short tail) and a single chunk.
    Duplicate docs tie exactly: both keep the lower id first, so
    recall@1 agrees too.  Distinct docs can also tie to within a float32
    ULP under the posterior-mean queries, and XLA and torch may order
    those two ways (seed 5 has one such query: three docs within 2e-7);
    seed 8 has none."""
    tab, draws, _ = corpus
    js, ts, gt, tok = queries(dropout, draws, 64, 8)
    q = JC.oracle_tower_embeddings(js, tab, JC.observed_info(js, tok))
    want = JC.exact_mips_metrics(q, js, tab, draws, gt, chunk_docs=100)
    got = TC.exact_mips_metrics(q, ts, tab, draws, gt, chunk_docs=chunk,
                                **CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_exact_mips_topk_is_the_stable_topk(corpus):
    """The running top-k equals a full scan's stable top-k (lower doc id
    first on ties)."""
    tab, draws, _ = corpus
    js, ts, gt, tok = queries(0.0, draws, 16, 6)
    q = TC.oracle_tower_embeddings(ts, tab, TC.observed_info(ts, tok))
    s, i = TC.exact_mips_topk(q, ts, tab, draws, k=20, chunk_docs=64, **CPU)
    rows = tsynth.gen_rows(tsynth.tables_to(tab, "cpu"), draws).numpy()
    full = q @ rows.T
    np.testing.assert_allclose(s.numpy(), -np.sort(-full, 1)[:, :20],
                               atol=1e-5)
    dup = (draws[:, None] == draws[None]).all(-1).sum(1)
    assert (dup[gt] > 1).any()           # the spec has duplicate docs
    for r in range(len(q)):
        top = i[r].numpy()
        for a, b in zip(top[:-1], top[1:]):
            if (draws[a] == draws[b]).all():
                assert a < b


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_ceiling_report_matches_jax(dropout, tmp_path):
    """ndoc 65,536 = the JAX scan's chunk: no pad rows on its side."""
    js, ts = specs(dropout, ndoc=1 << 16)
    tab = jsynth.make_tables(js)
    draws = jsynth.make_draws(js)
    _, codes = jsynth.fit_rq_codes(
        js, (jnp.asarray(tab[0]), jnp.asarray(tab[1])), draws, iters=2,
        fit_sample=4096, cache_base=str(tmp_path))
    rng = np.random.default_rng(7)
    gt = rng.integers(0, js.ndoc, 48)
    tok = jsynth.query_tokens(js, draws[gt], rng)
    want = JC.ceiling_report(js, tab, draws, codes, tok, gt)
    got = TC.ceiling_report(ts, tab, draws, codes, tok, gt, **CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    if dropout == 0.0:
        # clean queries: the oracle tower is the doc's own direction, so
        # the gt ranks behind exactly its duplicates of lower id
        same = (draws[None, :, :] == draws[gt][:, None, :]).all(-1)
        lower = (same & (np.arange(js.ndoc)[None] < gt[:, None])).sum(1)
        for k in (1, 10, 100):
            assert got[f"oracle_tower_recall@{k}"] == round(
                float((lower < k).mean()), 4)
