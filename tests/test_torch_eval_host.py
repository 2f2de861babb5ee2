"""The port's host-side eval modules against the JAX package's, on
random inputs from a numpy seed: ``eval.metrics``, ``eval.ensemble``,
the result tsvs of ``data.io`` and the CSR helpers of ``index.csr``.

Metrics: equal to 1e-12 (the same float64 arithmetic); files, parsed
rows, ranks, ids and sizes: equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.data import io as jio
from mevi_tpu.eval import ensemble as jens
from mevi_tpu.eval import metrics as jmet
from mevi_tpu.index import csr as jcsr
from mevi_tpu_torch.data import io as tio
from mevi_tpu_torch.eval import ensemble as tens
from mevi_tpu_torch.eval import metrics as tmet
from mevi_tpu_torch.index import csr as tcsr

KS = (1, 3, 5, 10, 50)


def _same_metrics(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            assert abs(a[name][k] - b[name][k]) <= 1e-12, (name, k)


@pytest.fixture(scope="module")
def ranked():
    """30 queries: 1-4 gt docs each over 200 docs, ranked lists of 0-60
    docs (some empty, some -1 padded), and scores."""
    rng = np.random.default_rng(31)
    gts, preds, scores = {}, {}, {}
    for i in range(30):
        q = f"q{i}"
        gts[q] = rng.choice(200, rng.integers(1, 5), replace=False).tolist()
        n = int(rng.integers(0, 60))
        p = rng.choice(200, n, replace=False)
        hit = rng.random(len(gts[q])) < 0.5
        for g, h in zip(gts[q], hit):
            if h and n:
                p[rng.integers(0, n)] = g
        preds[q] = list(dict.fromkeys(p.tolist()))
        scores[q] = sorted(rng.normal(size=len(preds[q])).tolist(),
                           reverse=True)
    return gts, preds, scores


def test_rank_matrix_metrics():
    rng = np.random.default_rng(32)
    pred = rng.integers(-1, 40, size=(25, 60))
    gt = rng.integers(-1, 40, size=(25, 4))
    gt[:, 0] = np.abs(gt[:, 0])
    r_t, r_j = tmet.ranks_of_gts(pred, gt), jmet.ranks_of_gts(pred, gt)
    np.testing.assert_array_equal(r_t, r_j)
    counts = (gt >= 0).sum(1)
    _same_metrics(tmet.metrics_from_rank_matrix(r_t, counts, KS),
                  jmet.metrics_from_rank_matrix(r_j, counts, KS))


def test_per_query_and_dict_metrics(ranked):
    gts, preds, scores = ranked
    for ranks in ([None, 3, 0], [None], [7], []):
        _same_metrics(tmet.per_query_metrics(ranks, KS),
                      jmet.per_query_metrics(ranks, KS))
    _same_metrics(tmet.evaluate_ranks(gts, preds, KS),
                  jmet.evaluate_ranks(gts, preds, KS))
    sc = {q: dict(zip(p, s)) for (q, p), s in zip(preds.items(),
                                                   scores.values())}
    _same_metrics(tmet.evaluate_scores(gts, sc, KS),
                  jmet.evaluate_scores(gts, sc, KS))


@pytest.fixture(scope="module")
def ensemble_case(ranked):
    """Coarse cluster lists (4 codes of 2 levels) and a doc -> code map."""
    gts, preds, scores = ranked
    rng = np.random.default_rng(33)
    mapping = {d: tuple(rng.integers(0, 4, 2).tolist()) for d in range(200)}
    clusters = {q: [[int(c) // 4, int(c) % 4]
                    for c in rng.choice(16, 4, replace=False)]
                for q in preds}
    fine = {q: rng.choice(200, 10, replace=False).tolist() for q in preds}
    fine_sc = {q: rng.normal(size=10).tolist() for q in preds}
    return gts, preds, scores, mapping, clusters, fine, fine_sc


def test_ensemble_fusion(ensemble_case):
    gts, preds, scores, mapping, clusters, fine, fine_sc = ensemble_case
    cr_t = tens.cluster_rankings(preds, clusters, mapping)
    cr_j = jens.cluster_rankings(preds, clusters, mapping)
    assert cr_t == cr_j
    cf, n = tens.cluster_rankings(fine, clusters, mapping)
    fused_t = tens.fuse_scores(preds, scores, cr_t[0], cr_t[1], 0.5, 0.1,
                               0.05, fine, fine_sc, cf)
    fused_j = jens.fuse_scores(preds, scores, cr_j[0], cr_j[1], 0.5, 0.1,
                               0.05, fine, fine_sc, cf)
    assert fused_t == fused_j
    kw = dict(alphas=(0.6, 0.3), betas=(0.03,), gammas=(0.02, 0.0),
              recall_ks=(1, 10, 50))
    res_t = tens.run_ensemble(gts, preds, scores, clusters, mapping, fine,
                              fine_sc, **kw)
    res_j = jens.run_ensemble(gts, preds, scores, clusters, mapping, fine,
                              fine_sc, **kw)
    assert res_t.keys() == res_j.keys()
    for key in res_t:
        _same_metrics(res_t[key], res_j[key])
    assert tens.rrf_fuse([preds, fine]) == jens.rrf_fuse([preds, fine])


def test_answer_index():
    rng = np.random.default_rng(34)
    answers = [rng.choice(40, rng.integers(0, 4), replace=False).tolist()
               for _ in range(120)]
    a_t = tens.AnswerIndex.from_answer_sets(answers)
    a_j = jens.AnswerIndex.from_answer_sets(answers)
    np.testing.assert_array_equal(a_t.offsets, a_j.offsets)
    np.testing.assert_array_equal(a_t.array, a_j.array)
    cluster_of_doc = rng.integers(0, 16, 120)
    for x, y in zip(a_t.query_clusters(cluster_of_doc, 45),
                    a_j.query_clusters(cluster_of_doc, 45)):
        np.testing.assert_array_equal(x, y)
    qinds = rng.integers(0, 45, 20)          # some past every answer
    ranked = rng.integers(-1, 120, size=(20, 30))
    np.testing.assert_array_equal(a_t.first_hit_ranks(qinds, ranked),
                                  a_j.first_hit_ranks(qinds, ranked))
    for q, docs in zip(qinds[:5], ranked[:5]):
        assert a_t.first_hit_rank(int(q), docs) == \
            a_j.first_hit_rank(int(q), docs)
        assert a_t.doc_answers_query(int(docs[0] % 120), int(q)) == \
            a_j.doc_answers_query(int(docs[0] % 120), int(q))
    _same_metrics(tens.nq_hit_metrics(a_t, qinds, ranked),
                  jens.nq_hit_metrics(a_j, qinds, ranked))


def test_result_tsvs(tmp_path, ranked):
    """The writers give byte-equal files; the parser reads them (and
    comma-joined lists) into equal rows."""
    gts, preds, scores = ranked
    rng = np.random.default_rng(35)
    coarse = [(q, rng.integers(0, 4, size=(3, 2)).tolist(), gts[q],
               rng.normal(size=3).tolist()) for q in preds]
    fine = [(q, int(rng.integers(0, 500)), preds[q], gts[q]) for q in preds]
    hn = [(q, [], preds[q], scores[q]) for q in preds]
    for name, rows, tmpl in (
            ("write_coarse_results", coarse, {"query": 0, "cluster": 1,
                                              "score": 3}),
            ("write_fine_results", fine, {"query": 0, "pred": 2}),
            ("write_hardneg_results", hn, {"query": 0, "pred": 2,
                                           "score": 3})):
        pt, pj = tmp_path / f"t_{name}.tsv", tmp_path / f"j_{name}.tsv"
        getattr(tio, name)(str(pt), rows)
        getattr(jio, name)(str(pj), rows)
        assert pt.read_bytes() == pj.read_bytes(), name
        assert tio.parse_result_tsv(str(pt), tmpl) == \
            jio.parse_result_tsv(str(pj), tmpl)
    qd = [(q, g) for q, g in gts.items()]
    pt, pj = tmp_path / "t_q.tsv", tmp_path / "j_q.tsv"
    tio.write_query_docids_tsv(str(pt), qd)
    jio.write_query_docids_tsv(str(pj), qd)
    assert pt.read_bytes() == pj.read_bytes()
    assert tio.read_query_docids_tsv(str(pt)) == \
        jio.read_query_docids_tsv(str(pj))
    assert tio.read_gt_dict(str(pt)) == jio.read_gt_dict(str(pj))


def test_csr_helpers():
    rng = np.random.default_rng(36)
    kary, M = 4, 3
    codes = rng.integers(0, kary, size=(300, M)).astype(np.int32)
    t = tcsr.make_index(codes, kary, device="cpu")
    j = jcsr.make_index(codes, kary)
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.doc_ids.numpy(), np.asarray(j.doc_ids))
    assert (t.levels, t.kary, t.num_clusters, t.num_docs) == \
        (j.levels, j.kary, j.num_clusters, j.num_docs)
    ci = rng.integers(0, kary ** M, size=(5, 7)).astype(np.int32)
    for cap in (2, 9):                       # clusters over and under cap
        d_t, s_t = tcsr.gather_bucket(t.offsets, t.doc_ids,
                                      torch.from_numpy(ci), cap)
        d_j, s_j = jcsr.gather_bucket(j.offsets, j.doc_ids, jnp.asarray(ci),
                                      cap)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    off = t.offsets.numpy()
    np.testing.assert_array_equal(tcsr.cluster_sizes(off),
                                  jcsr.cluster_sizes(off))
    assert tcsr.size_histogram(off) == jcsr.size_histogram(off)
