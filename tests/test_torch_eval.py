"""The port's offline evaluation path against the JAX package's, float32
on the CPU: the raw-score path (``bucket_scores_dispatch`` +
``mask_pool_topk``), ``coarse_ranks``, host streaming
(``streaming_mips_topk``, ``HostStreamFineReranker``) and ``Evaluator``
(``evaluate`` and ``evaluate_nq``, both ``host_stream`` values, with and
without ``eval_all_documents``), with the same weights on both sides.

Beam codes, coarse ranks and ndoc equal; metrics equal to 1e-6; scores
within 1e-5 (float32 sums of the same products in another order; 1e-4
where a tower embedding goes in first, the JAX serving tests' own
tolerance); ids equal wherever scores separate by more than that, and
as sets inside runs of tied scores.  The fixtures keep ``cap`` at least
the largest cluster plus 7, so the port's aligned window (``align=8``)
and the JAX CPU path's unaligned window hold the same rows; one test
runs the port through ``FineReranker(align=1)`` at a cap that cuts
clusters and sends some queries to the full scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.config import InferConfig as JInferConfig
from mevi_tpu.eval import ensemble as jens
from mevi_tpu.eval import run_eval as jrun
from mevi_tpu.eval import searcher as jsearch
from mevi_tpu.eval import streaming as jstream
from mevi_tpu.models.nci import NCIDims as JNCIDims
from mevi_tpu.models.nci import NCIT5 as JNCIT5
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu.models.t5 import T5Model as JT5Model
from mevi_tpu.ops.bucket import align_down as jalign_down
from mevi_tpu_torch.config import InferConfig
from mevi_tpu_torch.eval import ensemble as tens
from mevi_tpu_torch.eval import run_eval as trun
from mevi_tpu_torch.eval import searcher as tsearch
from mevi_tpu_torch.eval import streaming as tstream
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.ops.bucket import align_down
from mevi_tpu_torch.ops.mips import mips_topk
from mevi_tpu_torch.weights import load_flax_params

KARY, M = 4, 2
NQ, QLEN = 20, 6
RECALL = (1, 3, 5, 10, 20)


def assert_pool_equal(s_t, i_t, s_j, i_j, atol):
    """Scores within atol; ids equal wherever a score is at least atol
    from its neighbours, and equal as sets inside each run of tied
    scores (runs that reach the end of the pool are cut, so skipped)."""
    s_t, i_t = np.asarray(s_t, np.float64), np.asarray(i_t)
    s_j, i_j = np.asarray(s_j, np.float64), np.asarray(i_j)
    np.testing.assert_allclose(s_t, s_j, atol=atol, rtol=0)
    for b in range(s_j.shape[0]):
        runs = np.concatenate([[0], np.nonzero(
            np.abs(np.diff(s_j[b])) > atol)[0] + 1, [s_j.shape[1]]])
        for lo, hi in zip(runs[:-1], runs[1:]):
            if hi == s_j.shape[1] and hi - lo > 1:
                continue
            assert sorted(i_t[b, lo:hi]) == sorted(i_j[b, lo:hi]), (b, lo)


def _same_metrics(a, b, tol=1e-6):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            assert abs(a[name][k] - b[name][k]) <= tol, (name, k)


# ---------------------------------------------------------------------------
# the raw-score path and coarse ranks
# ---------------------------------------------------------------------------

def test_raw_dispatch_mask_pool_matches_jax():
    """Raw scores over aligned starts, masked to the bucket bounds and
    pooled per query, against JAX; and equal to the masked (v3) pool."""
    rng = np.random.default_rng(41)
    n, d, cap, nq, per_q, pool = 700, 16, 40, 6, 4, 30
    sizes = rng.integers(0, 30, 50)
    sizes[3] = 2 * cap                                # over cap
    sizes[-1] = 9                                     # the last cluster
    sizes = (sizes * n / sizes.sum()).astype(np.int64)
    sizes[3] += n - sizes.sum()
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    G = nq * per_q + 8                                # + padding buckets
    ci = rng.integers(0, len(sizes), G)
    ci[:2] = [3, len(sizes) - 1]
    st, en = offsets[ci], offsets[ci + 1]
    st[nq * per_q:] = en[nq * per_q:] = 0
    al = align_down(st).astype(np.int32)
    np.testing.assert_array_equal(al, np.asarray(jalign_down(st)))
    q = np.repeat(rng.normal(size=(G // per_q + 1, d)).astype(np.float32),
                  per_q, 0)[:G]
    J, T = jnp.asarray, torch.from_numpy
    raw_j = jsearch.bucket_scores_dispatch(J(emb), J(al), J(q), cap)
    raw_t = tsearch.bucket_scores_dispatch(T(emb), T(al), T(q), cap,
                                           device="cpu")
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=1e-5,
                               rtol=0)
    s_j, r_j = jsearch.mask_pool_topk(raw_j, J(al), J(st), J(en), cap, pool,
                                      nq, per_q)
    s_t, r_t = tsearch.mask_pool_topk(raw_t, T(al), T(st), T(en), cap, pool,
                                      nq, per_q)
    assert_pool_equal(s_t, r_t, s_j, r_j, 1e-5)
    assert (r_t.numpy() == -1).any() and (r_t.numpy() >= 0).any()
    # the masked kernel's pool over the same buckets
    s3, r3 = tsearch.bucket_scores_v3(T(emb), T(st), T(en), T(q), cap,
                                      device="cpu")
    m_s, m_r = tsearch.merge_pool(s3[:nq * per_q].reshape(nq, -1),
                                  r3[:nq * per_q].reshape(nq, -1), per_q,
                                  cap, pool)
    np.testing.assert_array_equal(m_s.numpy(), s_t.numpy())
    np.testing.assert_array_equal(m_r.numpy(), r_t.numpy())


def test_coarse_ranks_match_jax():
    rng = np.random.default_rng(42)
    beams = rng.integers(0, KARY, size=(15, 5, 3))
    gt = rng.integers(0, KARY, size=(15, 3, 3))
    gt[::2, 0] = beams[::2, 2]                        # hits at rank 2
    gt[:, 2] = -1                                     # padding
    np.testing.assert_array_equal(tsearch.coarse_ranks(beams, gt, KARY),
                                  jsearch.coarse_ranks(beams, gt, KARY))


# ---------------------------------------------------------------------------
# host streaming
# ---------------------------------------------------------------------------

def test_streaming_mips_matches_jax():
    rng = np.random.default_rng(43)
    nd, d, nq, k = 5000, 32, 8, 50
    emb = rng.normal(size=(nd, d)).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    # a chunk that does not divide nd exercises the ragged tail
    s_j, i_j = jstream.streaming_mips_topk(jnp.asarray(q), emb, k=k,
                                           chunk=1024)
    s_t, i_t = tstream.streaming_mips_topk(torch.from_numpy(q), emb, k=k,
                                           chunk=1024, device="cpu")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5, rtol=1e-6)


def test_streaming_mips_int8_memmap_matches_jax(tmp_path):
    rng = np.random.default_rng(44)
    nd, d, nq, k = 3000, 16, 4, 20
    emb = rng.normal(size=(nd, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb8 = np.clip(np.round(emb * 126), -127, 127).astype(np.int8)
    p = str(tmp_path / "emb.bin")
    mm = np.memmap(p, np.int8, "w+", shape=emb8.shape)
    mm[:] = emb8
    mm.flush()
    ro = np.memmap(p, np.int8, "r", shape=emb8.shape)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    s_j, i_j = jstream.streaming_mips_topk(jnp.asarray(q), ro, k=k,
                                           chunk=512)
    s_t, i_t = tstream.streaming_mips_topk(q, ro, k=k, chunk=512,
                                           device="cpu")
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=126 * 1e-5, rtol=0)


def test_streaming_mips_bf16_tensor_matches_mips_topk():
    """A bf16 CPU tensor moves as its bits; scores equal the in-memory
    scan's (both float32 products of the same bf16 values)."""
    rng = np.random.default_rng(45)
    emb = torch.from_numpy(rng.normal(size=(2000, 16)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(
        torch.bfloat16)
    s_t, i_t = tstream.streaming_mips_topk(q, emb, k=30, chunk=300,
                                           device="cpu")
    s_m, i_m = mips_topk(q, emb, k=30)
    np.testing.assert_array_equal(i_t, i_m.numpy())
    np.testing.assert_allclose(s_t, s_m.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_host_stream_fine_matches_jax(name):
    """Sub-batches of 3 over 7 queries: two full panels and a ragged
    one; cap 8 below the largest clusters, which are cut."""
    rng = np.random.default_rng(46)
    n, d, cap, pool = 600, 16, 8, 20
    emb = rng.normal(size=(n, d)).astype(np.float32)
    if name == "int8":
        emb = np.clip(np.round(emb * 40), -127, 127).astype(np.int8)
    codes = rng.integers(0, KARY, size=(n, 3)).astype(np.int32)
    index = jsearch.build_fine_index(codes, emb, KARY)
    q = rng.normal(size=(7, d)).astype(np.float32)
    beams = rng.integers(0, KARY, size=(7, 5, 3)).astype(np.int32)
    args = (np.asarray(index.sorted_emb), np.asarray(index.host_offsets),
            np.asarray(index.host_doc_ids), KARY, cap, pool)
    s_j, i_j, n_j = jstream.HostStreamFineReranker(*args, sub_batch=3)(
        q, beams)
    s_t, i_t, n_t = tstream.HostStreamFineReranker(
        *args, sub_batch=3, device="cpu")(torch.from_numpy(q), beams)
    assert (np.diff(index.host_offsets) > cap).any()
    np.testing.assert_array_equal(n_t, n_j)
    assert_pool_equal(s_t, i_t, s_j, i_j, 40 * 1e-5 if name == "int8"
                      else 1e-5)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def setup():
    """The fixture of tests/test_serve.py: one-layer T5/NCI (d 16), 256
    docs over 16 clusters, 20 queries with 1-3 gt docs each."""
    import jax
    rng = np.random.default_rng(5)
    t5kw = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nkw = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
               adaptor_num_heads=4, adaptor_d_ff=32)
    jt5 = JT5Dims(dropout_rate=0.0, **t5kw)
    jnci, jq = JNCIT5(JNCIDims(t5=jt5, **nkw)), JT5Model(jt5)
    ids = rng.integers(2, 60, size=(NQ, QLEN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[3, 4:] = 0
    nci_params = jnci.init(jax.random.PRNGKey(0), jnp.asarray(ids[:8]),
                           jnp.asarray(mask[:8]),
                           jnp.zeros((8, M + 2), jnp.int32))["params"]
    q_params = jq.init(jax.random.PRNGKey(1), jnp.asarray(ids[:8]),
                       jnp.asarray(mask[:8]),
                       jnp.zeros((8, 1), jnp.int32))["params"]
    emb = rng.normal(size=(256, 16)).astype(np.float32)
    codes = rng.integers(0, KARY, size=(256, M)).astype(np.int32)
    gts = [rng.choice(256, rng.integers(1, 4), replace=False).tolist()
           for _ in range(NQ)]
    tnci = load_flax_params(NCIT5(NCIDims(t5=T5Dims(**t5kw), **nkw),
                                  device="cpu"), _flat(nci_params))
    tq = load_flax_params(T5Model(T5Dims(**t5kw), device="cpu"),
                          _flat(q_params))
    jfine = jsearch.build_fine_index(codes, emb, KARY)
    tfine = tsearch.build_fine_index(codes, emb, KARY, device="cpu")
    cap = int(np.diff(jfine.host_offsets).max()) + 8

    def jrep(i, m):
        return jq.apply({"params": q_params}, i, m,
                        method=JT5Model.first_token_rep)
    answers = [rng.choice(NQ, rng.integers(0, 3), replace=False).tolist()
               for _ in range(256)]
    return dict(jnci=jnci, nci_params=nci_params, jrep=jrep, tnci=tnci,
                tq=tq, ids=ids, mask=mask, emb=emb, codes=codes, gts=gts,
                jfine=jfine, tfine=tfine, cap=cap, answers=answers)


def _evaluators(S, host_stream, eval_all, cap=None, **cfg_kw):
    kw = dict(num_return_sequences=3, recall_num=RECALL,
              max_cluster_docs=cap or S["cap"], eval_all_documents=eval_all,
              **cfg_kw)
    jfine, tfine = S["jfine"], S["tfine"]
    if host_stream:
        jfine = jfine._replace(sorted_emb=np.asarray(jfine.sorted_emb))
    j = jrun.Evaluator(S["jnci"], S["nci_params"], JInferConfig(**kw),
                       fine_index=jfine, query_rep_fn=S["jrep"],
                       doc_codes=S["codes"], host_stream=host_stream)
    t = trun.Evaluator(S["tnci"], InferConfig(**kw), fine_index=tfine,
                       query_rep_fn=S["tq"].first_token_rep,
                       doc_codes=S["codes"], host_stream=host_stream,
                       device="cpu")
    return j, t


def _same_results(out_t, out_j, atol=1e-4):
    """Batch results equal.  JAX's ``evaluate_nq`` leaves the padded rows
    of the padded last batch in ``beam_scores`` and ``fine_scores``; the
    port trims every array to the real rows, so those are cut here."""
    assert len(out_t.results) == len(out_j.results)
    for rt, rj in zip(out_t.results, out_j.results):
        real = len(rj.beam_codes)
        assert rt.queries == rj.queries and len(rt.beam_scores) == real
        np.testing.assert_array_equal(rt.beam_codes, rj.beam_codes)
        np.testing.assert_allclose(rt.beam_scores, rj.beam_scores[:real],
                                   atol=1e-4)
        if rj.fine_ids is None:
            assert rt.fine_ids is None
            continue
        np.testing.assert_array_equal(rt.ndoc, rj.ndoc)
        assert len(rt.fine_scores) == real
        assert_pool_equal(rt.fine_scores, rt.fine_ids,
                          rj.fine_scores[:real], rj.fine_ids, atol)


@pytest.mark.parametrize("host_stream", [False, True])
@pytest.mark.parametrize("eval_all", [False, True])
def test_evaluate_matches_jax(setup, host_stream, eval_all, tmp_path):
    """20 queries at batch 8: the last batch is padded by repeating its
    last row and trimmed back."""
    S = setup
    j, t = _evaluators(S, host_stream, eval_all)
    queries = [f"q{i}" for i in range(NQ)]
    args = (queries, S["ids"], S["mask"], S["gts"])
    out_j = j.evaluate(*args, batch_size=8, keep_results=True)
    out_t = t.evaluate(*args, batch_size=8, keep_results=True)
    _same_metrics(out_t.coarse, out_j.coarse)
    _same_metrics(out_t.fine, out_j.fine)
    assert abs(out_t.ndoc_per_query - out_j.ndoc_per_query) <= 1e-9
    assert out_t.nonempty_hit == out_j.nonempty_hit
    _same_results(out_t, out_j)
    assert len(t.timings) == 3
    assert out_t.fine["recall"][20] > 0          # a hit is exercised
    # result tsvs: both sides' files parse to the same rows (ids as sets:
    # the pool's order is compared above)
    for tag, out, write in (("t", out_t, trun.write_result_files),
                            ("j", out_j, jrun.write_result_files)):
        write(out, S["gts"], coarse_path=str(tmp_path / f"{tag}_c.tsv"),
              fine_path=str(tmp_path / f"{tag}_f.tsv"),
              hardneg_path=str(tmp_path / f"{tag}_h.tsv"), hard_neg_k=5)
    from mevi_tpu_torch.data.io import parse_result_tsv

    def parsed(tag, suffix, tmpl):
        return parse_result_tsv(str(tmp_path / f"{tag}_{suffix}.tsv"), tmpl)
    for suffix, tmpl in (("c", {"query": 0, "cluster": 1, "score": 3}),
                         ("f", {"query": 0, "pred": 2}),
                         ("h", {"query": 0, "pred": 2, "score": 3})):
        p_t, s_t, c_t = parsed("t", suffix, tmpl)
        p_j, s_j, c_j = parsed("j", suffix, tmpl)
        assert c_t == c_j
        assert len(p_t) == NQ or suffix == "c"
        assert p_t.keys() == p_j.keys() and s_t.keys() == s_j.keys()
        for q in p_t:
            assert sorted(p_t[q]) == sorted(p_j[q])
        for q in s_t:
            np.testing.assert_allclose(s_t[q], s_j[q], atol=1e-4)


@pytest.mark.parametrize("host_stream", [False, True])
def test_evaluate_nq_matches_jax(setup, host_stream):
    S = setup
    j, t = _evaluators(S, host_stream, False)
    queries = [f"q{i}" for i in range(NQ)]
    qinds = list(range(NQ))
    out_j = j.evaluate_nq(queries, S["ids"], S["mask"], qinds,
                          jens.AnswerIndex.from_answer_sets(S["answers"]),
                          batch_size=8, keep_results=True)
    out_t = t.evaluate_nq(queries, S["ids"], S["mask"], qinds,
                          tens.AnswerIndex.from_answer_sets(S["answers"]),
                          batch_size=8, keep_results=True)
    _same_metrics(out_t.coarse, out_j.coarse)
    _same_metrics(out_t.fine, out_j.fine)
    assert out_t.coarse["hitrate"][3] > 0
    assert abs(out_t.ndoc_per_query - out_j.ndoc_per_query) <= 1e-9
    _same_results(out_t, out_j)


def test_evaluate_align1_window_matches_jax(setup):
    """At cap 18 a quarter of the clusters (9-25 rows) are cut and the
    queries that meet one take the full scan.  Through ``FineReranker(align=1)`` the port
    scores the JAX CPU path's unaligned window and equals it."""
    S = setup
    j, t = _evaluators(S, False, False, cap=18)
    t._rerank = tsearch.FineReranker(S["tfine"], 18, max(RECALL),
                                     align=1, device="cpu")
    queries = [f"q{i}" for i in range(NQ)]
    args = (queries, S["ids"], S["mask"], S["gts"])
    out_j = j.evaluate(*args, batch_size=8, keep_results=True)
    out_t = t.evaluate(*args, batch_size=8, keep_results=True)
    _same_metrics(out_t.fine, out_j.fine)
    _same_results(out_t, out_j)
    codes = np.concatenate([r.beam_codes for r in out_t.results])
    ci = tsearch.pack_codes(codes.reshape(-1, M), KARY)
    over = (np.diff(S["jfine"].host_offsets)[ci].reshape(NQ, -1) > 18).any(1)
    assert over.any() and not over.all()      # both branches are taken


def test_full_scan_int8_keeps_float_queries(setup):
    """eval_all_documents over an int8 index: the query stays float and
    the int8 rows are upcast (scores equal a float64 numpy scan), on the
    device path and the host-streamed one."""
    S = setup
    emb8 = np.clip(np.round(S["emb"] * 40), -127, 127).astype(np.int8)
    fine8 = tsearch.build_fine_index(S["codes"], emb8, KARY, device="cpu")
    cfg = InferConfig(num_return_sequences=3, recall_num=RECALL,
                      max_cluster_docs=S["cap"], eval_all_documents=True)
    qemb = S["tq"].first_token_rep(torch.from_numpy(S["ids"][:8]),
                                   torch.from_numpy(S["mask"][:8]))
    ref = qemb.double().numpy() @ emb8.astype(np.float64).T
    top = np.sort(ref, 1)[:, ::-1][:, :max(RECALL)]
    for hs in (False, True):
        ev = trun.Evaluator(S["tnci"], cfg, fine_index=fine8,
                            query_rep_fn=S["tq"].first_token_rep,
                            host_stream=hs, device="cpu")
        s, ids, nd = ev._full_scan(qemb)
        np.testing.assert_allclose(s, top, atol=40 * 1e-5, rtol=0)
        np.testing.assert_allclose(
            np.take_along_axis(ref, ids.astype(np.int64), 1), s,
            atol=40 * 1e-5, rtol=0)
        assert (nd == 256).all()
