"""The port's serving path against the JAX package's, on the fixture of
tests/test_serve.py: ``serve_batch``, ``fine_rerank``, ``FineReranker``
and ``BucketServer`` (vs ``PallasServer``), float32 on the CPU.

Codes equal; scores at the JAX tests' own tolerances (1e-4 for the
fused server, 1e-3 for the Pallas server); doc ids compared so that the
order of tied scores does not matter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu import serve as jserve
from mevi_tpu.eval import searcher as jsearch
from mevi_tpu.index.build import quantize_int8 as jquantize
from mevi_tpu.models.nci import NCIDims as JNCIDims
from mevi_tpu.models.nci import NCIT5 as JNCIT5
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu.models.t5 import T5Model as JT5Model
from mevi_tpu_torch import serve as tserve
from mevi_tpu_torch.eval import searcher as tsearch
from mevi_tpu_torch.index.build import quantize_int8
from mevi_tpu_torch.index.csr import pack_codes
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.weights import load_flax_params

KARY, M = 4, 2
NB, CAP, POOL = 3, 32, 20


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    t5kw = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nkw = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
               adaptor_num_heads=4, adaptor_d_ff=32)
    jt5 = JT5Dims(dropout_rate=0.0, **t5kw)
    jnci, jq = JNCIT5(JNCIDims(t5=jt5, **nkw)), JT5Model(jt5)
    ids = rng.integers(2, 60, size=(8, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    nci_params = jnci.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                           jnp.asarray(mask),
                           jnp.zeros((8, M + 2), jnp.int32))["params"]
    q_params = jq.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                       jnp.asarray(mask),
                       jnp.zeros((8, 1), jnp.int32))["params"]
    emb = rng.normal(size=(256, 16)).astype(np.float32)
    codes = rng.integers(0, KARY, size=(256, M)).astype(np.int32)
    jfine = jsearch.build_fine_index(codes, emb, KARY)
    tnci = load_flax_params(NCIT5(NCIDims(t5=T5Dims(**t5kw), **nkw),
                                  device="cpu"), flat(nci_params))
    tq = load_flax_params(T5Model(T5Dims(**t5kw), device="cpu"),
                          flat(q_params))
    tfine = tsearch.build_fine_index(codes, emb, KARY, device="cpu")
    return dict(jnci=jnci, jq=jq, nci_params=nci_params, q_params=q_params,
                ids=ids, mask=mask, jfine=jfine, tnci=tnci, tq=tq,
                tfine=tfine, emb=emb, codes=codes)


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


@pytest.mark.parametrize("rank", ["score", "beam_major"])
def test_serve_batch(setup, rank):
    S = setup
    j = jserve.serve_batch(S["jq"], S["jnci"], S["q_params"],
                           S["nci_params"], jnp.asarray(S["ids"]),
                           jnp.asarray(S["mask"]), S["jfine"].offsets,
                           S["jfine"].doc_ids, S["jfine"].sorted_emb,
                           num_beams=NB, cap=CAP, pool=POOL, rank=rank)
    f = S["tfine"]
    t = tserve.serve_batch(S["tq"], S["tnci"], T(S["ids"]), T(S["mask"]),
                           f.offsets, f.doc_ids, f.sorted_emb,
                           num_beams=NB, cap=CAP, pool=POOL, rank=rank)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), atol=1e-4)
    assert_pool_equal(t[0].numpy(), t[1].numpy(), j[0], j[1], 1e-4)


def _qemb_codes(S):
    qemb = np.asarray(S["jq"].apply(
        {"params": S["q_params"]}, jnp.asarray(S["ids"]),
        jnp.asarray(S["mask"]), method=JT5Model.first_token_rep))
    rng = np.random.default_rng(9)
    codes = rng.integers(0, KARY, size=(8, NB, M)).astype(np.int32)
    return qemb, codes


@pytest.mark.parametrize("rank", ["score", "beam_major"])
def test_fine_rerank(setup, rank):
    S = setup
    qemb, codes = _qemb_codes(S)
    jf, tf = S["jfine"], S["tfine"]
    js, ji, jn = jsearch.fine_rerank(
        jnp.asarray(qemb), jnp.asarray(codes), jf.offsets, jf.doc_ids,
        jf.sorted_emb, KARY, CAP, POOL, rank=rank)
    ts, ti, tn = tsearch.fine_rerank(
        T(qemb), T(codes), tf.offsets, tf.doc_ids, tf.sorted_emb, KARY, CAP,
        POOL, rank=rank)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert_pool_equal(ts.numpy(), ti.numpy(), js, ji, 1e-4)


@pytest.mark.parametrize("overflow,rank", [
    ("scan", "score"), ("truncate", "score"), ("truncate", "beam_major"),
    # beam_major + scan mixes two orderings across queries in the JAX
    # reranker (the scan rows are score-ordered); the port copies it
    ("scan", "beam_major")])
def test_fine_reranker(setup, overflow, rank):
    """cap 16 < the largest buckets, so 'scan' replaces some queries by
    the exact full scan.  The JAX reranker's CPU path scores the
    unaligned window, so the port runs with align=1."""
    S = setup
    qemb, codes = _qemb_codes(S)
    cap = 16
    jr = jsearch.FineReranker(S["jfine"], cap, POOL, overflow=overflow,
                              rank=rank)
    tr = tsearch.FineReranker(S["tfine"], cap, POOL, overflow=overflow,
                              rank=rank, align=1, device="cpu")
    js, ji, jn = jr(jnp.asarray(qemb), jnp.asarray(codes))
    ts, ti, tn = tr(T(qemb), T(codes))
    np.testing.assert_array_equal(tn, jn)
    assert_pool_equal(ts, ti, js, ji, 1e-4)
    sizes = np.diff(S["jfine"].host_offsets)[
        pack_codes(codes.reshape(-1, M), KARY)].reshape(8, NB)
    over = (sizes > cap).any(1)
    assert over.any() and not over.all()      # both branches are taken


@pytest.mark.parametrize("rank", ["score", "beam_major"])
def test_bucket_server_matches_pallas_server(setup, rank):
    S = setup
    js = jserve.PallasServer(S["jq"], S["jnci"], S["q_params"],
                             S["nci_params"], S["jfine"], num_beams=NB,
                             cap=CAP, pool=POOL, rank_mode=rank)
    ts = tserve.BucketServer(S["tq"], S["tnci"], S["tfine"], num_beams=NB,
                             cap=CAP, pool=POOL, rank_mode=rank,
                             device="cpu")
    j = js.query(jnp.asarray(S["ids"]), jnp.asarray(S["mask"]))
    t = ts.query(T(S["ids"]), T(S["mask"]))
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_allclose(t[3], j[3], atol=1e-4)
    np.testing.assert_array_equal(t[4], j[4])
    assert_pool_equal(t[0], t[1], j[0], j[1], 1e-3)


def test_bucket_server_int8_corpus(setup):
    """int8 corpus with inv_scale folded into bf16 query rows, as the
    JAX server does."""
    S = setup
    emb_q, scale = jquantize(np.asarray(S["jfine"].sorted_emb))
    emb_t, scale_t = quantize_int8(np.asarray(S["jfine"].sorted_emb))
    np.testing.assert_array_equal(emb_t, emb_q)
    assert scale_t == scale
    js = jserve.PallasServer(
        S["jq"], S["jnci"], S["q_params"], S["nci_params"],
        S["jfine"]._replace(sorted_emb=jnp.asarray(emb_q)), num_beams=NB,
        cap=CAP, pool=POOL, inv_scale=1.0 / scale)
    tfine = S["tfine"]._replace(sorted_emb=torch.from_numpy(emb_t))
    ts = tserve.BucketServer(S["tq"], S["tnci"], tfine, num_beams=NB,
                             cap=CAP, pool=POOL, inv_scale=1.0 / scale,
                             device="cpu")
    j = js.query(jnp.asarray(S["ids"]), jnp.asarray(S["mask"]))
    t = ts.query(T(S["ids"]), T(S["mask"]))
    np.testing.assert_array_equal(t[2], j[2])
    assert_pool_equal(t[0], t[1], j[0], j[1], 1e-3)


def test_quantize_int8_torch_matches_numpy(setup):
    emb = setup["emb"]
    q_np, s_np = quantize_int8(emb)
    q_t, s_t = quantize_int8(torch.from_numpy(emb))
    np.testing.assert_array_equal(q_t.numpy(), q_np)
    assert s_t == s_np
