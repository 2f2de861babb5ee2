"""The port's multi-device retrieval path against the JAX package's, on
the CPU: four gloo ranks (``mevi_tpu_torch.parallel.mesh.launch_local``,
one spawn for the module) against the JAX functions on the 8-device
``mesh8`` (data 2 x corpus 4).

Cases: mesh groups and coordinates (2 x 2, 1 x 4, 4 x 1, against the JAX
grid's order); ``shard_rows`` padding; ``sharded_mips_topk`` on
``test_mips.py``'s two cases and the pad-row fix; ``sharded_fine_rerank``
on ``test_searcher.py``'s problem and on a tie that straddles a shard
boundary; the sharded server over a float32 and an int8 corpus;
``make_sharded_rep_fn``; cross-device ``contrastive_loss`` (loss, scores
and gradients); the dry run module.

Tolerances: discrete outputs (ids, codes, rows) equal; float32 at the
JAX package's 2e-5, scores after a merge at 1e-4 (the int8 corpus's
scores, which reach ~1e3, at a relative 1e-6 besides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as R
from mevi_tpu import serve as jserve
from mevi_tpu.eval import searcher as jsearch
from mevi_tpu.index.build import embed_corpus as jembed
from mevi_tpu.index.build import make_sharded_rep_fn as jsharded_rep
from mevi_tpu.index.build import quantize_int8
from mevi_tpu.index.csr import build_csr, unpack_codes
from mevi_tpu.models import twin_tower as jtt
from mevi_tpu.models.nci import NCIDims as JNCIDims
from mevi_tpu.models.nci import NCIT5 as JNCIT5
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu.models.t5 import T5Model as JT5Model
from mevi_tpu.ops.mips import sharded_mips_topk as jsharded_mips
from mevi_tpu.parallel.mesh import DATA_AXIS
from mevi_tpu.parallel.mesh import make_mesh as jmake_mesh
from mevi_tpu.parallel.mesh import shard_rows as jshard_rows
from mevi_tpu_torch.parallel import dryrun
from mevi_tpu_torch.parallel.mesh import launch_local

F32, MERGED = 2e-5, 1e-4
SHAPES = [(2, 2), (1, 4), (4, 1)]
KARY, M = 4, 2
SERVE_KW = dict(num_beams=3, cap=32, pool=20)
T5KW = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
            num_layers=1, num_decoder_layers=1)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
             adaptor_num_heads=4, adaptor_d_ff=32)


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def brute(Q, D, k):
    s = Q @ D.T
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, 1), ids


def assert_pool_equal(s_t, i_t, s_j, i_j, atol, rtol=0.0):
    """Scores close; ids equal wherever a score stands apart from its
    neighbours, equal as sets inside each run of tied scores (a run cut
    by the end of the pool is skipped)."""
    s_t, s_j = np.asarray(s_t, np.float64), np.asarray(s_j, np.float64)
    i_t, i_j = np.asarray(i_t), np.asarray(i_j)
    np.testing.assert_allclose(s_t, s_j, atol=atol, rtol=rtol)
    tol = atol + rtol * np.abs(s_j)
    for b in range(s_j.shape[0]):
        runs = np.concatenate([[0], np.nonzero(
            np.abs(np.diff(s_j[b])) > tol[b, 1:])[0] + 1, [s_j.shape[1]]])
        for lo, hi in zip(runs[:-1], runs[1:]):
            if hi == s_j.shape[1] and hi - lo > 1:
                continue
            assert sorted(i_t[b, lo:hi]) == sorted(i_j[b, lo:hi]), (b, lo)


# ---------------------------------------------------------------------------
# inputs, made once from seeds with numpy (weights from the JAX init)
# ---------------------------------------------------------------------------

def _searcher_problem():
    """``test_searcher.py``'s problem (400 rows, kary 4, M 3)."""
    rng = np.random.default_rng(0)
    n, d, kary, M3 = 400, 16, 4, 3
    emb = rng.normal(size=(n, d)).astype(np.float32)
    doc_codes = rng.integers(0, kary, size=(n, M3)).astype(np.int32)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    beams = rng.integers(0, kary, size=(6, 5, M3)).astype(np.int32)
    return emb, doc_codes, queries, beams


def _tie_problem():
    """A cluster whose CSR range straddles row 200 (a shard boundary of
    both corpus 2 and corpus 4) holds identical rows that score highest
    for query 0: the pool's order inside the tie is the rows' order, so
    the lower shard's rows come first."""
    emb, doc_codes, queries, beams = _searcher_problem()
    offsets, doc_ids = build_csr(doc_codes, 4)
    c = int(np.searchsorted(offsets, 200, side="right") - 1)
    s, e = int(offsets[c]), int(offsets[c + 1])
    assert s < 200 < e, (s, e)
    emb = emb.copy()
    emb[doc_ids[s:e]] = 10.0 * queries[0]
    beams = beams.copy()
    beams[0, 2] = unpack_codes(np.array(c), 3, 4)
    return emb, doc_codes, queries, beams


def _server_setup():
    """``test_serve.py``'s fixture: T5 1 + 1, d 16, kary 4, M 2."""
    rng = np.random.default_rng(5)
    jt5 = JT5Dims(dropout_rate=0.0, **T5KW)
    jnci, jq = JNCIT5(JNCIDims(t5=jt5, **NCIKW)), JT5Model(jt5)
    ids = rng.integers(2, 60, size=(8, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 4:] = 0
    nci_params = jax.jit(jnci.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        jnp.zeros((8, M + 2), jnp.int32))["params"]
    q_params = jax.jit(jq.init)(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask),
        jnp.zeros((8, 1), jnp.int32))["params"]
    emb = rng.normal(size=(256, 16)).astype(np.float32)
    codes = rng.integers(0, KARY, size=(256, M)).astype(np.int32)
    fine = jsearch.build_fine_index(codes, emb, KARY)
    return dict(jnci=jnci, jq=jq, nci_params=nci_params, q_params=q_params,
                ids=ids, mask=mask, fine=fine)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    Q1 = rng.normal(size=(8, 64)).astype(np.float32)
    D1 = rng.normal(size=(1000, 64)).astype(np.float32)
    Q2 = rng.normal(size=(2, 32)).astype(np.float32)
    D2 = rng.normal(size=(998, 32)).astype(np.float32) + 1.0
    # every score negative: the zero pad rows would win in JAX
    Q3 = np.abs(rng.normal(size=(4, 16))).astype(np.float32)
    D3 = -np.abs(rng.normal(size=(997, 16))).astype(np.float32) - 0.1
    sv = _server_setup()
    fine = sv["fine"]
    semb = np.asarray(fine.sorted_emb)
    semb_q, _ = quantize_int8(semb)
    rep_rng = np.random.default_rng(3)
    rep_tokens = rep_rng.integers(2, 60, size=(11, 6)).astype(np.int32)
    rep_masks = np.ones_like(rep_tokens)
    rep_masks[3, 3:] = 0
    co_rng = np.random.default_rng(4)
    inp = {
        "shapes": SHAPES,
        "shard_rows": {n: rng.normal(size=(n, 8)).astype(np.float32)
                       for n in (1000, 998)},
        "mips": {"1000_rows": (Q1, D1, 10, 64), "998_rows": (Q2, D2, 5, 128),
                 "pad_rows": (Q3, D3, 8, 128)},
        "rerank": {"problem": _searcher_problem() + (4, 64, 20),
                   "tie_at_boundary": _tie_problem() + (4, 64, 20)},
        "t5": T5KW, "nci": NCIKW,
        "nci_params": flat(sv["nci_params"]),
        "q_params": flat(sv["q_params"]),
        "server": {"ids": sv["ids"], "mask": sv["mask"],
                   "offsets": np.asarray(fine.offsets),
                   "doc_ids": np.asarray(fine.doc_ids), "levels": M,
                   "semb": {"f32": semb, "int8": semb_q}, "kw": SERVE_KW},
        "rep_tokens": rep_tokens, "rep_masks": rep_masks,
        "rep_batches": (4, 3),
        "co_q": co_rng.normal(size=(8, 4)).astype(np.float32),
        "co_p": co_rng.normal(size=(16, 4)).astype(np.float32),
    }
    return inp, sv


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    inp, _ = inputs
    return launch_local(R.retrieval_rank, 4, "gloo", "cpu", inp,
                        workdir=str(tmp_path_factory.mktemp("store")))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_groups_and_coords(ranks, shape):
    data, corpus = shape
    grid = np.asarray([d.id for d in jmake_mesh(
        n_devices=4, corpus=corpus).devices.flat]).reshape(data, corpus)
    for r, res in enumerate(ranks):
        g = res["groups"][shape]
        d, c = divmod(r, corpus)
        assert g["coords"] == (d, c)
        assert grid[d, c] == r          # the JAX grid's row-major order
        assert g["data"] == [dd * corpus + c for dd in range(data)]
        assert g["corpus"] == [d * corpus + cc for cc in range(corpus)]


@pytest.mark.parametrize("n", [1000, 998])
def test_shard_rows_padding(ranks, inputs, mesh8, n):
    """Corpus 4 (the 1 x 4 mesh): rank i holds JAX's shard i, zero pad
    rows included."""
    x = inputs[0]["shard_rows"][n]
    js = jshard_rows(x, mesh8)
    want = {sh.index[0].start: np.asarray(sh.data)
            for sh in js.addressable_shards}
    starts = sorted(want)
    assert len(starts) == 4
    for i, res in enumerate(ranks):
        got = res["shard_rows"][n]
        np.testing.assert_array_equal(got, want[starts[i]])
        assert got.shape[0] == -(-n // 4)
    pad = -n % 4
    if pad:
        assert (ranks[-1]["shard_rows"][n][-pad:] == 0).all()


# ---------------------------------------------------------------------------
# sharded MIPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["1000_rows", "998_rows"])
def test_sharded_mips_matches_jax(ranks, inputs, mesh8, name):
    Q, D, k, chunk = inputs[0]["mips"][name]
    js, ji = jsharded_mips(jnp.asarray(Q), jshard_rows(D, mesh8), k=k,
                           mesh=mesh8, chunk=chunk)
    rs, ri = brute(Q, D, k)
    for res in ranks:
        s, i = res["mips"][name]
        np.testing.assert_allclose(s, np.asarray(js), atol=F32, rtol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(s, rs, rtol=1e-5)


def test_sharded_mips_skips_pad_rows(ranks, inputs, mesh8):
    """Every real score is negative: JAX's zero pad rows (score 0) come
    first with ids past the corpus; the port returns the true top-k."""
    Q, D, k, chunk = inputs[0]["mips"]["pad_rows"]
    _, ji = jsharded_mips(jnp.asarray(Q), jshard_rows(D, mesh8), k=k,
                          mesh=mesh8, chunk=chunk)
    assert (np.asarray(ji) >= D.shape[0]).any()      # the JAX fault
    rs, ri = brute(Q, D, k)
    for res in ranks:
        s, i = res["mips"]["pad_rows"]
        assert (i < D.shape[0]).all()
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(s, rs, rtol=1e-5)


# ---------------------------------------------------------------------------
# sharded fine rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["problem", "tie_at_boundary"])
def test_sharded_fine_rerank_matches_jax(ranks, inputs, mesh8, name):
    emb, doc_codes, queries, beams, kary, cap, pool = \
        inputs[0]["rerank"][name]
    index = jsearch.build_fine_index(doc_codes, emb, kary)
    s1, i1, n1 = jsearch.fine_rerank(
        jnp.asarray(queries), jnp.asarray(beams), index.offsets,
        index.doc_ids, index.sorted_emb, kary, cap=cap, pool=pool)
    qs = jnp.asarray(np.concatenate([queries, queries[:2]]))  # 8 rows
    bs = jnp.asarray(np.concatenate([beams, beams[:2]]))
    rerank = jax.jit(lambda q, b, off, ids, semb: jsearch.sharded_fine_rerank(
        q, b, jsearch.FineIndex(off, ids, semb, index.levels, kary), mesh8,
        cap=cap, pool=pool))
    s2, i2, n2 = rerank(qs, bs, index.offsets, index.doc_ids,
                        jshard_rows(np.asarray(index.sorted_emb), mesh8))
    s2, i2, n2 = (np.asarray(x)[:6] for x in (s2, i2, n2))
    for res in ranks:
        s, i, n = res["rerank"][name]
        np.testing.assert_array_equal(n, n2)
        np.testing.assert_array_equal(n, np.asarray(n1))
        np.testing.assert_allclose(s, s2, atol=MERGED, rtol=0)
        if name == "tie_at_boundary":
            # exact ties straddle the shard boundary: the order is JAX's,
            # sharded and single-device, lower shard first
            np.testing.assert_array_equal(i, i2)
            np.testing.assert_array_equal(i, np.asarray(i1))
            assert np.isclose(s[0, 0], s[0, 1])
        else:
            assert_pool_equal(s, i, s2, i2, MERGED)


# ---------------------------------------------------------------------------
# sharded server
# ---------------------------------------------------------------------------

def _jax_server(sv, semb, mesh8):
    server = jserve.make_sharded_server(sv["jq"], sv["jnci"], mesh8,
                                        **SERVE_KW)
    fine = sv["fine"]
    return [np.asarray(x) for x in server(
        sv["q_params"], sv["nci_params"], jnp.asarray(sv["ids"]),
        jnp.asarray(sv["mask"]), fine.offsets, fine.doc_ids,
        jshard_rows(semb, mesh8))]


@pytest.mark.parametrize("corpus", ["f32", "int8"])
def test_sharded_server_matches_jax(ranks, inputs, mesh8, corpus):
    inp, sv = inputs
    js, ji, jc, jb = _jax_server(sv, inp["server"]["semb"][corpus], mesh8)
    rtol = 1e-6 if corpus == "int8" else 0.0
    for r, res in enumerate(ranks):
        s, i, c, b = res["server"][corpus]
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(b, jb, atol=F32, rtol=1e-5)
        assert_pool_equal(s, i, js, ji, MERGED, rtol)
        # a rank's own slice is its corpus group's: equal across it
        np.testing.assert_array_equal(
            res["server"][corpus + "_local_ids"],
            ranks[r ^ 1]["server"][corpus + "_local_ids"])
    if corpus == "f32":   # and the single-device server's result
        s1, i1, c1, _ = jserve.serve_batch(
            sv["jq"], sv["jnci"], sv["q_params"], sv["nci_params"],
            jnp.asarray(sv["ids"]), jnp.asarray(sv["mask"]),
            sv["fine"].offsets, sv["fine"].doc_ids, sv["fine"].sorted_emb,
            **SERVE_KW)
        s, i, c, _ = ranks[0]["server"][corpus]
        np.testing.assert_array_equal(c, np.asarray(c1))
        assert_pool_equal(s, i, s1, i1, MERGED)


# ---------------------------------------------------------------------------
# sharded corpus embedding, cross-device negatives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [4, 3])
def test_sharded_rep_fn_matches_jax(ranks, inputs, mesh8, batch):
    """Batch 4 divides data 2 (ragged last batch of 3 in the port);
    batch 3 pads inside ``make_sharded_rep_fn``.  The JAX side runs batch
    4 (its batches must divide the mesh's data axis)."""
    inp, sv = inputs
    jq = sv["jq"]
    rep = jax.jit(lambda i, m: jq.apply({"params": sv["q_params"]}, i, m,
                                        method=JT5Model.first_token_rep))
    want = jembed(jsharded_rep(rep, mesh8), inp["rep_tokens"],
                  inp["rep_masks"], batch_size=4)
    for res in ranks:
        np.testing.assert_allclose(res["rep"][batch], want, atol=F32,
                                   rtol=0)


def test_cross_device_contrastive_loss(ranks, inputs, mesh8):
    """Loss and scores of the gathered batch on every rank; each rank
    backpropagates its share (loss / data), so the local gradients are
    JAX's ``shard_map`` gradients (``test_twin_tower.py:51``)."""
    inp, _ = inputs
    q, p = jnp.asarray(inp["co_q"]), jnp.asarray(inp["co_p"])

    def local(q, p):
        return jtt.contrastive_loss(q, p, axis_name=DATA_AXIS)

    fn = jax.shard_map(local, mesh=mesh8,
                       in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
                       out_specs=(P(), P(None, None)), check_vma=False)
    loss, scores = fn(q, p)
    gq, gp = jax.grad(lambda a, b: fn(a, b)[0], argnums=(0, 1))(q, p)
    for res in ranks:
        l, s, (tq, tp) = res["co"]
        np.testing.assert_allclose(l, float(loss), atol=F32)
        np.testing.assert_allclose(s, np.asarray(scores), atol=F32)
        np.testing.assert_allclose(tq, np.asarray(gq), atol=F32)
        np.testing.assert_allclose(tp, np.asarray(gp), atol=F32)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_module(tmp_path, capsys):
    """``python -m mevi_tpu_torch.parallel.dryrun`` in 2 x 2 gloo ranks on
    the CPU, as the JAX ``dryrun_multichip`` runs on its virtual mesh."""
    assert dryrun.main(["--world", "4", "--corpus", "2", "--device", "cpu",
                        "--backend", "gloo"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK on 4 ranks (mesh data=2 "
                           "corpus=2, loss=")
    assert "joint_loss=" in line
