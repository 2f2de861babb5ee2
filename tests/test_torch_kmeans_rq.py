"""The port's k-means and RQ/PQ (``mevi_tpu_torch.ops.kmeans``,
``mevi_tpu_torch.ops.rq``) against the JAX package's, float32 on the
CPU, on the same seeded numpy inputs.

Discrete outputs (assignments, codes, beam codes) are equal.  Float
outputs are within rtol 1e-5 / atol 1e-5 (float32 sums of the same
products in another order; float32 rounding of values of order 10).
The JAX random draws (k-means++ seeds, the subsample chunks, the
empty-cluster restart slice) cannot be matched, so the parity tests
give both sides the same initial centroids on data where no cluster
empties, and the seeding and restart are tested by their properties
and for determinism under a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.ops import kmeans as jk
from mevi_tpu.ops import rq as jrq
from mevi_tpu_torch.ops import kmeans as tk
from mevi_tpu_torch.ops import rq as trq

RTOL = ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    cbs = rng.normal(size=(3, 8, 16)).astype(np.float32)
    return x, cbs


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist_mode", ["l2", "ip"])
def test_sim_equal(data, dist_mode):
    x, cbs = data
    close(tk._sim(T(x), T(cbs[0]), dist_mode),
          jk._sim(jnp.asarray(x), jnp.asarray(cbs[0]), dist_mode))


@pytest.mark.parametrize("dist_mode", ["l2", "ip"])
@pytest.mark.parametrize("chunk", [64, 65536])
def test_kmeans_assign_equal(data, dist_mode, chunk):
    x, cbs = data
    got = tk.kmeans_assign(T(x), T(cbs[1]), dist_mode, chunk)
    assert got.dtype == torch.int32
    equal(got, jk.kmeans_assign(jnp.asarray(x), jnp.asarray(cbs[1]),
                                dist_mode, chunk))


@pytest.mark.parametrize("chunk", [64, 65536])
def test_kmeans_stats_equal(data, chunk):
    x, _ = data
    a = np.random.default_rng(1).integers(0, 6, len(x)).astype(np.int32)
    s_t, c_t = tk.kmeans_stats(T(x), T(a), 6, chunk)
    s_j, c_j = jk.kmeans_stats(jnp.asarray(x), jnp.asarray(a), 6, chunk)
    close(s_t, s_j)
    equal(c_t, c_j)


@pytest.mark.parametrize("dist_mode", ["l2", "ip"])
def test_kmeans_fit_given_init_equal(data, dist_mode):
    x, _ = data
    init = x[:6]
    st = {}
    c_t, a_t = tk.kmeans_fit(x, 6, iters=5, dist_mode=dist_mode, chunk=128,
                             init_centroids=init, stats=st, device="cpu")
    c_j, a_j = jk.kmeans_fit(jnp.asarray(x), 6, iters=5, dist_mode=dist_mode,
                             chunk=128, init_centroids=jnp.asarray(init))
    assert st == {"lloyd_iters": 5, "restarts": 0}
    close(c_t, c_j)
    equal(a_t, a_j)


def _seeded_fit(x, seed, **kw):
    g = torch.Generator().manual_seed(seed)
    return tk.kmeans_fit(x, 5, iters=4, generator=g, device="cpu", **kw)


@pytest.mark.parametrize("init_sample", [262144, 64])
def test_kmeans_fit_seeded_is_deterministic(data, init_sample):
    x, _ = data
    c1, a1 = _seeded_fit(x, 3, init_sample=init_sample)
    c2, a2 = _seeded_fit(x, 3, init_sample=init_sample)
    equal(c1, c2)
    equal(a1, a2)
    c3, _ = _seeded_fit(x, 4, init_sample=init_sample)
    assert not torch.equal(c1, c3)


def test_plusplus_init_picks_distinct_spread_rows():
    """k-means++ seeds are corpus rows, one in each of k far-apart
    blobs (D² sampling with greedy candidates)."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, 8)).astype(np.float32) * 20
    x = (centers[rng.integers(0, 6, 600)]
         + rng.normal(size=(600, 8)).astype(np.float32) * 0.1)
    seeds = tk.kmeans_plusplus_init(T(x), 6, torch.Generator().manual_seed(0))
    seeds = seeds.numpy()
    row = ((seeds[:, None] - x[None]) ** 2).sum(-1)
    assert (row.min(1) == 0).all()                    # every seed is a row
    blob = ((seeds[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
    assert sorted(blob) == list(range(6))


def test_empty_cluster_restarts_from_a_contiguous_slice():
    """A centroid far from every row empties; the iteration restarts it
    at a corpus row and the fit reports the restart."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(100, 4)).astype(np.float32)
    init = np.concatenate([x[:3], np.full((1, 4), 1e3, np.float32)])
    st = {}
    c, a = tk.kmeans_fit(x, 4, iters=1, init_centroids=init, stats=st,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert st["restarts"] == 1
    assert (((c[3].numpy() - x) ** 2).sum(-1) == 0).any()
    assert a.shape == (100,) and a.dtype == torch.int32


def test_kmeans_fit_recovers_separated_clusters():
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 10
    lab = rng.integers(0, 5, 500)
    x = centers[lab] + rng.normal(size=(500, 8)).astype(np.float32) * 0.1
    _, a = _seeded_fit(x, 0)
    a = a.numpy()
    # same partition up to relabelling
    assert len({(int(i), int(j)) for i, j in zip(lab, a)}) == 5


# ---------------------------------------------------------------------------
# RQ / PQ assignment, reconstruction, beam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist_mode", ["l2", "ip"])
def test_full_sim_equal(data, dist_mode):
    x, cbs = data
    close(trq.full_sim(T(x), T(cbs[0]), dist_mode),
          jrq.full_sim(jnp.asarray(x), jnp.asarray(cbs[0]), dist_mode))


@pytest.mark.parametrize("dist_mode", ["l2", "ip"])
@pytest.mark.parametrize("pq_type", ["rq", "pq"])
def test_assign_with_logits_equal(data, dist_mode, pq_type):
    x, cbs = data
    if pq_type == "pq":
        cbs = cbs[:, :, :4].copy()
        x = x[:, :12]
    c_t, l_t = trq.assign_with_logits(T(x), T(cbs), pq_type, dist_mode)
    c_j, l_j = jrq.assign_with_logits(jnp.asarray(x), jnp.asarray(cbs),
                                      pq_type, dist_mode)
    assert c_t.dtype == torch.int32
    equal(c_t, c_j)
    close(l_t, l_j)
    equal(trq.assign(T(x), T(cbs), pq_type, dist_mode), c_j)


@pytest.fixture(scope="module")
def centered():
    """A center_levels quantizer trained by the JAX package (K 4, M 3,
    300 rows: every prefix holds several rows)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    cbs, codes, shifts = jrq.rq_train(jnp.asarray(x), 3, 4, iters=4,
                                      key=jax.random.PRNGKey(1),
                                      center_levels=True)
    return x, np.asarray(cbs), np.asarray(codes), [np.asarray(t)
                                                   for t in shifts]


def test_assign_with_prefix_shift_equal(centered):
    x, cbs, codes, shifts = centered
    c_t, l_t = trq.assign_with_logits(T(x), T(cbs), "rq", "l2",
                                      [T(t) for t in shifts])
    c_j, l_j = jrq.assign_with_logits(jnp.asarray(x), jnp.asarray(cbs),
                                      "rq", "l2",
                                      [jnp.asarray(t) for t in shifts])
    equal(c_t, c_j)
    equal(c_t, codes)
    close(l_t, l_j)


@pytest.mark.parametrize("shifted", [False, True])
def test_reconstruct_equal(centered, shifted):
    x, cbs, codes, shifts = centered
    sh_t = [T(t) for t in shifts] if shifted else None
    sh_j = [jnp.asarray(t) for t in shifts] if shifted else None
    close(trq.reconstruct(T(codes), T(cbs), "rq", sh_t),
          jrq.reconstruct(jnp.asarray(codes), jnp.asarray(cbs), "rq", sh_j))


def test_reconstruct_pq_equal(data):
    x, cbs = data
    codes = np.random.default_rng(6).integers(0, 8, (50, 3)).astype(np.int32)
    close(trq.reconstruct(T(codes), T(cbs), "pq"),
          jrq.reconstruct(jnp.asarray(codes), jnp.asarray(cbs), "pq"))


@pytest.mark.parametrize("chunk", [64, 65536])
def test_reconstruction_mse_equal(centered, chunk):
    x, cbs, codes, shifts = centered
    got = trq.reconstruction_mse(T(x), T(codes), T(cbs), "rq", chunk)
    close(got, jrq.reconstruction_mse(jnp.asarray(x), jnp.asarray(codes),
                                      jnp.asarray(cbs), "rq", chunk))
    # with the shift tables: the mean of the plain squared error
    rec = trq.reconstruct(T(codes), T(cbs), "rq", [T(t) for t in shifts])
    got_s = trq.reconstruction_mse(T(x), T(codes), T(cbs), "rq", chunk,
                                   [T(t) for t in shifts])
    close(got_s, ((x - rec.numpy()) ** 2).mean())


@pytest.mark.parametrize("B", [1, 5, 10])
@pytest.mark.parametrize("pq_type", ["rq", "pq"])
def test_beam_search_equal(data, B, pq_type):
    x, cbs = data
    if pq_type == "pq":
        cbs = cbs[:, :, :4].copy()
        x = x[:, :12]
    c_t, s_t = trq.beam_search(T(x[:60]), T(cbs), B, pq_type)
    c_j, s_j = jrq.beam_search(jnp.asarray(x[:60]), jnp.asarray(cbs), B,
                               pq_type)
    equal(c_t, c_j)
    close(s_t, s_j)


@pytest.mark.parametrize("B", [1, 3])
def test_beam_search_prefix_shift_equal(centered, B):
    x, cbs, codes, shifts = centered
    c_t, s_t = trq.beam_search(T(x), T(cbs), B,
                               prefix_shift=[T(t) for t in shifts])
    c_j, s_j = jrq.beam_search(jnp.asarray(x), jnp.asarray(cbs), B,
                               prefix_shift=[jnp.asarray(t) for t in shifts])
    equal(c_t, c_j)
    close(s_t, s_j)
    if B == 1:
        equal(c_t[:, 0], codes)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _init(x, K, M, d, unit_last=False):
    init = np.stack([x[i * K:(i + 1) * K, :d] for i in range(M)])
    if unit_last:
        init[-1] /= np.linalg.norm(init[-1], axis=-1, keepdims=True)
    return init


@pytest.mark.parametrize("pq_type,center", [("rq", False), ("pq", False),
                                            ("rq", True)])
def test_rq_train_given_init_equal(pq_type, center):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    K, M = 4, 3
    d = 16 if pq_type == "rq" else 16 // M
    x = x[:, :d * M] if pq_type == "pq" else x
    init = _init(x, K, M, d, unit_last=center)
    stats = []
    out_t = trq.rq_train(x, M, K, iters=4, pq_type=pq_type,
                         init_codebooks=init, center_levels=center,
                         level_stats=stats, device="cpu")
    out_j = jrq.rq_train(jnp.asarray(x), M, K, iters=4, pq_type=pq_type,
                         init_codebooks=jnp.asarray(init),
                         center_levels=center)
    assert [s["restarts"] for s in stats] == [0] * M
    assert [s["level"] for s in stats] == list(range(M))
    assert len(out_t) == len(out_j)
    close(out_t[0], out_j[0])
    equal(out_t[1], out_j[1])
    assert out_t[1].dtype == torch.int32
    if center:
        assert [t.shape for t in out_t[2]] == [(K, 16), (K * K, 16)]
        for a, b in zip(out_t[2], out_j[2]):
            close(a, b)
        # the codes are the conditioned assignment of the rows
        equal(trq.assign(T(x), out_t[0], prefix_shift=out_t[2]), out_t[1])


def test_rq_train_bf16_keeps_dtype_and_codes_match_assign():
    """A bf16 corpus trains in bf16 (float32 products) and its codes
    equal the plain assignment with the trained codebooks."""
    rng = np.random.default_rng(8)
    x = T(rng.normal(size=(400, 16)).astype(np.float32)).to(torch.bfloat16)
    cbs, codes = trq.rq_train(x, 2, 4, iters=5, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    assert cbs.dtype == torch.bfloat16
    equal(trq.assign(x, cbs), codes)


def test_opq_train_given_same_first_codebooks_equal(monkeypatch):
    """Both sides seeded from the first k rows (k-means++ replaced on
    each side by the same rule): rotation, codebooks and codes equal."""
    def first_rows_np(x, k, *a, **kw):
        return x[:k]
    monkeypatch.setattr(jk, "kmeans_plusplus_init", first_rows_np)
    monkeypatch.setattr(tk, "kmeans_plusplus_init", first_rows_np)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    R_t, cb_t, c_t = trq.opq_train(x, 2, 4, iters=3, inner_iters=3,
                                   device="cpu")
    R_j, cb_j, c_j = jrq.opq_train(jnp.asarray(x), 2, 4, iters=3,
                                   inner_iters=3)
    close(R_t, R_j, rtol=1e-4, atol=1e-4)   # float64 SVD of float32 sums
    close(cb_t, cb_j, rtol=1e-4, atol=1e-4)
    equal(c_t, c_j)
    np.testing.assert_allclose(R_t @ R_t.T, np.eye(8), atol=1e-5)


def test_align_codebooks_equal():
    rng = np.random.default_rng(10)
    old = rng.normal(size=(2, 6, 4)).astype(np.float32)
    new = old[:, rng.permutation(6)] + 0.01 * rng.normal(
        size=(2, 6, 4)).astype(np.float32)
    for mode in ("l2", "ip"):
        got = trq.align_codebooks(old, new, mode)
        equal(got, jrq.align_codebooks(old, new, mode))
    np.testing.assert_allclose(trq.align_codebooks(old, new), old, atol=0.05)
