"""Port parity: PAWA prefix tables, the beam's ``pawa_tables`` branch and
``BucketServer(pawa_tables=True)`` against ``mevi_tpu`` on the same
weights, float32 on the CPU.

Tolerances: tables and scores 2e-5 (tests/test_beam.py's tables tests);
beam codes equal.  The deep fixture mirrors tests/test_beam.py's
``setup_deep`` (kary 4, M 4: levels 1 and 2 are table-skippable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.decode import beam as jbeam
from mevi_tpu.models import nci as jnci
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu_torch.decode import beam as tbeam
from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.models import nci as tnci
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.serve import BucketServer
from mevi_tpu_torch.weights import init_random_, load_flax_params

ATOL = 2e-5
KARY, M = 4, 4


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def T(x):
    return torch.from_numpy(np.array(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


T5KW = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
            num_layers=1, num_decoder_layers=2)
NKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=2,
           adaptor_num_heads=4, adaptor_d_ff=32)


@pytest.fixture(scope="module")
def deep():
    jmodel = jnci.NCIT5(jnci.NCIDims(t5=JT5Dims(dropout_rate=0.0, **T5KW),
                                     **NKW))
    rng = np.random.default_rng(5)
    ids = rng.integers(2, 60, size=(3, 6)).astype(np.int32)
    mask = np.ones_like(ids)
    params = jmodel.init(jax.random.PRNGKey(11), jnp.asarray(ids),
                         jnp.asarray(mask),
                         jnp.zeros((3, M + 2), jnp.int32))["params"]
    tmodel = load_flax_params(
        tnci.NCIT5(tnci.NCIDims(t5=T5Dims(**T5KW), **NKW), device="cpu"),
        flat(params))
    jtables = jmodel.apply({"params": params},
                           method=jnci.NCIT5.pawa_prefix_tables)
    return jmodel, params, tmodel, ids, mask, jtables


def test_panel_with_kvs_matches_jax(deep):
    jmodel, params, tmodel, _, _, _ = deep
    x = np.random.default_rng(1).normal(size=(5, 3, 16)).astype(np.float32)
    jh, jkv = jmodel.apply({"params": params}, jnp.asarray(x),
                           method=lambda m, x: m.pawa.panel_with_kvs(x))
    th, tkv = tmodel.pawa.panel_with_kvs(T(x))
    assert tuple(tkv.shape) == jkv.shape == (2, 2, 5, 3, 4, 4)
    close(th, jh)
    close(tkv, jkv)
    close(th, tmodel.pawa(T(x)))          # the plain panel's output


def test_prefix_tables_match_jax(deep):
    _, _, tmodel, _, _, jt = deep
    tt = tmodel.pawa_prefix_tables()
    assert set(tt["T"]) == set(jt["T"]) == {1, 2}
    assert set(tt["KV"]) == {1, 2}
    assert tt["T"][2].shape == (KARY ** 2, 16 * (KARY + 1))
    for t in (1, 2):
        close(tt["T"][t], jt["T"][t])
        for (tk, tv), (jk, jv) in zip(tt["KV"][t], jt["KV"][t]):
            assert tk.shape == jk.shape == (KARY ** t, 4, 4)
            close(tk, jk)
            close(tv, jv)
    close(tt["delta0"], jt["delta0"])
    for (tk, tv), (jk, jv) in zip(tt["e0"], jt["e0"]):
        assert tk.shape == (1, 4, 4)
        close(tk, jk)
        close(tv, jv)
    # built from given level tables: the same tables
    t2 = tmodel.pawa_prefix_tables(tmodel.head_level_tables())
    close(t2["T"][2], tt["T"][2], 0)


@pytest.mark.parametrize("slab_form", ["universal", "rows"])
def test_decode_step_delta_slab_matches_jax(deep, slab_form):
    """``delta_slab`` replaces the PAWA net and its delta matmul: the
    1-D start-position form at t = 0, the per-row form at t = 1."""
    jmodel, params, tmodel, ids, mask, jt = deep
    tt = tmodel.pawa_prefix_tables()
    jenc = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(mask), method=jnci.NCIT5.encode)
    jkv = jmodel.apply({"params": params}, jenc,
                       method=jnci.NCIT5.project_cross_kvs)
    jlt = jmodel.apply({"params": params},
                       method=jnci.NCIT5.head_level_tables)
    tkv = tmodel.project_cross_kvs(tmodel.encode(T(ids), T(mask)))
    tlt = tmodel.head_level_tables()
    step = jnci.NCIT5.decode_logits_step_unrolled
    B = ids.shape[0]
    jl0, jd0, _ = jmodel.apply(
        {"params": params}, jnp.zeros((B, 1), jnp.int32), 0, [], [], jkv,
        jnp.asarray(mask), beams=1, level_tables=(jlt[0][0], jlt[1][0]),
        delta_slab=jt["delta0"], method=step)
    tl0, td0, tp0 = tmodel.decode_logits_step_unrolled(
        torch.zeros((B, 1), dtype=torch.long), 0, [], [], tkv, T(mask),
        beams=1, level_tables=tlt, delta_slab=tt["delta0"])
    assert tp0 is None
    if slab_form == "universal":
        close(tl0, jl0)
        # and the same logits as the net's own step 0
        ref, _, _ = tmodel.decode_logits_step_unrolled(
            torch.zeros((B, 1), dtype=torch.long), 0, [], [], tkv, T(mask),
            beams=1, level_tables=tlt)
        close(tl0, ref)
        return
    nb = 2
    codes = np.array([0, 3, 1, 2, 3, 0])              # (B * nb,) level-0
    tok = (codes + 2).reshape(-1, 1).astype(np.int32)
    jl1, _, _ = jmodel.apply(
        {"params": params}, jnp.asarray(tok), 1, [jd0], None, jkv,
        jnp.asarray(mask), beams=nb, level_tables=(jlt[0][1], jlt[1][1]),
        delta_slab=jt["T"][1][codes], method=step)
    tl1, _, tp1 = tmodel.decode_logits_step_unrolled(
        T(tok), 1, [td0], None, tkv, T(mask), beams=nb, level_tables=tlt,
        delta_slab=tt["T"][1][T(codes)])
    assert tp1 is None
    close(tl1, jl1)


@pytest.mark.parametrize("nb", [3, 6])
def test_tables_beam_exact(deep, nb):
    """Tables beam = the port's plain beam = JAX's tables beam (codes
    equal, scores within 2e-5)."""
    jmodel, params, tmodel, ids, mask, jt = deep
    tt = tmodel.pawa_prefix_tables()
    jc, js, _ = jbeam.nci_beam_search_incremental(
        jmodel, params, jnp.asarray(ids), jnp.asarray(mask), nb,
        pawa_tables=jt)
    c1, s1, _ = tbeam.nci_beam_search_incremental(tmodel, T(ids), T(mask),
                                                  nb)
    c2, s2, _ = tbeam.nci_beam_search_incremental(
        tmodel, T(ids), T(mask), nb, pawa_tables=tt)
    np.testing.assert_array_equal(c2.numpy(), c1.numpy())
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc))
    close(s2, s1)
    close(s2, js)


def test_tables_beam_matches_panel(deep):
    """Tables beam vs the panel decoders (an independent formulation),
    the port's and JAX's."""
    jmodel, params, tmodel, ids, mask, jt = deep
    tt = tmodel.pawa_prefix_tables()
    jc, js, _, _ = jbeam.nci_beam_search(jmodel, params, jnp.asarray(ids),
                                         jnp.asarray(mask), 4)
    pc, ps, _, _ = tbeam.nci_beam_search(tmodel, T(ids), T(mask), 4)
    c2, s2, _ = tbeam.nci_beam_search_incremental(
        tmodel, T(ids), T(mask), 4, pawa_tables=tt)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(c2.numpy(), pc.numpy())
    close(s2, js)
    close(s2, ps)


def test_tables_reject_partial_coverage(deep):
    """kary^(M-2) > max_entries raises, as the JAX package does."""
    jmodel, params, tmodel, _, _, _ = deep
    with pytest.raises(ValueError, match="partial prefix"):
        tmodel.pawa_prefix_tables(max_entries=4)      # 4^2 > 4
    with pytest.raises(ValueError, match="partial prefix"):
        jmodel.apply({"params": params}, max_entries=4,
                     method=jnci.NCIT5.pawa_prefix_tables)
    assert set(tmodel.pawa_prefix_tables(max_entries=16)["T"]) == {1, 2}


def _server_pair(nci, kary, levels, seed, **kw):
    rng = np.random.default_rng(seed)
    q = init_random_(T5Model(T5Dims(**T5KW), device="cpu"), seed)
    codes = rng.integers(0, kary, size=(256, levels)).astype(np.int32)
    emb = rng.normal(size=(256, 16)).astype(np.float32)
    fine = build_fine_index(codes, emb, kary, device="cpu")
    kw = dict(num_beams=3, cap=32, pool=20, device="cpu", **kw)
    ids = T(rng.integers(2, 60, size=(5, 6)).astype(np.int32))
    mask = torch.ones_like(ids)
    return (BucketServer(q, nci, fine, **kw),
            BucketServer(q, nci, fine, pawa_tables=True, **kw), ids, mask)


def _assert_served_equal(a, b):
    np.testing.assert_array_equal(a[2], b[2])           # codes
    close(a[3], b[3])                                   # beam scores
    np.testing.assert_array_equal(a[4], b[4])           # ndoc
    close(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("rank_mode", ["score", "beam_major"])
def test_bucket_server_tables_equal_default(deep, rank_mode):
    tmodel = deep[2]
    plain, tab, ids, mask = _server_pair(tmodel, KARY, M, 3,
                                         rank_mode=rank_mode)
    assert plain.pawa_tables is None
    assert set(tab.pawa_tables["T"]) == {1, 2}
    _assert_served_equal(tab.query(ids, mask), plain.query(ids, mask))


def test_bucket_server_partial_coverage_serves_plain(capsys):
    """kary 2 and M 20: 2^18 entries exceed the tables' limit, so the
    server says so, keeps ``pawa_tables`` None and serves the plain
    beam."""
    kary, levels = 2, 20
    nkw = dict(NKW, kary=kary, max_output_length=levels + 2)
    nci = init_random_(tnci.NCIT5(tnci.NCIDims(t5=T5Dims(**T5KW), **nkw),
                                  device="cpu"), 4)
    plain, tab, ids, mask = _server_pair(nci, kary, levels, 4)
    assert "PAWA prefix tables disabled" in capsys.readouterr().err
    assert tab.pawa_tables is None
    _assert_served_equal(tab.query(ids, mask), plain.query(ids, mask))


def test_bucket_server_tables_need_pawa():
    nkw = dict(NKW, use_pawa=False)
    nci = init_random_(tnci.NCIT5(tnci.NCIDims(t5=T5Dims(**T5KW), **nkw),
                                  device="cpu"), 6)
    plain, tab, ids, mask = _server_pair(nci, KARY, M, 6)
    assert tab.pawa_tables is None
    _assert_served_equal(tab.query(ids, mask), plain.query(ids, mask))
