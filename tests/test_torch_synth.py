"""Port parity: ``mevi_tpu_torch.data.synth`` against ``mevi_tpu.data.synth``
on tiny specs, on the CPU.

Host outputs (tables, draws, info positions, query tokens) byte-equal;
generated rows within 1e-6; codes assigned with given codebooks equal;
the sorted fill equal in float32 (1e-6) and in int8 off by at most 1,
only at rounding ties."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.data import synth as jsynth
from mevi_tpu_torch.data import synth as tsynth
from mevi_tpu_torch.index.csr import build_csr
from mevi_tpu_torch.ops import rq as trq

CPU = dict(device="cpu")


def spec_pair(**kw):
    base = dict(ndoc=2000, d=32, kary=8, levels=3, pool_n=64,
                scales=(1.0, 0.4, 0.2), zipf=(1.0, 0.6, 0.3),
                eps=0.05, seed=3, qlen=16, n_filler_vocab=32)
    base.update(kw)
    return jsynth.SynthSpec(**base), tsynth.SynthSpec(**base)


def jtables(tab):
    return (jnp.asarray(tab[0]), jnp.asarray(tab[1]))


@pytest.mark.parametrize("kw", [{}, dict(seed=11, info_dropout=0.3),
                                dict(pool_n=100, kary=4, qlen=24)])
def test_host_outputs_byte_equal(kw):
    js, ts = spec_pair(**kw)
    assert ts.n_info == js.n_info and ts.vocab_size == js.vocab_size
    for a, b in zip(tsynth.make_tables(ts), jsynth.make_tables(js)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    dr = tsynth.make_draws(ts)
    assert dr.tobytes() == jsynth.make_draws(js).tobytes()
    assert (tsynth.info_positions(ts).tobytes()
            == jsynth.info_positions(js).tobytes())
    tok_t = tsynth.query_tokens(ts, dr[:300], np.random.default_rng(5))
    tok_j = jsynth.query_tokens(js, dr[:300], np.random.default_rng(5))
    assert tok_t.dtype == tok_j.dtype and tok_t.tobytes() == tok_j.tobytes()


def test_spec_files_and_cache_base(tmp_path):
    js, ts = spec_pair(info_dropout=0.25)
    p = str(tmp_path / "spec.json")
    tsynth.save_spec(ts, p)
    with open(p) as fr:
        text = fr.read()
    assert jsynth.load_spec(p).cache_dir() == js.cache_dir()
    jsynth.save_spec(js, p)
    with open(p) as fr:
        assert fr.read() == text
    assert dataclasses.asdict(tsynth.load_spec(p)) == dataclasses.asdict(
        jsynth.load_spec(p))
    assert tsynth.load_spec(p).cache_dir() == ts.cache_dir()
    # the port's fits never share the JAX package's cache directory
    assert os.path.basename(ts.cache_dir()) == os.path.basename(
        js.cache_dir())
    assert ts.cache_dir() != js.cache_dir()
    assert ts.cache_dir(str(tmp_path)).startswith(str(tmp_path))
    shift = [np.ones((2, 3), np.float32), np.zeros((4, 3), np.float32)]
    np.savez(str(tmp_path / "s.npz"), l1=shift[0], l2=shift[1])
    for a, b in zip(tsynth.load_prefix_shift(str(tmp_path / "s.npz")),
                    shift):
        np.testing.assert_array_equal(a, b)


def test_gen_rows_matches_jax():
    js, ts = spec_pair()
    tab = tsynth.make_tables(ts)
    dr = tsynth.make_draws(ts)
    want = np.asarray(jsynth.gen_rows(jtables(tab), jnp.asarray(dr)))
    got = tsynth.gen_rows(tsynth.tables_to(tab, "cpu"), dr)
    assert got.dtype == torch.float32 and got.shape == (ts.ndoc, ts.d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("center", [False, True])
def test_fit_with_given_codebooks_matches_jax(tmp_path, center):
    """The ``codebooks=`` (and ``prefix_shift=``) path over a larger
    corpus of the same family gives the JAX package's codes."""
    js, ts = spec_pair()
    tab = tsynth.make_tables(ts)
    dr = tsynth.make_draws(ts)
    cbs, _ = jsynth.fit_rq_codes(js, jtables(tab), dr,
                                 cache_base=str(tmp_path / "fit"),
                                 fit_sample=1000, iters=3,
                                 center_levels=center)
    shift = None
    if center:
        shift = jsynth.load_prefix_shift(os.path.join(
            js.cache_dir(str(tmp_path / "fit")) + "_hrq",
            "prefix_shift.npz"))
    jb, tb = (dataclasses.replace(s, ndoc=3000) for s in (js, ts))
    drb = tsynth.make_draws(tb)
    _, jcodes = jsynth.fit_rq_codes(jb, jtables(tab), drb,
                                    cache_base=str(tmp_path / "j"),
                                    codebooks=cbs, prefix_shift=shift)
    tcbs, tcodes = tsynth.fit_rq_codes(tb, tab, drb,
                                       cache_base=str(tmp_path / "t"),
                                       codebooks=cbs, prefix_shift=shift,
                                       **CPU)
    np.testing.assert_array_equal(tcbs, cbs)
    assert tcodes.dtype == np.int32
    np.testing.assert_array_equal(tcodes, jcodes)


def test_port_fit_cached_and_reloaded(tmp_path):
    _, ts = spec_pair()
    tab = tsynth.make_tables(ts)
    dr = tsynth.make_draws(ts)
    base = str(tmp_path / "cache")
    cbs, codes = tsynth.fit_rq_codes(ts, tab, dr, cache_base=base,
                                     fit_sample=1000, iters=3, **CPU)
    assert cbs.shape == (ts.levels, ts.kary, ts.d)
    assert codes.shape == (ts.ndoc, ts.levels) and codes.dtype == np.int32
    cdir = ts.cache_dir(base)
    assert sorted(os.listdir(cdir)) == ["codebooks.npy", "codes.npy"]
    # the codes are the fitted codebooks' own assignment
    own = trq.assign(tsynth.gen_rows(tsynth.tables_to(tab, "cpu"), dr),
                     torch.from_numpy(cbs)).numpy()
    np.testing.assert_array_equal(codes, own)
    # a second call reads the cache (no fit: an unusable sample size)
    cbs2, codes2 = tsynth.fit_rq_codes(ts, tab, dr, cache_base=base,
                                       fit_sample=0, **CPU)
    np.testing.assert_array_equal(cbs2, cbs)
    np.testing.assert_array_equal(codes2, codes)
    # the same seed refits to the same codebooks
    cbs3, codes3 = tsynth.fit_rq_codes(ts, tab, dr,
                                       cache_base=str(tmp_path / "again"),
                                       fit_sample=1000, iters=3, **CPU)
    np.testing.assert_array_equal(cbs3, cbs)
    np.testing.assert_array_equal(codes3, codes)
    # center_levels: shift tables saved next to the codebooks
    tsynth.fit_rq_codes(ts, tab, dr, cache_base=base, fit_sample=1000,
                        iters=2, center_levels=True, **CPU)
    shift = tsynth.load_prefix_shift(os.path.join(cdir + "_hrq",
                                                  "prefix_shift.npz"))
    assert [t.shape for t in shift] == [(8, 32), (64, 32)]


def _fill_pair(dtype_t, dtype_j, q_scale, chunk):
    js, ts = spec_pair()
    tab = tsynth.make_tables(ts)
    dr = tsynth.make_draws(ts)
    codes = np.random.default_rng(0).integers(
        0, ts.kary, size=(ts.ndoc, ts.levels)).astype(np.int32)
    _, doc_ids = build_csr(codes, ts.kary)
    want = np.asarray(jsynth.fill_sorted_matrix(
        js, jtables(tab), dr, doc_ids, n_pad_rows=13, dtype=dtype_j,
        q_scale=q_scale))
    got = tsynth.fill_sorted_matrix(ts, tab, dr, doc_ids, n_pad_rows=13,
                                    dtype=dtype_t, q_scale=q_scale,
                                    chunk=chunk, **CPU)
    rows = tsynth.gen_rows(tsynth.tables_to(tab, "cpu"),
                           dr[doc_ids]).numpy()
    return got.numpy(), want, rows, ts.ndoc


@pytest.mark.parametrize("chunk", [1 << 16, 300])
def test_sorted_fill_f32_matches_jax(chunk):
    got, want, rows, ndoc = _fill_pair(torch.float32, jnp.float32, None,
                                       chunk)
    assert got.shape == want.shape == (2016, 32)     # 2000 + 13 -> x8
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:ndoc], rows)
    assert (got[ndoc:] == 0).all()


@pytest.mark.parametrize("chunk", [1 << 16, 300])
def test_sorted_fill_int8_matches_jax(chunk):
    """int8 rows equal JAX's except where the scaled value lies within
    1e-4 of a rounding tie, and there by 1."""
    q = 126.0
    got, want, rows, ndoc = _fill_pair(torch.int8, jnp.int8, q, chunk)
    assert got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    frac = np.abs(rows * q) % 1.0
    near_tie = np.zeros_like(got, bool)
    near_tie[:ndoc] = np.abs(frac - 0.5) < 1e-4
    n_diff = int((diff > 0).sum())
    assert not (diff > 0)[~near_tie].any()
    assert n_diff <= int(near_tie.sum()) <= 20
    assert (got[ndoc:] == 0).all()
    np.testing.assert_array_equal(
        got[:ndoc], np.clip(np.round(rows * q), -127, 127).astype(np.int8))


def test_rows_abs_max():
    _, ts = spec_pair()
    tab = tsynth.make_tables(ts)
    dr = tsynth.make_draws(ts)
    rows = tsynth.gen_rows(tsynth.tables_to(tab, "cpu"), dr)
    assert tsynth.rows_abs_max(tab, dr, chunk=300, **CPU) == float(
        rows.abs().max())
