"""The port's raw (v1) and pipelined (v2) bucket scorers
(``mevi_tpu_torch.ops.bucket.bucket_scores`` / ``bucket_scores_v2``)
against the JAX package: the Pallas kernel bodies ``_kernel`` and
``_kernel_v2`` run in the Pallas interpreter under the same
``PrefetchScalarGridSpec`` as their JAX wrappers, and the XLA oracles
``bucket_scores_reference`` / ``bucket_scores_v2_reference``.  On the
CPU the wrappers run their plain PyTorch versions; the CUDA kernels are
held against them by the ``cuda``-marked tests, which skip without a
card.

Rows equal.  Scores: atol 1e-5 in float32 (both sides sum float32
products of the same values, only the summation order differs); bf16
adds rtol 1e-6, and the int8 corpus, whose rows are the float rows times
40, takes 40 x 1e-5.  On the card: rtol 1e-4, atol 1e-3 (float32 sums in
another order over d up to 768)."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mevi_tpu_torch.ops import bucket as tb
from test_torch_bucket import INT8_CASES, exact_case

N, D, CAP = 1000, 32, 64
NPAD = N + CAP + 8                   # slack rows the TPU kernels DMA
C = 64
G = 48                               # a multiple of the kernels' 8 rows
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def jx():
    """JAX and the Pallas kernel bodies, imported by the parity tests
    only, so the CUDA tests also run where JAX is absent."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mevi_tpu.ops import bucket
    return SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, jb=bucket)


def _offsets(rng):
    """Skewed CSR over 64 clusters: empty buckets, one bucket over cap,
    starts off the 8-grid, a non-empty last cluster."""
    sizes = rng.integers(0, 25, size=C)
    sizes[rng.choice(C - 1, 12, replace=False)] = 0
    sizes[5] = 3 * CAP
    sizes[-1] = 11
    sizes = (sizes * N / sizes.sum()).astype(np.int64)
    sizes[5] += N - sizes.sum()
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(22)
    offsets = _offsets(rng)
    emb = rng.normal(size=(NPAD, D)).astype(np.float32)
    emb[N:] = 0.0
    ci = rng.integers(0, C, G).astype(np.int32)
    empty = int(np.argmin(np.diff(offsets)))
    off_grid = int(np.nonzero(offsets[:-1] % 8)[0][0])
    ci[:5] = [5, C - 1, 0, empty, off_grid]
    assert offsets[empty + 1] == offsets[empty]
    q = rng.normal(size=(G, D)).astype(np.float32)
    return offsets, emb, ci, q


def _corpus(emb, name):
    if name == "int8":
        return np.clip(np.round(emb * 40), -127, 127).astype(np.int8)
    return emb


def _jax_t(jx, x, name):
    return jx.jnp.asarray(x).astype(
        {"f32": jx.jnp.float32, "bf16": jx.jnp.bfloat16,
         "int8": jx.jnp.int8}[name])


def _torch_t(x, name):
    return torch.from_numpy(np.asarray(x)).to(DTYPES[name])


def _tol(name):
    if name == "int8":           # rows are the float rows x 40
        return dict(atol=40 * 1e-5, rtol=0)
    return dict(atol=1e-5, rtol=0 if name == "f32" else 1e-6)


def _bounds(offsets, ci):
    return offsets[ci].astype(np.int32), offsets[ci + 1].astype(np.int32)


def _pallas_v1(jx, semb, starts, q, cap):
    """``bucket_scores``'s pallas_call around ``_kernel``, interpreted."""
    pl, pltpu, jb = jx.pl, jx.pltpu, jx.jb
    g, d = q.shape
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(g // jb.ROWS,),
        in_specs=[pl.BlockSpec((jb.ROWS, d), lambda i, s: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((jb.ROWS, cap), lambda i, s: (i, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((jb.ROWS, cap, d), semb.dtype),
                        pltpu.SemaphoreType.DMA((jb.ROWS,))])
    return pl.pallas_call(
        functools.partial(jb._kernel, cap=cap), grid_spec=spec,
        out_shape=jx.jax.ShapeDtypeStruct((g, cap), jx.jnp.float32),
        interpret=True)(starts, q, semb)


def _pallas_v2(jx, semb, starts, ends, q, cap):
    """``bucket_scores_v2``'s pallas_call around ``_kernel_v2``,
    interpreted."""
    pl, pltpu, jb = jx.pl, jx.pltpu, jx.jb
    g, d = q.shape
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(g // jb.ROWS,),
        in_specs=[pl.BlockSpec((jb.ROWS, d), lambda i, s, e: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec((jb.ROWS, cap), lambda i, s, e: (i, 0),
                                memory_space=pltpu.VMEM)] * 2,
        scratch_shapes=[pltpu.VMEM((2, jb.ROWS, cap, d), semb.dtype),
                        pltpu.SemaphoreType.DMA((2, jb.ROWS))])
    return pl.pallas_call(
        functools.partial(jb._kernel_v2, cap=cap, neg=-1e30), grid_spec=spec,
        out_shape=[jx.jax.ShapeDtypeStruct((g, cap), jx.jnp.float32),
                   jx.jax.ShapeDtypeStruct((g, cap), jx.jnp.int32)],
        interpret=True)(starts, ends, q, semb)


@pytest.mark.parametrize("name", list(DTYPES))
def test_raw_matches_pallas_interpret(jx, case, name):
    """Aligned starts over the padded corpus, as the TPU kernel takes
    them: every window lies inside the array, so no row is clipped."""
    offsets, emb, ci, q = case
    e = _corpus(emb, name)
    al = tb.align_down(offsets[ci]).astype(np.int32)
    J = jx.jnp.asarray
    ref = _pallas_v1(jx, _jax_t(jx, e, name), J(al), J(q), CAP)
    got = tb.bucket_scores(_torch_t(e, name), torch.from_numpy(al),
                           torch.from_numpy(q), CAP, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("aligned", [True, False])
def test_raw_matches_reference(jx, case, name, aligned):
    """Over the unpadded corpus: windows that run past N clip to row
    N - 1, as ``bucket_scores_reference`` does; starts on and off the
    8-grid."""
    offsets, emb, ci, q = case
    e = _corpus(emb[:N], name)
    st = offsets[ci]
    st = (tb.align_down(st) if aligned else np.minimum(st, N - 1))
    st = st.astype(np.int32)
    J = jx.jnp.asarray
    ref = jx.jb.bucket_scores_reference(_jax_t(jx, e, name), J(st), J(q),
                                        CAP)
    got = tb.bucket_scores(_torch_t(e, name), torch.from_numpy(st),
                           torch.from_numpy(q), CAP, device="cpu")
    assert (st + CAP > N).any()                    # the clip is exercised
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_v2_matches_pallas_interpret(jx, case, name):
    offsets, emb, ci, q = case
    e = _corpus(emb, name)
    st, en = _bounds(offsets, ci)
    J = jx.jnp.asarray
    s_j, r_j = _pallas_v2(jx, _jax_t(jx, e, name), J(st), J(en), J(q), CAP)
    # the port reads only rows inside buckets: no slack rows needed
    s_t, r_t = tb.bucket_scores_v2(_torch_t(e[:N], name),
                                   torch.from_numpy(st), torch.from_numpy(en),
                                   torch.from_numpy(q), CAP, device="cpu")
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("align", [8, 1])
def test_v2_matches_v2_reference(jx, case, name, align):
    """align 8 against the JAX oracle; align 1 against the oracle over
    starts that are already on the 1-grid, i.e. v3's plain window."""
    offsets, emb, ci, q = case
    e = _corpus(emb[:N], name)
    st, en = _bounds(offsets, ci)
    J = jx.jnp.asarray
    got = tb.bucket_scores_v2(_torch_t(e, name), torch.from_numpy(st),
                              torch.from_numpy(en), torch.from_numpy(q), CAP,
                              align=align, device="cpu")
    if align == 8:
        s_j, r_j = jx.jb.bucket_scores_v2_reference(
            _jax_t(jx, e, name), J(st), J(en), J(q), CAP)
    else:
        s_j, r_j = tb.bucket_scores_v3_plain(
            _torch_t(e, name), torch.from_numpy(st), torch.from_numpy(en),
            torch.from_numpy(q), CAP, align=1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(r_j))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(s_j), **_tol(name))
    rows = got[1].numpy()
    assert (rows[3] == -1).all()                   # the empty bucket
    assert (rows[0] >= 0).sum() == CAP - (st[0] - tb.align_down(st[0],
                                                                align))


def test_raw_masked_equals_v2(case):
    """The raw window masked to the bucket bounds is v2's output."""
    offsets, emb, ci, q = case
    st, en = _bounds(offsets, ci)
    al = tb.align_down(st)
    semb = torch.from_numpy(emb[:N])
    raw = tb.bucket_scores(semb, torch.from_numpy(al), torch.from_numpy(q),
                           CAP, device="cpu")
    s, r = tb.bucket_scores_v2(semb, torch.from_numpy(st),
                               torch.from_numpy(en), torch.from_numpy(q), CAP,
                               device="cpu")
    ok = r >= 0
    np.testing.assert_array_equal(raw[ok].numpy(), s[ok].numpy())


@pytest.mark.parametrize("bad", ["at_n", "negative", "int64", "width",
                                 "rows"])
def test_raw_rejects_bad_inputs(case, bad):
    offsets, emb, ci, q = case
    semb = torch.from_numpy(emb[:N])
    st = torch.from_numpy(tb.align_down(offsets[ci]).astype(np.int32))
    qt = torch.from_numpy(q)
    if bad == "at_n":
        st[0] = N
    elif bad == "negative":
        st[0] = -8
    elif bad == "int64":
        st = st.long()
    elif bad == "width":                           # d not a vector width
        semb = semb[:, :30].contiguous()
        qt = qt[:, :30].contiguous()
    else:
        st = st[:-1].contiguous()
    with pytest.raises(ValueError):
        tb.bucket_scores(semb, st, qt, CAP, device="cpu")


@pytest.mark.parametrize("bad", ["falling", "past_end", "noncontig"])
def test_v2_rejects_bad_inputs(case, bad):
    offsets, emb, ci, q = case
    semb = torch.from_numpy(emb[:N])
    st, en = (torch.from_numpy(x) for x in _bounds(offsets, ci))
    if bad == "falling":
        en[0] = st[0] - 1
    elif bad == "past_end":
        en[1] = N + 8
    else:
        semb = semb.T.contiguous().T
    with pytest.raises(ValueError):
        tb.bucket_scores_v2(semb, st, en, torch.from_numpy(q), CAP,
                            device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _wide_case(dev, name, d=768, n=5003, cap=512, g=64):
    """Serving widths: d 768 gives v2 stages of 21 bf16 / 42 int8 /
    10 f32 rows, so buckets span many tiles with a ragged last one."""
    rng = np.random.default_rng(7)
    cuts = np.sort(rng.choice(n - 1, 40, replace=False)) + 1
    offsets = np.concatenate([[0], cuts, [n, n]]).astype(np.int32)
    ci = rng.integers(0, len(offsets) - 1, g).astype(np.int32)
    ci[:2] = [int(np.argmax(np.diff(offsets))), len(offsets) - 2]
    emb = _corpus(rng.normal(size=(n, d)).astype(np.float32), name)
    semb = _torch_t(emb, name).to(dev)
    st = torch.from_numpy(offsets[ci]).to(dev)
    en = torch.from_numpy(offsets[ci + 1]).to(dev)
    q = torch.from_numpy(rng.normal(size=(g, d)).astype(np.float32)).to(
        dev, torch.bfloat16)
    return semb, st, en, q, cap


# int8 v2 beyond INT8_CASES, d 768 with exact float32 sums: one bucket,
# five, and 1,500 with neighbours sharing a cluster; each over a CSR with
# one-row, empty and over-cap clusters and one of 300 rows (a ragged last
# stage).
V2_INT8_CASES = {"int8_v2_g1": 1, "int8_v2_g5": 5, "int8_v2_g1500": 1500}


def v2_int8_case(name, dev, d=768, cap=512):
    G = V2_INT8_CASES[name]
    rng = np.random.default_rng(G)
    sizes = rng.integers(0, 110, size=60)
    sizes[:5] = [1, 0, 2 * cap + 5, 1, 300]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    emb = rng.integers(-128, 128, size=(int(offsets[-1]), d)).astype(np.int8)
    ci = np.repeat(rng.integers(0, len(sizes), (G + 1) // 2), 2)[:G]
    ci[:5] = [2, 0, 1, 4, 3][:G]
    q = rng.integers(-32, 33, size=(G, d)) / 8
    return (torch.from_numpy(emb).to(dev),
            torch.from_numpy(offsets[ci]).to(dev),
            torch.from_numpy(offsets[ci + 1]).to(dev),
            torch.from_numpy(q.astype(np.float32)).to(dev, torch.bfloat16),
            cap)


V2_CASES = ([(wide, name) for wide in (False, True) for name in DTYPES]
            + [(False, name) for name in list(INT8_CASES)
               + list(V2_INT8_CASES)])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "wide,name", V2_CASES,
    ids=[name if name.startswith("int8_") else f"{wide}-{name}"
         for wide, name in V2_CASES])
@pytest.mark.parametrize("align", [8, 1])
def test_cuda_v2_matches_plain(case, cuda_device, name, wide, align):
    """The int8 cases (``INT8_CASES`` and ``V2_INT8_CASES``: exact
    float32 sums) must equal the plain version."""
    tol = dict(rtol=0, atol=0)
    if name in INT8_CASES:
        semb, off, cit, q, cap = exact_case(name, cuda_device)
        st = off[cit.long()].contiguous()
        en = off[cit.long() + 1].contiguous()
    elif name in V2_INT8_CASES:
        semb, st, en, q, cap = v2_int8_case(name, cuda_device)
    elif wide:
        semb, st, en, q, cap = _wide_case(cuda_device, name)
        tol = dict(rtol=1e-4, atol=1e-3)
    else:
        offsets, emb, ci, qn = case
        semb = _torch_t(_corpus(emb, name)[:N], name).to(cuda_device)
        st, en = (torch.from_numpy(x).to(cuda_device)
                  for x in _bounds(offsets, ci))
        q = torch.from_numpy(qn).to(cuda_device, torch.bfloat16)
        cap, tol = CAP, dict(rtol=1e-4, atol=1e-3)
    ref = tb.bucket_scores_v2_plain(semb, st, en, q, cap, align)
    got = tb.bucket_scores_v2(semb, st, en, q, cap, align)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), ref[1].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               **tol)


RAW_CASES = ([(wide, name) for wide in (False, True) for name in DTYPES]
             + [(False, name) for name in INT8_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "wide,name", RAW_CASES,
    ids=[name if name in INT8_CASES else f"{wide}-{name}"
         for wide, name in RAW_CASES])
def test_cuda_raw_matches_plain(case, cuda_device, name, wide):
    """Every window clipped at N - 1 somewhere; the int8 cases of
    ``INT8_CASES`` (exact float32 sums) must equal the plain version."""
    tol = dict(rtol=1e-4, atol=1e-3)
    if name in INT8_CASES:
        semb, off, cit, q, cap = exact_case(name, cuda_device)
        st = tb.align_down(off[cit.long()]).contiguous()
        tol = dict(rtol=0, atol=0)
    elif wide:
        semb, st, _, q, cap = _wide_case(cuda_device, name)
        st = tb.align_down(st)
    else:
        offsets, emb, ci, qn = case
        semb = _torch_t(_corpus(emb, name)[:N], name).to(cuda_device)
        st = torch.from_numpy(
            tb.align_down(offsets[ci]).astype(np.int32)).to(cuda_device)
        q = torch.from_numpy(qn).to(cuda_device, torch.bfloat16)
        cap = CAP
    assert int((st + cap).max()) > semb.shape[0]     # clipped windows
    ref = tb.bucket_scores_plain(semb, st, q, cap)
    got = tb.bucket_scores(semb, st, q, cap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **tol)


@pytest.mark.cuda
def test_cuda_launch_counts(case, cuda_device):
    offsets, emb, ci, qn = case
    semb = torch.from_numpy(emb[:N]).to(cuda_device)
    st, en = (torch.from_numpy(x).to(cuda_device)
              for x in _bounds(offsets, ci))
    q = torch.from_numpy(qn).to(cuda_device)
    n = tb.launch_counts()
    tb.bucket_scores_v2(semb, st, en, q, CAP)
    tb.bucket_scores(semb, tb.align_down(st), q, CAP)
    tb.bucket_scores_v2_plain(semb, st, en, q, CAP)
    after = tb.launch_counts()
    assert after["v2"] == n["v2"] + 1
    assert after["raw"] == n["raw"] + 1
