"""The port's bucket scorer (``mevi_tpu_torch.ops.bucket``) against the
JAX package's oracles: the v3 Pallas kernel body in the Pallas
interpreter, ``bucket_scores_v2_reference`` and
``bucket_scores_fused_reference``; ``align=1`` against
``eval.searcher._beam_scores``.  On the CPU the wrappers run their plain
PyTorch versions; the CUDA kernel itself is held against them by the
``cuda``-marked test, which skips without a card.

Rows equal.  Scores: atol 1e-5 in float32 (both sides sum float32
products of the same values, only the summation order differs); bf16
adds rtol 1e-6, and the int8 corpus, whose rows are the float rows
times 40, takes 40 x 1e-5.  On the card: rtol 1e-4, atol 1e-3, except
the int8 cases of ``INT8_CASES``, whose every product and partial sum
is exact in float32 (full-range int8 rows, queries k * 2^m with
|k| <= 32), so the kernel must equal its plain version bit for bit."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mevi_tpu_torch.eval import searcher as tsearch
from mevi_tpu_torch.index.csr import pack_codes
from mevi_tpu_torch.ops import bucket as tb


N, D, CAP = 1000, 32, 64
KARY, M = 4, 3                       # 64 clusters
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def jx():
    """The JAX oracles, imported by the parity tests only, so that the
    CUDA test also runs where JAX is absent (``--noconftest -m cuda``)."""
    import jax.numpy as jnp
    from mevi_tpu.eval import searcher
    from mevi_tpu.ops import bucket
    return SimpleNamespace(jnp=jnp, jb=bucket, jsearch=searcher)


def _offsets(rng):
    """Skewed CSR over 64 clusters: empty buckets, one bucket over cap,
    starts off the 8-grid, a non-empty last cluster."""
    sizes = rng.integers(0, 25, size=KARY ** M)
    sizes[rng.choice(KARY ** M - 1, 12, replace=False)] = 0
    sizes[5] = 3 * CAP
    sizes[-1] = 11
    sizes = (sizes * N / sizes.sum()).astype(np.int64)
    sizes[5] += N - sizes.sum()
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    offsets = _offsets(rng)
    C = len(offsets) - 1
    emb = rng.normal(size=(N + CAP + 8, D)).astype(np.float32)
    emb[N:] = 0.0                                   # slack for the TPU kernel
    G = 48
    ci = rng.integers(0, C, G).astype(np.int32)
    ci[:4] = [5, C - 1, 0, int(np.argmin(np.diff(offsets)))]
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


def test_int8_widening_identity():
    """The int8 kernel widens a byte b without I2F: ``__byte_perm(w ^
    0x80808080, 0x4B000000, 0x7540 | i)`` puts byte i of w, XORed with
    0x80 (b + 128 in [0, 255]), into the low mantissa byte of 2^23, and
    subtracting 2^23 + 128 leaves b exactly, for all 256 values."""
    b = np.arange(-128, 128).astype(np.int8)
    words = b.view(np.uint8).reshape(-1, 4).copy().view("<u4")[:, 0]
    x = words ^ np.uint32(0x80808080)
    for i in range(4):
        # __byte_perm(x, y, s): result byte n is byte s_n of (y:x)
        sel = 0x7540 | i
        src = np.concatenate([x.view(np.uint8).reshape(-1, 4),
                              np.tile(np.frombuffer(
                                  np.uint32(0x4B000000).tobytes(), np.uint8),
                                      (len(x), 1))], axis=1)
        out = np.stack([src[:, (sel >> (4 * n)) & 7] for n in range(4)], 1)
        f = out.copy().view("<f4")[:, 0] - np.float32(8388736.0)
        np.testing.assert_array_equal(f, b[i::4].astype(np.float32))
    bits = np.uint32(0x4B000000) | (b.view(np.uint8) ^ 0x80).astype(
        np.uint32)
    np.testing.assert_array_equal(bits.view(np.float32)
                                  - np.float32(8388736.0),
                                  b.astype(np.float32))


def _assert_same(got, ref, name):
    (s_t, r_t), (s_j, r_j) = got, ref
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **_tol(name))


def _bounds(offsets, ci):
    return offsets[ci].astype(np.int32), offsets[ci + 1].astype(np.int32)


@pytest.mark.parametrize("name", list(DTYPES))
def test_v3_matches_pallas_interpret(jx, case, name):
    offsets, emb, ci, q = case
    e = _corpus(emb, name)
    st, en = _bounds(offsets, ci)
    J = jx.jnp.asarray
    ref = jx.jb.bucket_scores_v3(_jax_t(jx, e, name), J(st), J(en), J(q),
                                 CAP, interpret=True)
    # the port reads only rows inside buckets: no slack rows needed
    got = tb.bucket_scores_v3(_torch_t(e[:N], name), torch.from_numpy(st),
                              torch.from_numpy(en), torch.from_numpy(q),
                              CAP, device="cpu")
    _assert_same(got, ref, name)


@pytest.mark.parametrize("name", list(DTYPES))
def test_v3_matches_v2_reference(jx, case, name):
    offsets, emb, ci, q = case
    e = _corpus(emb, name)
    st, en = _bounds(offsets, ci)
    J = jx.jnp.asarray
    ref = jx.jb.bucket_scores_v2_reference(_jax_t(jx, e, name), J(st),
                                           J(en), J(q), CAP)
    got = tb.bucket_scores_v3(_torch_t(e, name), torch.from_numpy(st),
                              torch.from_numpy(en), torch.from_numpy(q),
                              CAP, device="cpu")
    _assert_same(got, ref, name)


@pytest.mark.parametrize("name", list(DTYPES))
def test_fused_matches_fused_reference(jx, case, name):
    offsets, emb, ci, q = case
    e = _corpus(emb, name)
    J = jx.jnp.asarray
    ref = jx.jb.bucket_scores_fused_reference(
        _jax_t(jx, e, name), J(jx.jb.pack_offsets_2d(offsets)), J(ci), J(q),
        CAP)
    got = tb.bucket_scores_fused(
        _torch_t(e[:N], name), torch.from_numpy(offsets.astype(np.int32)),
        torch.from_numpy(ci), torch.from_numpy(q), CAP, device="cpu")
    _assert_same(got, ref, name)


@pytest.mark.parametrize("qname", ["f32", "bf16"])
def test_bf16_queries(jx, case, qname):
    """Query rows in bf16 (the served type) upcast like the JAX oracle."""
    offsets, emb, ci, q = case
    st, en = _bounds(offsets, ci)
    J = jx.jnp.asarray
    ref = jx.jb.bucket_scores_v2_reference(_jax_t(jx, emb, "bf16"), J(st),
                                           J(en), _jax_t(jx, q, qname), CAP)
    got = tb.bucket_scores_v3(_torch_t(emb, "bf16"), torch.from_numpy(st),
                              torch.from_numpy(en), _torch_t(q, qname), CAP,
                              device="cpu")
    _assert_same(got, ref, "bf16")


def test_align1_matches_beam_scores(jx, case):
    """align=1 scores the unaligned [s, s + cap) window of the XLA path."""
    offsets, emb, _, _ = case
    rng = np.random.default_rng(3)
    B, nb = 4, 3
    codes = rng.integers(0, KARY, size=(B, nb, M)).astype(np.int32)
    codes[0, 0] = [0, 1, 1]                          # cluster 5: over cap
    q = rng.normal(size=(B, D)).astype(np.float32)
    doc_ids = rng.permutation(N).astype(np.int32)
    J = jx.jnp.asarray
    s_j, i_j, _ = jx.jsearch._beam_scores(J(q), J(codes), J(offsets),
                                          J(doc_ids), J(emb[:N]), KARY, CAP)
    ci = pack_codes(codes.reshape(-1, M), KARY).astype(np.int64)
    s, r = tb.bucket_scores_v3(
        torch.from_numpy(emb[:N]),
        torch.from_numpy(offsets[ci].astype(np.int32)),
        torch.from_numpy(offsets[ci + 1].astype(np.int32)),
        torch.from_numpy(np.repeat(q, nb, 0)), CAP, align=1, device="cpu")
    r = r.numpy().reshape(B, -1)
    ids = np.where(r >= 0, doc_ids[np.clip(r, 0, None)], -1)
    np.testing.assert_array_equal(ids, np.asarray(i_j))
    np.testing.assert_allclose(s.numpy().reshape(B, -1), np.asarray(s_j),
                               atol=1e-5, rtol=0)
    # and the port's own plain gather path agrees with JAX's
    s_t, i_t, z_t = tsearch._beam_scores(
        torch.from_numpy(q), torch.from_numpy(codes),
        torch.from_numpy(offsets.astype(np.int32)),
        torch.from_numpy(doc_ids), torch.from_numpy(emb[:N]), KARY, CAP)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5,
                               rtol=0)


SPARSE_CAP = 256


@pytest.fixture(scope="module")
def sparse_case():
    """The evaluator's sparse window (cap 4096 over clusters of a few
    dozen rows) at a small size: clusters of at most 12 rows under a cap
    of 256, so that over 95% of the slots are empty; empty clusters,
    starts off the 8-grid, a last cluster whose window runs past its
    rows (slack rows of zeros for the TPU kernel only)."""
    rng = np.random.default_rng(5)
    C = KARY ** M
    sizes = rng.integers(0, 13, size=C)
    sizes[rng.choice(C - 1, 8, replace=False)] = 0
    sizes[-1] = 7
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(offsets[-1])
    emb = rng.normal(size=(n + SPARSE_CAP + 8, D)).astype(np.float32)
    emb[n:] = 0.0
    G = 48
    ci = rng.integers(0, C, G).astype(np.int32)
    ci[:2] = [C - 1, int(np.argmin(sizes))]
    q = rng.normal(size=(G, D)).astype(np.float32)
    return offsets, emb, ci, q, n


@pytest.mark.parametrize("oracle", ["pallas_interpret", "v2_reference",
                                    "fused_reference"])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sparse_window_matches_jax(jx, sparse_case, name, oracle):
    """The plain versions the card's kernels are held against, at a cap
    far above the cluster sizes: v3's against the v3 Pallas kernel body
    in the Pallas interpreter and ``bucket_scores_v2_reference``, fused's
    against ``bucket_scores_fused_reference``."""
    offsets, emb, ci, q, n = sparse_case
    st, en = _bounds(offsets, ci)
    valid = np.minimum(en, (st // 8) * 8 + SPARSE_CAP) - st
    assert valid.sum() <= 0.05 * len(ci) * SPARSE_CAP
    J = jx.jnp.asarray
    ej = _jax_t(jx, emb, name)
    if oracle == "fused_reference":
        ref = jx.jb.bucket_scores_fused_reference(
            ej, J(jx.jb.pack_offsets_2d(offsets)), J(ci), J(q), SPARSE_CAP)
        got = tb.bucket_scores_fused(
            _torch_t(emb[:n], name),
            torch.from_numpy(offsets.astype(np.int32)), torch.from_numpy(ci),
            torch.from_numpy(q), SPARSE_CAP, device="cpu")
    else:
        fn = (jx.jb.bucket_scores_v2_reference if oracle == "v2_reference"
              else functools.partial(jx.jb.bucket_scores_v3,
                                     interpret=True))
        ref = fn(ej, J(st), J(en), J(q), SPARSE_CAP)
        got = tb.bucket_scores_v3(_torch_t(emb[:n], name),
                                  torch.from_numpy(st), torch.from_numpy(en),
                                  torch.from_numpy(q), SPARSE_CAP,
                                  device="cpu")
    _assert_same(got, ref, name)


def test_wrappers_reject_bad_inputs(case):
    offsets, emb, ci, q = case
    semb = torch.from_numpy(emb[:N])
    st = torch.from_numpy(offsets[ci].astype(np.int32))
    en = torch.from_numpy(offsets[ci + 1].astype(np.int32))
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError):                  # int64 bounds
        tb.bucket_scores_v3(semb, st.long(), en, qt, CAP, device="cpu")
    with pytest.raises(ValueError):                  # d not a vector width
        tb.bucket_scores_v3(semb[:, :30].contiguous(), st, en,
                            qt[:, :30].contiguous(), CAP, device="cpu")
    with pytest.raises(ValueError):                  # non-contiguous
        tb.bucket_scores_v3(semb.T.contiguous().T, st, en, qt, CAP,
                            device="cpu")
    with pytest.raises(ValueError):                  # float64 queries
        tb.bucket_scores_v3(semb, st, en, qt.double(), CAP, device="cpu")


@pytest.mark.parametrize("bad", ["falling", "negative", "past_end",
                                 "cidx_high"])
def test_fused_rejects_bad_offsets(case, bad):
    """The fused kernel reads rows [offsets[c], offsets[c+1]), so the
    wrapper refuses offsets that fall, start below 0 or end past N, and
    cluster ids outside them."""
    offsets, emb, ci, q = case
    off = offsets.astype(np.int32).copy()
    cit = ci.copy()
    if bad == "falling":
        c = int(ci[0])
        off[c + 1] = off[c] - 1
    elif bad == "negative":
        off[0] = -8
    elif bad == "past_end":
        off[-1] = N + 8
    else:
        cit[0] = len(off) - 1
    with pytest.raises(ValueError):
        tb.bucket_scores_fused(torch.from_numpy(emb[:N]),
                               torch.from_numpy(off), torch.from_numpy(cit),
                               torch.from_numpy(q), CAP, device="cpu")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# int8 corpora on the card: d (16-byte vectors a row: 1, 3, 8, 48, 49,
# 129: one vector, ragged lane groups, 2 vectors a lane, the serving
# width, 4 vectors a lane, the query past its register slice), cap (not
# all multiples of 64), query type and scale (f32 of large magnitude).
INT8_CASES = {"int8_d16": (16, 100, "bf16", 1 / 8),
              "int8_d48": (48, 64, "bf16", 1 / 8),
              "int8_d128": (128, 72, "bf16", 1 / 8),
              "int8_d768": (768, 512, "bf16", 1 / 8),
              "int8_d784_f32": (784, 200, "f32", 4096.0),
              "int8_d2064": (2064, 96, "bf16", 1 / 8)}
# bf16 and f32 corpora on the card: corpus type, d (16-byte vectors a
# row: 1, 3, 8, 96 (bf16's serving width), 97, 130 and, for f32, 192
# (the serving width, 6 a lane) and 260: a lane group of 4 lanes, ragged
# groups, vectors a lane from 1 to 6, the query past its register slice),
# cap (not multiples of 4 or 64; over the 1,024 slots of a block's chunk,
# with a short last chunk; the evaluator's 4096 over clusters of at most
# 60 rows) and query type.
FLOAT_CASES = {"bf16_d8": ("bf16", 8, 61, "bf16"),
               "bf16_d24": ("bf16", 24, 100, "f32"),
               "bf16_d64": ("bf16", 64, 250, "bf16"),
               "bf16_d768": ("bf16", 768, 513, "bf16"),
               "bf16_d768_cap4096": ("bf16", 768, 4096, "bf16"),
               "bf16_d776": ("bf16", 776, 83, "f32"),
               "bf16_d1040": ("bf16", 1040, 90, "bf16"),
               "bf16_d24_cap2050": ("bf16", 24, 2050, "bf16"),
               "f32_d4": ("f32", 4, 61, "f32"),
               "f32_d12": ("f32", 12, 100, "bf16"),
               "f32_d32": ("f32", 32, 250, "f32"),
               "f32_d384": ("f32", 384, 513, "f32"),
               "f32_d388": ("f32", 388, 83, "bf16"),
               "f32_d520": ("f32", 520, 90, "f32"),
               "f32_d768_cap4096": ("f32", 768, 4096, "f32"),
               "f32_d1040": ("f32", 1040, 66, "bf16"),
               "f32_d12_cap1030": ("f32", 12, 1030, "f32")}


def exact_case(name, dev):
    """A CSR over 40 clusters of integer rows in [-128, 127] (rows of
    -128 and of 127 inside the bucket over cap), an empty cluster, starts
    off the 8-grid, a small last cluster whose windows run past N; 64
    buckets and queries k * scale with integer |k| <= 32 (scale 1/8 for
    the bf16 and f32 cases), so that every float32 sum is exact.  Returns
    (semb, offsets, cidx, q, cap) on ``dev``."""
    if name in INT8_CASES:
        corpus = "int8"
        d, cap, qname, scale = INT8_CASES[name]
    else:
        corpus, d, cap, qname = FLOAT_CASES[name]
        scale = 1 / 8
    rng = np.random.default_rng(d + cap)
    sizes = rng.integers(0, 60, size=40)
    sizes[3] = 0
    sizes[7] = 2 * cap + 5
    sizes[-1] = 13
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(offsets[-1])
    emb = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
    emb[offsets[7]] = -128
    emb[offsets[7] + 1] = 127
    ci = rng.integers(0, len(sizes), 64).astype(np.int32)
    ci[:3] = [7, 3, len(sizes) - 1]
    q = (rng.integers(-32, 33, size=(64, d)) * scale).astype(np.float32)
    return (torch.from_numpy(emb).to(dev, DTYPES[corpus]),
            torch.from_numpy(offsets).to(dev), torch.from_numpy(ci).to(dev),
            torch.from_numpy(q).to(dev, DTYPES[qname]), cap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES) + list(INT8_CASES)
                         + list(FLOAT_CASES))
@pytest.mark.parametrize("mode", ["v3", "fused"])
@pytest.mark.parametrize("align", [8, 1])
def test_cuda_kernel_matches_plain(case, cuda_device, name, mode, align):
    if name in INT8_CASES or name in FLOAT_CASES:
        semb, off, cit, qt, cap = exact_case(name, cuda_device)
        tol = dict(rtol=0, atol=0)
    else:
        offsets, emb, ci, q = case
        semb = _torch_t(_corpus(emb, name)[:N], name).to(cuda_device)
        qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
        off = torch.from_numpy(offsets.astype(np.int32)).to(cuda_device)
        cit = torch.from_numpy(ci).to(cuda_device)
        cap, tol = CAP, dict(rtol=1e-4, atol=1e-3)
    ref = tb.bucket_scores_fused_plain(semb, off, cit, qt, cap, align)
    if mode == "fused":
        got = tb.bucket_scores_fused(semb, off, cit, qt, cap, align)
    else:
        got = tb.bucket_scores_v3(semb, off[cit.long()],
                                  off[cit.long() + 1], qt, cap, align)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), ref[1].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               **tol)
