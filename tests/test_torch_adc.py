"""The port's ADC scan (``mevi_tpu_torch.ops.adc``) against the JAX
package's ``mevi_tpu.ops.adc``, float32 on the CPU (both packages keep
float32 tables on the CPU), on the same seeded numpy inputs.

Code matrices and top-k ids are equal (ADC scores tie for documents that
share a code, and both sides keep the lower id first); tables and scores
are within rtol 1e-5 / atol 1e-5 (float32 sums of the same products in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.ops import adc as jadc
from mevi_tpu.ops import rq as jrq
from mevi_tpu_torch.ops import adc as tadc
from mevi_tpu_torch.ops import rq as trq
from mevi_tpu_torch.ops.topk import chunk_ids_clamped

RTOL = ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def fitted():
    """RQ 3 x 8 over 300 rows of d 16, trained by the JAX package."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    cbs, codes = jrq.rq_train(jnp.asarray(emb), 3, 8, iters=4,
                              key=jax.random.PRNGKey(0))
    q = rng.normal(size=(6, 16)).astype(np.float32)
    return emb, np.asarray(cbs), np.asarray(codes), q


@pytest.mark.parametrize("c,chunk,n", [(0, 64, 300), (4, 64, 300),
                                       (1, 64, 100), (0, 64, 40)])
def test_chunk_ids_clamped_equal(c, chunk, n):
    from mevi_tpu.ops.topk import chunk_ids_clamped as j_chunk_ids
    s_t, i_t = chunk_ids_clamped(c, chunk, n)
    s_j, i_j = j_chunk_ids(jnp.int32(c), chunk, n)
    assert s_t == int(s_j)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_build_adc_codes_equal(fitted):
    _, _, codes, _ = fitted
    np.testing.assert_array_equal(tadc.build_adc_codes(codes, 8),
                                  jadc.build_adc_codes(codes, 8))


def test_adc_tables_equal(fitted):
    _, cbs, _, q = fitted
    got = tadc.adc_tables(T(q), T(cbs))
    assert got.shape == (24, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jadc.adc_tables(
        jnp.asarray(q), jnp.asarray(cbs))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,chunk", [(10, 64), (50, 128), (300, 262144)])
def test_adc_topk_equal(fitted, k, chunk):
    _, cbs, codes, q = fitted
    oh = jadc.build_adc_codes(codes, 8)
    tables = np.asarray(jadc.adc_tables(jnp.asarray(q), jnp.asarray(cbs)))
    s_t, i_t = tadc.adc_topk(T(oh), T(tables), k, chunk)
    s_j, i_j = jadc.adc_topk(jnp.asarray(oh), jnp.asarray(tables), k, chunk)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)


def test_adc_search_equals_reconstruction_ip(fitted):
    """Scores are the inner products with the RQ reconstruction, and the
    search equals the JAX package's."""
    _, cbs, codes, q = fitted
    oh = jadc.build_adc_codes(codes, 8)
    s_t, i_t = tadc.adc_search(q, cbs, oh, k=20, chunk=64, device="cpu")
    s_j, i_j = jadc.adc_search(jnp.asarray(q), jnp.asarray(cbs),
                               jnp.asarray(oh), k=20, chunk=64)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=ATOL)
    rec = trq.reconstruct(T(codes), T(cbs)).numpy()
    ref = np.take_along_axis(q @ rec.T, i_t.numpy(), 1)
    np.testing.assert_allclose(s_t.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [8, 64, 1 << 19])
def test_fill_onehot_matrix_equals_host_codes(chunk):
    codes = np.random.default_rng(1).integers(0, 5, (37, 3)).astype(np.int32)
    got = tadc.fill_onehot_matrix(codes, kary=5, chunk=chunk, device="cpu")
    want = np.asarray(jadc.fill_onehot_matrix(codes, 5, chunk=chunk))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:37],
                                  jadc.build_adc_codes(codes, 5))


def test_fill_onehot_matrix_searchable(fitted):
    """The padded device matrix finds the host matrix's top-k (the pad
    rows, all zero, score 0 and sit past the real ids)."""
    _, cbs, codes, q = fitted
    oh = tadc.fill_onehot_matrix(codes, 8, chunk=64, device="cpu")
    s1, i1 = tadc.adc_search(q, cbs, oh, k=8, chunk=64, device="cpu")
    s2, i2 = tadc.adc_search(q, cbs, tadc.build_adc_codes(codes, 8), k=8,
                             chunk=64, device="cpu")
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=RTOL, atol=ATOL)


def test_fill_onehot_matrix_refuses_wide_codes():
    with pytest.raises(ValueError, match="int8"):
        tadc.fill_onehot_matrix(np.zeros((4, 2), np.int32), 128,
                                device="cpu")
