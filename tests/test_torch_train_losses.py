"""Port parity: ``mevi_tpu_torch.train.losses`` and the twin-tower losses
against ``mevi_tpu``'s, in values and in gradients (``jax.grad`` against
autograd), float32 on the CPU, tolerance 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.models import twin_tower as jtt
from mevi_tpu.train import losses as JL
from mevi_tpu_torch.models import twin_tower as ptt
from mevi_tpu_torch.parallel.mesh import single_device_mesh
from mevi_tpu_torch.train import losses as PL

ATOL = 2e-5


def check(jfn, tfn, arrays, argnums, rtol=0.0):
    """Value and gradients (w.r.t. ``argnums``) of a scalar loss on the
    same float32 inputs in both packages."""
    jargs = [jnp.asarray(a) for a in arrays]
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(*jargs)
    targs = [torch.tensor(a, requires_grad=i in argnums)
             for i, a in enumerate(arrays)]
    tval = tfn(*targs)
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), atol=ATOL, rtol=0)
    for i, g in zip(argnums, jgrads):
        got = targs[i].grad
        got = np.zeros_like(arrays[i]) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=ATOL, rtol=rtol)


def randn(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_nci_ce_loss(weighted):
    rng = np.random.default_rng(1)
    logits = randn(rng, 3, 4, 6, scale=2.0)
    labels = rng.integers(0, 6, (3, 4)).astype(np.int32)
    labels[:, -1] = -100
    w = randn(rng, 3, 4) if weighted else None
    check(lambda x: JL.nci_ce_loss(x, jnp.asarray(labels),
                                   None if w is None else jnp.asarray(w)),
          lambda x: PL.nci_ce_loss(x, torch.from_numpy(labels),
                                   None if w is None else torch.from_numpy(w)),
          [logits], (0,))


@pytest.mark.parametrize("name", ["rdrop_kl", "rdrop_l2", "rdrop_contrast"])
def test_rdrop_losses(name):
    rng = np.random.default_rng(2)
    shape = (4, 5, 8) if name == "rdrop_contrast" else (4, 5, 6)
    a, b = randn(rng, *shape), randn(rng, *shape)
    check(getattr(JL, name), getattr(PL, name), [a, b], (0, 1))


@pytest.mark.parametrize("hard_topk", [0, 1, 3])
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_soft_assign(tau, hard_topk):
    rng = np.random.default_rng(3)
    x = randn(rng, 4, 3, 7, scale=2.0)
    wts = randn(rng, 4, 3, 7)
    # a weighted sum, so the straight-through gradient is exercised
    check(lambda v: jnp.sum(JL.soft_assign(v, tau, hard_topk)
                            * jnp.asarray(wts)),
          lambda v: (PL.soft_assign(v, tau, hard_topk)
                     * torch.from_numpy(wts)).sum(),
          [x], (0,))


PQ_CASES = ([(k, "none", "cont") for k in ("ce", "kl", "mse", "dot",
                                           "cosine")]
            + [(k, n, nl) for k in ("ce", "kl", "mse", "dot", "cosine")
               for n in ("sample", "batch") for nl in ("cont", "margin")])


@pytest.mark.parametrize("kind,negative,negative_loss", PQ_CASES)
def test_pq_distill_loss(kind, negative, negative_loss):
    rng = np.random.default_rng(4)
    b, g, M, K = 3, 4, 2, 5
    nci = randn(rng, b, M, K, scale=2.0)
    pq = randn(rng, b * g, M, K, scale=2.0)
    kw = dict(kind=kind, tau=0.7, negative=negative,
              negative_loss=negative_loss, margin=0.5)
    check(lambda x, y: JL.pq_distill_loss(x, y, **kw),
          lambda x, y: PL.pq_distill_loss(x, y, **kw), [nci, pq], (0, 1))


@pytest.mark.parametrize("kind", ["ce", "mse", "kl"])
def test_pq_distill_loss_hard_topk(kind):
    rng = np.random.default_rng(5)
    nci = randn(rng, 3, 2, 6, scale=2.0)
    pq = randn(rng, 3, 2, 6, scale=2.0)
    # 'kl' over hard (k-hot) assignments divides by the 1e-12 guard: its
    # gradients reach 1e9, where a float32 ulp is ~100, so they are held
    # to float32's relative precision (1e-6) there
    check(lambda x, y: JL.pq_distill_loss(x, y, kind, hard_topk=2),
          lambda x, y: PL.pq_distill_loss(x, y, kind, hard_topk=2),
          [nci, pq], (0, 1), rtol=1e-6 if kind == "kl" else 0.0)


def test_rq_reconstruction_loss():
    rng = np.random.default_rng(6)
    emb, cbs = randn(rng, 10, 8), randn(rng, 3, 4, 8)
    codes = rng.integers(0, 4, (10, 3)).astype(np.int32)
    check(lambda e, c: JL.rq_reconstruction_loss(e, jnp.asarray(codes), c),
          lambda e, c: PL.rq_reconstruction_loss(e, torch.from_numpy(codes),
                                                 c),
          [emb, cbs], (0, 1))


@pytest.mark.parametrize("bmm", [False, True])
def test_similarity(bmm):
    rng = np.random.default_rng(7)
    q = randn(rng, 4, 8)
    p = randn(rng, 4, 8) if bmm else randn(rng, 12, 8)
    check(lambda x, y: jnp.mean(jtt.similarity(x, y, bmm) ** 2),
          lambda x, y: (ptt.similarity(x, y, bmm) ** 2).mean(),
          [q, p], (0, 1))


def test_contrastive_loss():
    rng = np.random.default_rng(8)
    q, p = randn(rng, 4, 8), randn(rng, 12, 8)
    check(lambda x, y: jtt.contrastive_loss(x, y)[0],
          lambda x, y: ptt.contrastive_loss(x, y)[0], [q, p], (0, 1))
    # cross-device negatives need the mesh that holds the axis; on a
    # one-rank mesh the gather is the identity (the multi-rank case is
    # tests/test_torch_parallel.py's)
    with pytest.raises(ValueError, match="mesh"):
        ptt.contrastive_loss(torch.from_numpy(q), torch.from_numpy(p),
                             axis_name="data")
    mesh = single_device_mesh("cpu")
    check(lambda x, y: jtt.contrastive_loss(x, y)[0],
          lambda x, y: ptt.contrastive_loss(x, y, axis_name="data",
                                            mesh=mesh)[0], [q, p], (0, 1))


def test_grouped_contrastive_loss():
    rng = np.random.default_rng(9)
    q, p = randn(rng, 4, 8), randn(rng, 4, 3, 8)
    check(jtt.grouped_contrastive_loss, ptt.grouped_contrastive_loss,
          [q, p], (0, 1))
