"""Port parity of ``mevi_tpu_torch.train.trainer`` against
``mevi_tpu.train.trainer`` (optax): labels and decay mask on the same
tree, the schedule step by step, the parameters after several NCI steps
(two learning rates, weight decay, a clip that fires, gradient
accumulation against ``optax.MultiSteps``) and one twin-tower step.
float32 on the CPU, dropout off, tolerance 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.config import TrainConfig as JTrainConfig
from mevi_tpu.models import nci as jnci
from mevi_tpu.models import t5 as jt5
from mevi_tpu.train import trainer as JT
from mevi_tpu_torch.config import TrainConfig
from mevi_tpu_torch.models import nci as pnci
from mevi_tpu_torch.models import t5 as pt5
from mevi_tpu_torch.models.twin_tower import Tower
from mevi_tpu_torch.train import trainer as PT
from mevi_tpu_torch.weights import (flax_names, load_flax_params,
                                    state_dict_to_flax)

ATOL = 2e-5
B, LQ, M, KARY = 4, 6, 3, 4
T5KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
            num_layers=2, num_decoder_layers=2)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=2,
             adaptor_num_heads=4, adaptor_d_ff=64)
# both learning rates, decay, and a clip well under the gradient norms
TRAIN = dict(learning_rate=3e-3, decoder_learning_rate=1e-3,
             weight_decay=0.1, max_grad_norm=0.05, warmup_steps=1)


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def close_trees(got, ref, atol=ATOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def nci_setup():
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(6):
        ids = rng.integers(2, 60, (B, LQ)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[0, 4:] = 0
        batches.append({"query_ids": ids, "query_mask": mask,
                        "codes": rng.integers(0, KARY, (B, M))
                        .astype(np.int32)})
    jmodel = jnci.NCIT5(jnci.NCIDims(t5=jt5.T5Dims(dropout_rate=0.0,
                                                   **T5KW), **NCIKW))
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["query_ids"]),
        jnp.asarray(batches[0]["query_mask"]),
        jnp.zeros((B, M + 2), jnp.int32))["params"]
    return jmodel, params, batches


def port_nci(fparams):
    dims = pnci.NCIDims(t5=pt5.T5Dims(dropout_rate=0.0, **T5KW), **NCIKW)
    return load_flax_params(pnci.NCIT5(dims, device="cpu"), fparams)


def test_labels_and_decay_mask(nci_setup):
    _, params, _ = nci_setup
    fl = flat(params)
    paths = list(flax_names(port_nci(fl)).values())
    assert sorted(paths) == sorted(fl)
    assert PT.nci_param_labels(paths) == flat(JT.nci_param_labels(params))
    mask = PT.no_decay_mask(paths)
    assert mask == flat(JT.no_decay_mask(params))
    # the JAX package's rule on flax paths, copied: these are decayed
    for p in ("pawa/layer_0/self_attn/in_proj_bias",
              "pawa/memory_embedding", "adaptor_kernel"):
        assert mask[p]
    assert not mask["pawa/layer_0/norm1/scale"]
    assert not mask["encoder/block_0/self_norm/weight"]


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_every_step(warmup):
    ref = JT.linear_warmup_decay(1e-3, warmup, 10)
    got = PT.linear_warmup_decay(1e-3, warmup, 10)
    for step in range(11):
        assert got(step) == float(np.float32(ref(step))), step
    if warmup:
        assert got(0) == 0.0


def _jax_steps(jmodel, params, batches, n, accumulation):
    cfg = JTrainConfig(gradient_accumulation=accumulation, **TRAIN)
    opt = JT.make_optimizer(cfg, params, total_steps=10)
    state = JT.init_state(params, opt)
    step = JT.make_nci_train_step(jmodel, opt, donate=False)
    for b in batches[:n]:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()}, None)
    return state, metrics


@pytest.mark.parametrize("accumulation,micro_steps", [(1, 3), (2, 6)])
def test_nci_steps_equal_optax(nci_setup, accumulation, micro_steps):
    """3 updates: one micro-batch each, or the mean of two
    (``optax.MultiSteps``)."""
    jmodel, params, batches = nci_setup
    jstate, jmetrics = _jax_steps(jmodel, params, batches, micro_steps,
                                  accumulation)
    model = port_nci(flat(params))
    cfg = TrainConfig(gradient_accumulation=accumulation, **TRAIN)
    opt = PT.make_optimizer(cfg, model, total_steps=10)
    state = PT.init_state(model, opt)
    step = PT.make_nci_train_step(model)
    norms = []
    for b in batches[:micro_steps]:
        state, metrics = step(state, b)
    assert state.step == int(jstate.step) == micro_steps
    assert opt.count == 3
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(jmetrics["loss"]), atol=ATOL)
    close_trees(state_dict_to_flax(model), flat(jstate.params))
    # the clip fired: a fresh gradient's group norms exceed it
    model.zero_grad()
    loss, _ = PT.nci_loss_fn(model, {k: torch.from_numpy(v) for k, v in
                                     batches[0].items()}, PT.NCIStepConfig())
    loss.backward()
    for ps in opt.by_label.values():
        norms.append(float(torch.sqrt(sum(p.grad.square().sum()
                                          for p in ps))))
    assert min(norms) > TRAIN["max_grad_norm"]


def test_twin_step_equals_jax():
    rng = np.random.default_rng(3)
    kw = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
              num_layers=2, num_decoder_layers=2)
    jm = jt5.T5Model(jt5.T5Dims(dropout_rate=0.0, **kw))
    q = rng.integers(2, 60, (2, 5)).astype(np.int32)
    d = rng.integers(2, 60, (6, 7)).astype(np.int32)
    batch = {"query_ids": q, "query_mask": np.ones_like(q),
             "doc_ids": d, "doc_mask": np.ones_like(d)}
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(q),
                              jnp.asarray(q), jnp.zeros((2, 1), jnp.int32)
                              )["params"]
    fl = flat(params)
    cfg = dict(TRAIN, warmup_steps=0)
    jopt = JT.make_optimizer(JTrainConfig(**cfg), params, total_steps=4)
    jstate, jmetrics = JT.make_twin_train_step(jm, jopt, "t5")(
        JT.init_state(params, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = load_flax_params(pt5.T5Model(pt5.T5Dims(**kw), device="cpu"), fl)
    opt = PT.make_optimizer(TrainConfig(**cfg), tm, total_steps=4)
    state, metrics = PT.make_twin_train_step(Tower("t5", tm))(
        PT.init_state(tm, opt), batch)
    np.testing.assert_allclose(metrics["co_loss"].item(),
                               float(jmetrics["co_loss"]), atol=ATOL)
    close_trees(state_dict_to_flax(tm), flat(jstate.params))
