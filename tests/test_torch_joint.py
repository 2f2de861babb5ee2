"""Port parity of ``mevi_tpu_torch.train.joint`` and the EMA codebooks of
``ops/rq.py`` against ``mevi_tpu``: joint labels, one joint step per
configuration (``pq_loss`` 'label' and 'ce', ``centroid_update_loss
reconstruct``, fixnci/fixpq/fixdocenc with frozen updates exactly 0,
precomputed labels), ``ema_update`` without restart exactly and with
restart structurally, and the EMA step.  float32 on the CPU, dropout
off, tolerance 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.config import TrainConfig as JTrainConfig
from mevi_tpu.models.bert import BertDims as JBertDims
from mevi_tpu.models.bert import BertEncoderModel as JBert
from mevi_tpu.models.nci import NCIDims as JNCIDims
from mevi_tpu.models.nci import NCIT5 as JNCIT5
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu.ops import rq as jrq
from mevi_tpu.train import joint as JJ
from mevi_tpu.train import trainer as JT
from mevi_tpu_torch.config import TrainConfig
from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims
from mevi_tpu_torch.models.twin_tower import Tower
from mevi_tpu_torch.ops import rq as prq
from mevi_tpu_torch.train import joint as PJ
from mevi_tpu_torch.train import trainer as PT
from mevi_tpu_torch.weights import flax_names, load_flax_params, \
    state_dict_to_flax

ATOL = 2e-5
KARY, M, D = 4, 2, 32
T5KW = dict(vocab_size=64, d_model=D, d_kv=8, d_ff=64, num_heads=4,
            num_layers=2, num_decoder_layers=2)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
             adaptor_num_heads=4, adaptor_d_ff=64)
BERTKW = dict(vocab_size=64, d_model=D, num_layers=2, num_heads=4, d_ff=64,
              max_position_embeddings=32)
TRAIN = dict(learning_rate=1e-3, decoder_learning_rate=5e-4,
             docenc_learning_rate=2e-3, weight_decay=0.1, max_grad_norm=1.0)


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    b, Lq, Ld, n_neg = 8, 6, 8, 3
    batch = {
        "query_ids": rng.integers(1, 60, (b, Lq)).astype(np.int32),
        "query_mask": np.ones((b, Lq), np.int32),
        "pos_doc_ids": rng.integers(1, 60, (b, Ld)).astype(np.int32),
        "pos_doc_mask": np.ones((b, Ld), np.int32),
        "neg_doc_ids": rng.integers(1, 60, (b, n_neg, Ld)).astype(np.int32),
        "neg_doc_mask": np.ones((b, n_neg, Ld), np.int32),
        "codes": rng.integers(0, KARY, (b, M)).astype(np.int32),
    }
    jnci = JNCIT5(JNCIDims(t5=JT5Dims(dropout_rate=0.0, **T5KW), **NCIKW))
    jtower = JBert(JBertDims(dropout_rate=0.0, **BERTKW))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    nci_params = jax.jit(jnci.init)(jax.random.PRNGKey(0), jb["query_ids"],
                                    jb["query_mask"],
                                    jnp.zeros((b, M + 2), jnp.int32))["params"]
    tparams = jax.jit(jtower.init)(jax.random.PRNGKey(1), jb["pos_doc_ids"],
                                   jb["pos_doc_mask"])["params"]
    codebooks = jnp.asarray(rng.normal(size=(M, KARY, D)).astype(np.float32))
    params = {"nci": nci_params, "tower": tparams, "codebooks": codebooks}

    def tower_rep(tp, ids, mask):
        return jtower.apply({"params": tp}, ids, mask,
                            method=JBert.cls_rep)
    return jnci, tower_rep, params, batch


def port_joint(params):
    fl = flat(params)
    nci = NCIT5(NCIDims(t5=T5Dims(dropout_rate=0.0, **T5KW), **NCIKW),
                device="cpu")
    load_flax_params(nci, {k[4:]: v for k, v in fl.items()
                           if k.startswith("nci/")})
    tower = BertEncoderModel(BertDims(dropout_rate=0.0, **BERTKW),
                             device="cpu")
    load_flax_params(tower, {k[6:]: v for k, v in fl.items()
                             if k.startswith("tower/")})
    return PJ.JointModel(nci, Tower("bert", tower),
                         torch.from_numpy(fl["codebooks"].copy()))


FIX = [{}, {"fixnci": True}, {"fixpq": True}, {"fixdocenc": True}]


@pytest.mark.parametrize("fix", FIX, ids=["none", "fixnci", "fixpq",
                                          "fixdocenc"])
def test_joint_labels(setup, fix):
    *_, params, _ = setup
    paths = list(flax_names(port_joint(params)).values())
    assert sorted(paths) == sorted(flat(params))
    assert PJ.joint_param_labels(paths, **fix) == flat(
        JJ.joint_param_labels(params, **fix))


STEP_CASES = {
    "label": (dict(pq_loss="label"), {}),
    "ce_reconstruct": (dict(pq_loss="ce",
                            centroid_update_loss="reconstruct",
                            centroid_loss_scale=0.5), {}),
    "fixnci_precomputed_codes": (dict(pq_loss="label", runtime_label=False),
                                 {"fixnci": True}),
    "fixpq": (dict(pq_loss="ce"), {"fixpq": True}),
    "fixdocenc": (dict(pq_loss="ce"), {"fixdocenc": True}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_joint_step_equals_jax(setup, case):
    jnci, tower_rep, params, batch = setup
    step_kw, fix = STEP_CASES[case]
    jcfg = JJ.JointStepConfig(**step_kw)
    jopt = JT.make_optimizer(JTrainConfig(**TRAIN), params, total_steps=4,
                             labels=JJ.joint_param_labels(params, **fix))
    jstate, jm = JJ.make_joint_train_step(jnci, tower_rep, jopt, jcfg)(
        JT.init_state(params, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()}, None)

    model = port_joint(params)
    before = state_dict_to_flax(model)
    labels = PJ.joint_param_labels(flax_names(model).values(), **fix)
    opt = PT.make_optimizer(TrainConfig(**TRAIN), model, total_steps=4,
                            labels=labels)
    state, pm = PJ.make_joint_train_step(
        model, PJ.JointStepConfig(**step_kw))(
        PT.init_state(model, opt), batch)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), atol=ATOL,
                                   err_msg=k)
    got, ref = state_dict_to_flax(model), flat(jstate.params)
    assert set(got) == set(ref)
    for k in ref:
        if k.endswith("attn/key/bias") and labels[k] != "frozen":
            # BERT's key bias has no true gradient (q.(k+b) shifts every
            # key's score by the same q.b): its gradient is float32
            # rounding noise, and Adam's first update turns it into
            # +-lr in either package, so only that bound is held
            for upd in (got[k] - before[k], ref[k] - before[k]):
                assert np.abs(upd).max() <= TRAIN["docenc_learning_rate"] \
                    * (1 + 1e-5), k
            continue
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0,
                                   err_msg=k)
        if labels[k] == "frozen":
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
    assert any(labels[k] == "frozen" for k in labels) == bool(fix)


def _ema_inputs():
    rng = np.random.default_rng(7)
    n, Mm, K, d = 64, 2, 4, 8
    cbs = rng.normal(size=(Mm, K, d)).astype(np.float32)
    vec = rng.normal(size=(n, d)).astype(np.float32)
    codes = rng.integers(0, K, (n, Mm)).astype(np.int32)
    # a state with counts above 1, so that no centroid is dead
    size = rng.uniform(1.5, 4.0, (Mm, K)).astype(np.float32)
    esum = rng.normal(size=(Mm, K, d)).astype(np.float32)
    return cbs, vec, codes, size, esum


def test_ema_update_without_restart_equals_jax():
    cbs, vec, codes, size, esum = _ema_inputs()
    jst, jcb = jrq.ema_update(jrq.EMAState(jnp.asarray(size),
                                           jnp.asarray(esum)),
                              jnp.asarray(cbs), jnp.asarray(vec),
                              jnp.asarray(codes), jax.random.PRNGKey(0),
                              decay=0.9, restart=False)
    pst, pcb = prq.ema_update(prq.EMAState(torch.from_numpy(size),
                                           torch.from_numpy(esum)),
                              torch.from_numpy(cbs), torch.from_numpy(vec),
                              torch.from_numpy(codes), decay=0.9,
                              restart=False)
    np.testing.assert_allclose(pcb.numpy(), np.asarray(jcb), atol=1e-6)
    np.testing.assert_allclose(pst.cluster_size.numpy(),
                               np.asarray(jst.cluster_size), atol=1e-6)
    np.testing.assert_allclose(pst.embed_sum.numpy(),
                               np.asarray(jst.embed_sum), atol=1e-6)
    init = prq.ema_init(torch.from_numpy(cbs))
    jinit = jrq.ema_init(jnp.asarray(cbs))
    np.testing.assert_array_equal(init.cluster_size.numpy(),
                                  np.asarray(jinit.cluster_size))
    np.testing.assert_array_equal(init.embed_sum.numpy(),
                                  np.asarray(jinit.embed_sum))


def test_ema_update_restart_structure():
    """Dead centroids (count < 1) restart at rows of the batch drawn from
    the generator, with count 1; live ones follow the EMA; the draw is a
    function of the generator's seed."""
    cbs, vec, codes, size, esum = _ema_inputs()
    size[0, :2] = 0.0                       # two dead centroids at level 0
    st = prq.EMAState(torch.from_numpy(size), torch.from_numpy(esum))
    runs = [prq.ema_update(st, torch.from_numpy(cbs), torch.from_numpy(vec),
                           torch.from_numpy(codes),
                           torch.Generator().manual_seed(s), decay=0.99)
            for s in (3, 3, 4)]
    (s1, c1), (s2, c2), (s3, c3) = runs
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    ref, _ = prq.ema_update(st, torch.from_numpy(cbs), torch.from_numpy(vec),
                            torch.from_numpy(codes), restart=False)
    dead = ref.cluster_size < 1.0
    assert dead.sum() >= 2
    assert torch.all(s1.cluster_size[dead] == 1.0)
    torch.testing.assert_close(s1.cluster_size[~dead],
                               ref.cluster_size[~dead])
    rows = torch.from_numpy(vec)
    for m, k in dead.nonzero().tolist():
        assert (s1.embed_sum[m, k] == rows).all(1).any()
    assert not torch.equal(s1.embed_sum, s3.embed_sum)
    assert torch.isfinite(c1).all() and c1.dtype == torch.float32


def test_joint_ema_step(setup):
    """The EMA variant: gradients leave the (frozen) codebooks alone, the
    EMA moves them; the other parameters take the plain joint step's
    update."""
    jnci, tower_rep, params, batch = setup
    model = port_joint(params)
    labels = PJ.joint_param_labels(flax_names(model).values(), fixpq=True)
    opt = PT.make_optimizer(TrainConfig(**TRAIN), model, total_steps=4,
                            labels=labels)
    ema = prq.ema_init(model.codebooks.detach())
    cfg = PJ.JointStepConfig(pq_loss="label")
    state, ema2, pm = PJ.make_joint_train_step_ema(model, cfg)(
        PT.init_state(model, opt), ema, batch,
        torch.Generator().manual_seed(0))
    assert np.isfinite(float(pm["loss"]))
    assert not np.allclose(model.codebooks.detach().numpy(),
                           flat(params)["codebooks"])
    assert ema2.cluster_size.shape == (M, KARY)
    plain = port_joint(params)
    popt = PT.make_optimizer(TrainConfig(**TRAIN), plain, total_steps=4,
                             labels=labels)
    PJ.make_joint_train_step(plain, cfg)(PT.init_state(plain, popt), batch)
    got, ref = state_dict_to_flax(model), state_dict_to_flax(plain)
    for k in ref:
        if k != "codebooks":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
