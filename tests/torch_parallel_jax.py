"""The JAX side and the checks of the data-parallel step tests
(``test_torch_parallel_train.py``, ``test_torch_parallel_joint.py``):
inputs made from a seed with numpy (weights from the JAX init), the
single-rank port step, JAX's jitted step on ``mesh8``, and the
comparisons.  The ranks' side is ``torch_parallel_ranks.py``."""

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from mevi_tpu.config import TrainConfig as JTrainConfig
from mevi_tpu.models.nci import NCIDims as JNCIDims
from mevi_tpu.models.nci import NCIT5 as JNCIT5
from mevi_tpu.models.t5 import T5Dims as JT5Dims
from mevi_tpu.models.t5 import T5Model as JT5Model
from mevi_tpu.ops import rq as jrq
from mevi_tpu.parallel.mesh import DATA_AXIS
from mevi_tpu.train import joint as JJ
from mevi_tpu.train import trainer as JT
from mevi_tpu_torch.parallel.mesh import single_device_mesh

ATOL = 2e-5
B, LQ, LD, NEG, KARY, M = 8, 6, 7, 2, 4, 2
T5KW = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
            num_layers=1, num_decoder_layers=1, dropout_rate=0.0)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
             adaptor_num_heads=4, adaptor_d_ff=32)
TRAIN = dict(learning_rate=3e-3, decoder_learning_rate=1e-3,
             docenc_learning_rate=2e-3, weight_decay=0.1, max_grad_norm=1.0,
             warmup_steps=0)

NCI_CASES = {"nci": {}, "nci_rdrop_kl": dict(rdrop=0.5, rdrop_loss="KL"),
             "nci_rdrop_l2": dict(rdrop=0.5, rdrop_loss="L2"),
             "nci_rdrop_contrast": dict(rdrop=0.5, rdrop_loss="Contrast")}
TWIN_CASES = {"twin": {}}
EMA_CASES = {
    "ema_label": dict(pq_loss="label"),
    "ema_ce_reconstruct": dict(pq_loss="ce",
                               centroid_update_loss="reconstruct",
                               centroid_loss_scale=0.5),
    "ema_kl": dict(pq_loss="kl"),
    "ema_kl_batch_neg": dict(pq_loss="kl", pq_negative="batch"),
    "ema_mse_sample_neg": dict(pq_loss="mse", pq_negative="sample"),
}
CASES = ([("nci", c) for c in NCI_CASES] + [("twin", c) for c in TWIN_CASES]
         + [("ema", c) for c in EMA_CASES])


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def close_trees(got, ref, atol=ATOL, steps=2):
    """Within ``atol``, except the key slice of PAWA's ``in_proj_bias``:
    a key bias has no true gradient (q.(k+b) shifts every key's score by
    the same q.b), so its gradient is float32 rounding noise that Adam
    turns into updates of up to lr a step on either side; only that
    bound is held there (as ``test_torch_joint.py`` holds BERT's)."""
    assert set(got) == set(ref)
    lr = max(TRAIN["learning_rate"], TRAIN["decoder_learning_rate"],
             TRAIN["docenc_learning_rate"])
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if k.endswith("self_attn/in_proj_bias"):
            key = np.s_[g.shape[0] // 3:2 * g.shape[0] // 3]
            assert np.abs(g[key] - r[key]).max() <= 2 * steps * lr * (
                1 + 1e-5), k
            g, r = np.delete(g, key), np.delete(r, key)
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=k)


def build_inputs(kinds):
    """Inputs of the cases of ``kinds`` (numpy, for the ranks) and the
    JAX side (models and parameter trees)."""
    rng = np.random.default_rng(0)

    def tokens(*shape):
        return rng.integers(2, 60, shape).astype(np.int32)

    batches = {"nci": [], "twin": [], "ema": []}
    for _ in range(2):
        q = tokens(B, LQ)
        qm = np.ones_like(q)
        qm[1, 4:] = 0
        codes = rng.integers(0, KARY, (B, M)).astype(np.int32)
        batches["nci"].append({"query_ids": q, "query_mask": qm,
                               "codes": codes})
        d = tokens(B * 2, LD)
        batches["twin"].append({"query_ids": q, "query_mask": qm,
                                "doc_ids": d, "doc_mask": np.ones_like(d)})
        pos, neg = tokens(B, LD), tokens(B, NEG, LD)
        batches["ema"].append({
            "query_ids": q, "query_mask": qm, "pos_doc_ids": pos,
            "pos_doc_mask": np.ones_like(pos), "neg_doc_ids": neg,
            "neg_doc_mask": np.ones_like(neg), "codes": codes})
    jt5 = JT5Dims(**T5KW)
    jnci, jq = JNCIT5(JNCIDims(t5=jt5, **NCIKW)), JT5Model(jt5)
    b0 = batches["nci"][0]
    nci_params = jax.jit(jnci.init)(
        jax.random.PRNGKey(0), jnp.asarray(b0["query_ids"]),
        jnp.asarray(b0["query_mask"]),
        jnp.zeros((B, M + 2), jnp.int32))["params"]
    q_params = jax.jit(jq.init)(
        jax.random.PRNGKey(1), jnp.asarray(b0["query_ids"]),
        jnp.asarray(b0["query_mask"]), jnp.zeros((B, 1), jnp.int32))["params"]
    codebooks = rng.normal(size=(M, KARY, T5KW["d_model"])).astype(np.float32)
    alive = (np.full((M, KARY), 5.0, np.float32), 5.0 * codebooks)
    dead = (np.zeros((M, KARY), np.float32),
            np.zeros_like(codebooks))
    cases = {}
    for kind, name in CASES:
        case = {"nci": NCI_CASES, "twin": TWIN_CASES}.get(kind, {}).get(name)
        if kind == "ema":
            case = {"cfg": EMA_CASES[name], "ema": alive}
        if kind in kinds:
            cases[name] = (kind, case)
    if "ema" in kinds:
        cases["ema_restart"] = ("ema", {"cfg": dict(pq_loss="label"),
                                        "ema": dead})
    inp = {"t5": T5KW, "nci": NCIKW, "train": TRAIN,
           "nci_params": flat(nci_params), "q_params": flat(q_params),
           "codebooks": codebooks, "cases": cases,
           "batches": {k: v for k, v in batches.items() if k in kinds},
           "mesh": (2, 1)}
    jax_side = dict(jnci=jnci, jq=jq, nci_params=nci_params,
                    q_params=q_params)
    return inp, jax_side



def single(inp, name):
    """The port's step on the whole batches, on a one-rank mesh."""
    kind, case = inp["cases"][name]
    return R.run_steps(kind, inp, "cpu", single_device_mesh("cpu"),
                       inp["batches"][kind], case)


def sharded(batch, mesh):
    return {k: jax.device_put(v, NamedSharding(
        mesh, P(DATA_AXIS, *([None] * (v.ndim - 1)))))
        for k, v in batch.items()}


def jax_steps(kind, name, jx, inp, mesh8):
    """JAX's jitted steps over the batches sharded on mesh8's data axis;
    returns (flat params, metrics, ema state or None)."""
    repl = NamedSharding(mesh8, P())
    cfg = JTrainConfig(**TRAIN)
    bs = [sharded(b, mesh8) for b in inp["batches"][kind]]
    if kind == "nci":
        opt = JT.make_optimizer(cfg, jx["nci_params"], total_steps=10)
        state = jax.device_put(JT.init_state(jx["nci_params"], opt), repl)
        step = JT.make_nci_train_step(
            jx["jnci"], opt, JT.NCIStepConfig(**NCI_CASES[name]),
            donate=False)
        for b in bs:     # R-drop needs a key (dropout is off: rate 0)
            state, m = step(state, b, jax.random.PRNGKey(0))
        return flat(state.params), m, None
    if kind == "twin":
        opt = JT.make_optimizer(cfg, jx["q_params"], total_steps=10)
        state = jax.device_put(JT.init_state(jx["q_params"], opt), repl)
        step = JT.make_twin_train_step(jx["jq"], opt, "t5")
        for b in bs:
            state, m = step(state, b)
        return flat(state.params), m, None
    jq = jx["jq"]

    def tower_rep(tp, ids, mask):
        return jq.apply({"params": tp}, ids, mask,
                        method=JT5Model.first_token_rep)
    params = {"nci": jx["nci_params"], "tower": jx["q_params"],
              "codebooks": jnp.asarray(inp["codebooks"])}
    labels = JJ.joint_param_labels(params)
    labels["codebooks"] = "frozen"
    opt = JT.make_optimizer(cfg, params, total_steps=10, labels=labels)
    state = jax.device_put(JT.init_state(params, opt), repl)
    ema = jax.device_put(jrq.EMAState(*(jnp.asarray(x) for x in
                                        inp["cases"][name][1]["ema"])), repl)
    step = JJ.make_joint_train_step_ema(
        jx["jnci"], tower_rep, opt, JJ.JointStepConfig(**EMA_CASES[name]))
    for b in bs:
        state, ema, m = step(state, ema, b, jax.random.PRNGKey(2))
    return (flat(state.params), m,
            (np.asarray(ema.cluster_size), np.asarray(ema.embed_sum)))


def check_ranks(ranks, name, single):
    params, metrics, ema, adam = single
    for res in ranks:
        p, m, e, a = res[name]
        for k in p:      # the data group's ranks hold one model
            np.testing.assert_array_equal(p[k], ranks[0][name][0][k],
                                          err_msg=k)
        close_trees(p, params)
        close_trees(a, adam)
        assert set(m) == set(metrics)
        for k in m:
            np.testing.assert_allclose(m[k], metrics[k], atol=ATOL,
                                       err_msg=k)
        if ema is not None:
            for got, ref in zip(e, ema):
                np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


def check_case(ranks, setup, mesh8, kind, name):
    """The ranks against the single-rank port step and against JAX."""
    inp, jx = setup
    check_ranks(ranks, name, single(inp, name))
    jparams, jmetrics, jema = jax_steps(kind, name, jx, inp, mesh8)
    close_trees(ranks[0][name][0], jparams)
    for k, v in ranks[0][name][1].items():
        np.testing.assert_allclose(v, float(jmetrics[k]), atol=ATOL,
                                   err_msg=k)
    if jema is not None:
        for got, ref in zip(ranks[0][name][2], jema):
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)
