"""Port parity of the models' training side: NCIT5 teacher-forced logits
and every parameter gradient of ``nci_loss_fn`` by flax name (R-drop at
dropout rate 0 included), ``T5EncoderModel``, ``T5Model.first_token_rep``
and BERT ``cls_rep`` forwards and gradients, the NCI label helpers; and
dropout on its own terms (JAX's dropout streams cannot be matched):
``eval()`` equals the JAX deterministic forward, ``train()`` drops at
the rate with ``1/(1-p)`` scaling where the JAX modules place dropout,
``remat`` on and off give the same gradients.  float32 on the CPU,
tolerance 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.models import bert as jbert
from mevi_tpu.models import nci as jnci
from mevi_tpu.models import t5 as jt5
from mevi_tpu.train import trainer as JT
from mevi_tpu_torch.models import bert as pbert
from mevi_tpu_torch.models import nci as pnci
from mevi_tpu_torch.models import t5 as pt5
from mevi_tpu_torch.train import trainer as PT
from mevi_tpu_torch.weights import flax_names, load_flax_params

ATOL = 2e-5
B, LQ, M, KARY = 4, 7, 3, 4
T5KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
            num_layers=2, num_decoder_layers=2)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=2,
             adaptor_num_heads=4, adaptor_d_ff=64)


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def port_grads(model):
    """Each parameter's gradient under its flax path, in flax layout."""
    names = flax_names(model)
    out = {}
    for n, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        if names[n].rsplit("/", 1)[-1] in ("kernel", "in_proj_kernel"):
            g = g.T
        out[names[n]] = g
    return out


def close_grads(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def port_nci(params, dropout=0.0, remat=False):
    dims = pnci.NCIDims(t5=pt5.T5Dims(dropout_rate=dropout, remat=remat,
                                      **T5KW), **NCIKW)
    return load_flax_params(pnci.NCIT5(dims, device="cpu"), params)


@pytest.fixture(scope="module")
def nci_pair():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 60, (B, LQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    codes = rng.integers(0, KARY, (B, M)).astype(np.int32)
    jmodel = jnci.NCIT5(jnci.NCIDims(t5=jt5.T5Dims(dropout_rate=0.0,
                                                   **T5KW), **NCIKW))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                         jnp.asarray(mask),
                         jnp.zeros((B, M + 2), jnp.int32))["params"]
    batch = {"query_ids": ids, "query_mask": mask, "codes": codes}
    return jmodel, params, flat(params), batch


def test_make_and_compact_labels(nci_pair):
    *_, batch = nci_pair
    codes = batch["codes"]
    jl, ji = jnci.make_labels(jnp.asarray(codes), KARY, M + 2)
    pl, pi = pnci.make_labels(torch.from_numpy(codes), KARY, M + 2)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    dims_j = jnci.NCIDims(t5=jt5.T5Dims(**T5KW), **NCIKW)
    dims_p = pnci.NCIDims(t5=pt5.T5Dims(**T5KW), **NCIKW)
    np.testing.assert_array_equal(
        pnci.compact_labels(torch.from_numpy(codes), dims_p).numpy(),
        np.asarray(jnci.compact_labels(jnp.asarray(codes), dims_j)))
    assert pl.dtype == pi.dtype == torch.int32


def test_teacher_forced_logits(nci_pair):
    jmodel, params, fparams, batch = nci_pair
    _, dec_in = jnci.make_labels(jnp.asarray(batch["codes"]), KARY, M + 2)
    ref = jax.jit(jmodel.apply)({"params": params},
                                jnp.asarray(batch["query_ids"]),
                                jnp.asarray(batch["query_mask"]), dec_in)
    model = port_nci(fparams)
    got = model(torch.from_numpy(batch["query_ids"]),
                torch.from_numpy(batch["query_mask"]),
                torch.from_numpy(np.array(dec_in)))
    for g, r in zip(got[:3], ref[:3]):
        close(g.detach(), r)
    close(pnci.compact_to_full_logits(got[0].detach(), model.dims),
          jax.jit(jnci.compact_to_full_logits, static_argnums=1)(
              ref[0], jmodel.dims))


@pytest.mark.parametrize("rdrop_loss", [None, "KL", "Contrast", "L2"])
def test_nci_loss_and_gradients(nci_pair, rdrop_loss):
    """Every parameter gradient by flax name; with R-drop the dropout
    rate is 0, so the two halves are equal and the R-drop losses have
    exact JAX values."""
    jmodel, params, fparams, batch = nci_pair
    kw = {} if rdrop_loss is None else dict(rdrop=0.5, rdrop_loss=rdrop_loss)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the JAX step needs a key once R-drop is on; at rate 0 it draws none
    key = None if rdrop_loss is None else jax.random.PRNGKey(0)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.nci_loss_fn(jmodel, p, jb, key,
                                 JT.NCIStepConfig(**kw)), has_aux=True))(
        params)
    model = port_nci(fparams).requires_grad_(True)
    model.train(rdrop_loss is not None)
    loss, pm = PT.nci_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        PT.NCIStepConfig(**kw))
    loss.backward()
    assert set(pm) == set(jm)
    for k in jm:
        close(pm[k].item(), jm[k])
    close_grads(port_grads(model), flat(jg))


def _rep_grads_check(jfn, jparams, tmodel, tfn, inputs, w):
    """Forward and every parameter gradient of sum(rep * w).  The weights
    w are N(0, 0.1^2): with N(0, 1) the embedding gradients reach ~60,
    where float32 rounding alone puts both packages ~5e-5 off a float64
    recomputation."""
    ref = jax.jit(jfn)(jparams, *inputs)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p, *inputs) * w)))(
        jparams)
    tmodel.requires_grad_(True)
    rep = tfn(*[torch.from_numpy(np.array(x)) for x in inputs])
    close(rep.detach(), ref)
    (rep * torch.from_numpy(np.array(w))).sum().backward()
    close_grads(port_grads(tmodel), flat(grads))


def _tokens(rng, b=3, length=6, vocab=60):
    ids = rng.integers(2, vocab, (b, length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 4:] = 0
    return ids, mask


@pytest.mark.parametrize("which", ["encoder", "first_token_rep"])
def test_t5_training_forward_and_gradients(which):
    rng = np.random.default_rng(1)
    ids, mask = _tokens(rng)
    jd = jt5.T5Dims(dropout_rate=0.0, **T5KW)
    if which == "encoder":
        jm = jt5.T5EncoderModel(jd)
        params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(ids),
                         jnp.asarray(mask))["params"]
        tm = load_flax_params(pt5.T5EncoderModel(pt5.T5Dims(**T5KW),
                                                 device="cpu"), flat(params))

        def jfn(p, i, m):
            return jm.apply({"params": p}, i, m)
        tfn = tm
        w = (0.1 * rng.normal(size=(3, 6, 32))).astype(np.float32)
    else:
        jm = jt5.T5Model(jd)
        params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(ids),
                         jnp.asarray(mask),
                         jnp.zeros((3, 1), jnp.int32))["params"]
        tm = load_flax_params(pt5.T5Model(pt5.T5Dims(**T5KW), device="cpu"),
                              flat(params))

        def jfn(p, i, m):
            return jm.apply({"params": p}, i, m,
                            method=jt5.T5Model.first_token_rep)
        tfn = tm.first_token_rep
        w = (0.1 * rng.normal(size=(3, 32))).astype(np.float32)
    _rep_grads_check(jfn, params, tm, tfn,
                     (jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(w))


def test_bert_cls_rep_forward_and_gradients():
    rng = np.random.default_rng(3)
    ids, mask = _tokens(rng)
    kw = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, d_ff=64,
              max_position_embeddings=16)
    jm = jbert.BertEncoderModel(jbert.BertDims(dropout_rate=0.0, **kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(ids),
                     jnp.asarray(mask))["params"]
    tm = load_flax_params(pbert.BertEncoderModel(pbert.BertDims(**kw),
                                                 device="cpu"), flat(params))

    def jfn(p, i, m):
        return jm.apply({"params": p}, i, m,
                        method=jbert.BertEncoderModel.cls_rep)
    w = (0.1 * rng.normal(size=(3, 32))).astype(np.float32)
    _rep_grads_check(jfn, params, tm, tm.cls_rep,
                     (jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(w))


# --------------------------------------------------------------------------
# dropout on its own terms
# --------------------------------------------------------------------------

def _dropout_sites(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, torch.nn.Dropout)}


def test_dropout_sites_are_the_jax_modules():
    """T5: stack input/output, each residual branch, inside the FF (none
    on attention probabilities); PAWA: attention probabilities, each
    attention output, the FF."""
    model = pnci.NCIT5(pnci.NCIDims(
        t5=pt5.T5Dims(dropout_rate=0.1, **T5KW), **NCIKW), device="cpu")
    want = set()
    for stack in ("encoder", "decoder"):
        want.add(f"{stack}.dropout")
        for i in range(2):
            want |= {f"{stack}.blocks.{i}.dropout",
                     f"{stack}.blocks.{i}.ff.dropout"}
    for i in range(2):
        want |= {f"pawa.layers.{i}.{s}" for s in
                 ("dropout", "self_attn.dropout", "cross_attn.dropout")}
    sites = _dropout_sites(model)
    assert set(sites) == want
    assert all(m.p == 0.1 for m in sites.values())
    assert not model.training                  # built for serving


def test_eval_is_deterministic_and_train_drops(nci_pair):
    jmodel, params, fparams, batch = nci_pair
    ids, mask = (torch.from_numpy(batch[k]) for k in ("query_ids",
                                                      "query_mask"))
    _, dec_in = pnci.make_labels(torch.from_numpy(batch["codes"]), KARY,
                                 M + 2)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids.numpy()),
                                jnp.asarray(mask.numpy()),
                                jnp.asarray(dec_in.numpy()))[0]
    p = 0.25
    model = port_nci(fparams, dropout=p).eval()
    with torch.no_grad():
        close(model(ids, mask, dec_in)[0], ref)
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: seen.append((inp[0], out)))
            for m in _dropout_sites(model).values()]
        model.train()
        with PT.dropout_rng(torch.Generator().manual_seed(0),
                            torch.device("cpu")):
            out = model(ids, mask, dec_in)[0]
        for h in hooks:
            h.remove()
    assert not torch.allclose(out, torch.from_numpy(np.array(ref)),
                              atol=1e-3)
    x = torch.cat([i.reshape(-1) for i, _ in seen])
    y = torch.cat([o.reshape(-1) for _, o in seen])
    kept = y != 0
    live = x != 0
    rate = 1.0 - (kept & live).sum().item() / live.sum().item()
    assert abs(rate - p) < 0.02, rate
    torch.testing.assert_close(y[kept], x[kept] / (1 - p))


def test_remat_gives_the_same_gradients(nci_pair):
    """Dropout on (rate 0.1), the same generator: ``torch.utils.checkpoint``
    replays each block's dropout, so the gradients match."""
    *_, fparams, batch = nci_pair
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        model = port_nci(fparams, dropout=0.1, remat=remat)
        model.requires_grad_(True).train()
        with PT.dropout_rng(torch.Generator().manual_seed(5),
                            torch.device("cpu")):
            loss, _ = PT.nci_loss_fn(model, tb, PT.NCIStepConfig())
            loss.backward()
        grads.append((loss.item(), port_grads(model)))
    assert grads[0][0] == grads[1][0]
    close_grads(grads[1][1], grads[0][1])
