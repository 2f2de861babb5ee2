"""Rank bodies of the multi-rank parity tests (``test_torch_parallel*.py``),
spawned by ``mevi_tpu_torch.parallel.mesh.launch_local``: they import
torch and the port only, take numpy inputs (weights as flat flax paths)
and return numpy results.  Not collected by pytest (no ``test_`` prefix)."""

from __future__ import annotations

import numpy as np
import torch

from mevi_tpu_torch.config import TrainConfig
from mevi_tpu_torch.eval import searcher as S
from mevi_tpu_torch.index.build import embed_corpus, make_sharded_rep_fn
from mevi_tpu_torch.models import twin_tower as tt
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.ops import rq as rq_ops
from mevi_tpu_torch.ops.mips import sharded_mips_topk
from mevi_tpu_torch.parallel import mesh as PM
from mevi_tpu_torch.serve import ShardedBucketServer, gather_batch
from mevi_tpu_torch.train import joint as J
from mevi_tpu_torch.train import trainer as T
from mevi_tpu_torch.weights import (flax_names, load_flax_params,
                                    state_dict_to_flax)


def _np(t):
    return t.detach().cpu().numpy()


def _t(x, dev):
    """A copy of ``x`` on ``dev`` (steps update some inputs in place)."""
    return torch.from_numpy(np.array(x)).to(dev)


def _gathered(outs, mesh):
    return [_np(t) for t in gather_batch(outs, mesh)]


def nci_model(inp, dev):
    dims = NCIDims(t5=T5Dims(**inp["t5"]), **inp["nci"])
    return load_flax_params(NCIT5(dims, device=dev), inp["nci_params"])


def t5_model(inp, dev, key="q_params"):
    return load_flax_params(T5Model(T5Dims(**inp["t5"]), device=dev),
                            inp[key])


# ---------------------------------------------------------------------------
# retrieval side: 4 ranks
# ---------------------------------------------------------------------------

def _groups(mesh):
    r = torch.tensor([mesh.rank])
    return {"coords": mesh.coords,
            "data": _np(PM.gather_rows(r, mesh, PM.DATA_AXIS)).tolist(),
            "corpus": _np(PM.gather_rows(r, mesh, PM.CORPUS_AXIS)).tolist()}


def retrieval_rank(dev, inp):
    out = {"groups": {}}
    for data, corpus in inp["shapes"]:
        out["groups"][(data, corpus)] = _groups(
            PM.make_mesh(data, corpus, device=dev))
    m14 = PM.make_mesh(1, 4, device=dev)
    out["shard_rows"] = {n: _np(PM.shard_rows(x, m14))
                         for n, x in inp["shard_rows"].items()}
    mesh = PM.make_mesh(2, 2, device=dev)

    # sharded MIPS
    out["mips"] = {}
    for name, (Q, D, k, chunk) in inp["mips"].items():
        s, i = sharded_mips_topk(_t(PM.data_slice(Q, mesh), dev),
                                 PM.shard_rows(D, mesh), k, mesh,
                                 n_rows=D.shape[0], chunk=chunk)
        out["mips"][name] = _gathered((s, i), mesh)

    # sharded fine rerank
    out["rerank"] = {}
    for name, (emb, doc_codes, queries, beams, kary, cap, pool) in \
            inp["rerank"].items():
        fine = S.build_fine_index(doc_codes, emb, kary, device=dev)
        fine = fine._replace(sorted_emb=PM.shard_rows(fine.sorted_emb, mesh))
        res = S.sharded_fine_rerank(
            _t(PM.data_slice(queries, mesh), dev),
            _t(PM.data_slice(beams, mesh), dev), fine, mesh, cap, pool,
            device=dev)
        out["rerank"][name] = _gathered(res, mesh)

    # sharded server, float32 and int8 shards
    sv = inp["server"]
    nci, qtower = nci_model(inp, dev), t5_model(inp, dev)
    ids = _t(PM.data_slice(sv["ids"], mesh), dev)
    mask = _t(PM.data_slice(sv["mask"], mesh), dev)
    out["server"] = {}
    for name, semb in sv["semb"].items():
        index = S.FineIndex(_t(sv["offsets"], dev), _t(sv["doc_ids"], dev),
                            PM.shard_rows(semb, mesh), sv["levels"],
                            inp["nci"]["kary"])
        server = ShardedBucketServer(qtower, nci, mesh, index, **sv["kw"])
        outs = server(ids, mask)
        out["server"][name] = _gathered(outs, mesh)
        # identical on the ranks of a corpus group
        out["server"][name + "_local_ids"] = _np(outs[1])

    # sharded corpus embedding
    rep = make_sharded_rep_fn(qtower.first_token_rep, mesh)
    out["rep"] = {bs: embed_corpus(rep, inp["rep_tokens"], inp["rep_masks"],
                                   batch_size=bs, device=dev)
                  for bs in inp["rep_batches"]}

    # cross-device negatives: loss, scores, gradients of the local rows
    q = _t(PM.data_slice(inp["co_q"], mesh), dev).requires_grad_(True)
    p = _t(PM.data_slice(inp["co_p"], mesh), dev).requires_grad_(True)
    loss, scores = tt.contrastive_loss(q, p, axis_name=PM.DATA_AXIS,
                                       mesh=mesh)
    (loss / mesh.data).backward()      # this rank's share of the loss
    out["co"] = (float(loss), _np(scores),
                 _gathered((q.grad, p.grad), mesh))
    return out


# ---------------------------------------------------------------------------
# training side: data-parallel steps
# ---------------------------------------------------------------------------

def _local(batch, mesh):
    return {k: PM.data_slice(v, mesh) for k, v in batch.items()}


def _adam_first_moments(model, opt):
    """Adam's first moments by flax path: (1 - beta1)-weighted sums of
    the gradients, which (unlike Adam's updates) keep their scale."""
    params = dict(model.named_parameters())
    return {path: _np(opt.inner.state[params[n]]["exp_avg"])
            for n, path in flax_names(model).items()
            if params[n] in opt.inner.state}


class InParts(torch.nn.Module):
    """``model`` run on each of ``parts`` row blocks of its inputs in
    turn, the outputs concatenated: one process's forward (and so
    backward) with the per-row layout of a ``parts``-rank data-parallel
    step; autograd sums the blocks' gradients."""

    def __init__(self, model, parts):
        super().__init__()
        self.model, self.parts, self.dims = model, parts, model.dims

    def forward(self, *xs):
        outs = [self.model(*b) for b in zip(*(x.chunk(self.parts)
                                               for x in xs))]
        return tuple(None if o[0] is None else torch.cat(o)
                     for o in zip(*outs))


class TowerInParts:
    """A twin :class:`~mevi_tpu_torch.models.twin_tower.Tower` whose reps
    are computed a row block at a time, as :class:`InParts`."""

    def __init__(self, tower, parts):
        self.tower, self.parts, self.module = tower, parts, tower.module

    def rep(self, ids, mask):
        return torch.cat([self.tower.rep(i, m) for i, m in
                          zip(ids.chunk(self.parts), mask.chunk(self.parts))])


def run_steps(kind, inp, dev, mesh, batches, case, parts=1):
    """Steps of ``kind`` from the case's weights over ``batches`` (each
    rank's slices, or the whole batches at mesh None; ``parts`` > 1, NCI
    and twin: in one process in the row layout of ``parts`` ranks);
    returns (flat params after, metrics of the last step, ema state or
    None, Adam's first moments)."""
    cfg = TrainConfig(**inp["train"])
    ema_out = None
    if kind == "nci":
        model = nci_model(inp, dev)
        opt = T.make_optimizer(cfg, model, total_steps=10)
        state = T.init_state(model, opt)
        step = T.make_nci_train_step(
            InParts(model, parts) if parts > 1 else model,
            T.NCIStepConfig(**case), mesh)
        for b in batches:
            state, metrics = step(state, b)
    elif kind == "twin":
        model = t5_model(inp, dev)
        opt = T.make_optimizer(cfg, model, total_steps=10)
        state = T.init_state(model, opt)
        tower = tt.Tower("t5", model)
        step = T.make_twin_train_step(
            TowerInParts(tower, parts) if parts > 1 else tower, mesh=mesh)
        for b in batches:
            state, metrics = step(state, b)
    else:
        nci, tower = nci_model(inp, dev), t5_model(inp, dev)
        model = J.JointModel(nci, tt.Tower("t5", tower),
                             _t(inp["codebooks"], dev))
        labels = J.joint_param_labels(flax_names(model).values())
        labels["codebooks"] = "frozen"
        opt = T.make_optimizer(cfg, model, total_steps=10, labels=labels)
        state = T.init_state(model, opt)
        ema = rq_ops.EMAState(*(_t(x, dev) for x in case["ema"]))
        step = J.make_joint_train_step_ema(
            model, J.JointStepConfig(**case["cfg"]), mesh=mesh)
        gen = torch.Generator().manual_seed(11)   # alike on every rank
        for b in batches:
            state, ema, metrics = step(state, ema, b, gen)
        ema_out = (_np(ema.cluster_size), _np(ema.embed_sum))
    return (state_dict_to_flax(model),
            {k: float(v) for k, v in metrics.items()}, ema_out,
            _adam_first_moments(model, opt))


def train_rank(dev, inp):
    # gradient all-reduce buckets of 4,096 elements, so the tiny models'
    # gradients travel in many buckets, as a full-width model's do
    PM._BUCKET_ELEMS = 4096
    mesh = PM.make_mesh(inp["mesh"][0], inp["mesh"][1], device=dev)
    out = {}
    for name, (kind, case) in inp["cases"].items():
        batches = [_local(b, mesh) for b in inp["batches"][kind]]
        out[name] = run_steps(kind, inp, dev, mesh, batches, case)
    # one process in the ranks' row layout, on its batches as given and
    # with their halves swapped (only the order of float32 sums differs)
    for name in inp.get("in_parts", ()):
        kind, case = inp["cases"][name]
        out["in_parts", name] = [
            run_steps(kind, inp, dev, None, [
                {k: np.concatenate(np.split(v, mesh.data)[::order])
                 for k, v in b.items()} for b in inp["batches"][kind]],
                case, parts=mesh.data) for order in (1, -1)]
    return out
