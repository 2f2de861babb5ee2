"""Joint NCI + codebook + twin-tower training (port of
``mevi_tpu.train.joint``; the reference's ``--codebook 1 --pq_runtime_label
1`` mode, ``main_models.py:2197-2584``):

1. embed the positive passages with the (possibly frozen) document tower,
2. assign runtime RQ labels and per-level codebook logits,
3. NCI forward on those labels; the compact slice logits are
   ``nci_logits``,
4. PQ distillation loss between NCI and codebook logits (in place of the
   CE loss unless ``pq_loss == 'label'``),
5. twin co-loss on (query, positive + sampled in-cluster negatives),
6. optional codebook reconstruction loss.

Loss = nci (or distill) + co + centroid_scale * reconstruction, with
per-part freezing through optimizer labels (fixnci/fixpq/fixdocenc).
The codebook logits and the reconstruction run in float32 outside the
compute dtype's autocast.  With a mesh, each loss reads its per-row
inputs gathered over the data axis (``trainer``'s data parallelism), and
the EMA statistics are the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..models import twin_tower as tt
from ..models.nci import NCIT5, compact_labels, make_labels
from ..ops import rq as rq_ops
from ..parallel.mesh import DATA_AXIS, Mesh
from . import losses as L
from .trainer import (TrainState, apply_gradients, batch_gather,
                      compute_autocast, detach_metrics, dropout_rng,
                      model_device, rank_share, to_device)


@dataclasses.dataclass(frozen=True)
class JointStepConfig:
    pq_loss: str = "ce"            # 'label' = plain CE on runtime labels
    pq_softmax_tau: float = 1.0
    pq_negative: str = "none"
    centroid_update_loss: str = "none"   # 'none' | 'reconstruct'
    centroid_loss_scale: float = 1.0
    no_nci_loss: bool = False
    no_twin_loss: bool = False
    dist_mode: str = "l2"
    rdrop: float = 0.0
    # False (``--pq_runtime_label 0``): NCI labels come from the batch's
    # precomputed 'codes' instead of the live tower+codebook assignment
    runtime_label: bool = True


class JointModel(nn.Module):
    """The joint step's parameters, named as the JAX package's
    ``JointParams`` tree: ``nci/...``, ``tower/...`` and ``codebooks``
    (M, K, d)."""

    def __init__(self, nci: NCIT5, tower: tt.Tower, codebooks: torch.Tensor):
        super().__init__()
        self.nci = nci
        self.tower = tower.module
        self.family = tower.family
        self.codebooks = nn.Parameter(codebooks, requires_grad=False)

    def tower_rep(self, input_ids, attention_mask) -> torch.Tensor:
        return tt.Tower(self.family, self.tower).rep(input_ids,
                                                     attention_mask)


def joint_param_labels(paths: Iterable[str], fixnci: bool = False,
                       fixpq: bool = False, fixdocenc: bool = False
                       ) -> Dict[str, str]:
    """Optimizer labels by flax path; the ``fix*`` switches route whole
    parts to 'frozen' (the reference's ``requires_grad=False`` per part,
    ``main_models.py:1594-1641``)."""
    def label(path):
        parts = path.split("/")
        if parts[0] == "codebooks":
            return "frozen" if fixpq else "docenc"   # codebook LR group
        if parts[0] == "tower":
            return "frozen" if fixdocenc else "docenc"
        if fixnci:
            return "frozen"
        top = parts[1] if len(parts) > 1 else parts[0]
        return "encoder" if top in ("shared", "encoder") else "decoder"
    return {p: label(p) for p in paths}


def joint_loss_fn(model: JointModel, batch: Dict[str, torch.Tensor],
                  cfg: JointStepConfig, gather=lambda x: x
                  ) -> Tuple[torch.Tensor, Dict]:
    """batch: query_ids/mask (b, Lq); pos_doc_ids/mask (b, Ld);
    neg_doc_ids/mask (b, n_neg, Ld) in-cluster negatives; optional
    codes (b, M).  NCI dropout follows ``model.nci``'s mode.
    ``gather``: applied to each per-row tensor the losses read
    (``trainer.batch_gather``; the identity on one rank)."""
    nci = model.nci
    dims = nci.dims
    kary, M = dims.kary, dims.code_len
    dev = model.codebooks.device

    # 1-2) RQ labels + codebook logits from the live reps
    p_reps = model.tower_rep(batch["pos_doc_ids"], batch["pos_doc_mask"])
    with torch.autocast(dev.type, enabled=False):
        codes, pq_logits = rq_ops.assign_with_logits(
            p_reps.float(), model.codebooks, "rq", cfg.dist_mode)
    if not cfg.runtime_label and "codes" in batch:
        codes = batch["codes"]
    codes = codes.detach()

    # 3) NCI forward
    _, dec_in = make_labels(codes, kary, dims.max_output_length)
    labels = compact_labels(codes, dims)
    compact, _, _, _ = nci(batch["query_ids"], batch["query_mask"], dec_in)
    nci_logits = compact[:, :M, :kary]

    metrics = {}
    # 4) CE on labels, or distillation against the codebook logits
    if cfg.pq_loss == "label":
        nci_loss = L.nci_ce_loss(gather(compact), gather(labels))
    else:
        nci_loss = L.pq_distill_loss(gather(nci_logits), gather(pq_logits),
                                     cfg.pq_loss, cfg.pq_softmax_tau,
                                     cfg.pq_negative)
    metrics["nci_loss"] = nci_loss

    # 5) twin co-loss with in-cluster negatives (positive at slot 0)
    co_loss = 0.0
    if not cfg.no_twin_loss and "neg_doc_ids" in batch:
        b, n_neg, Ld = batch["neg_doc_ids"].shape
        n_reps = model.tower_rep(batch["neg_doc_ids"].reshape(-1, Ld),
                                 batch["neg_doc_mask"].reshape(-1, Ld))
        groups = torch.cat([p_reps[:, None, :],
                            n_reps.reshape(b, n_neg, -1)], 1)
        q_reps = model.tower_rep(batch["query_ids"], batch["query_mask"])
        co_loss = tt.grouped_contrastive_loss(gather(q_reps), gather(groups))
        metrics["co_loss"] = co_loss

    # 6) codebook reconstruction
    centroid_loss = 0.0
    if cfg.centroid_update_loss == "reconstruct":
        with torch.autocast(dev.type, enabled=False):
            centroid_loss = L.rq_reconstruction_loss(
                gather(p_reps.detach().float()), gather(codes),
                model.codebooks)
        metrics["centroid_update_loss"] = centroid_loss

    loss = (0.0 if cfg.no_nci_loss else nci_loss) + co_loss \
        + cfg.centroid_loss_scale * centroid_loss
    metrics["loss"] = loss
    return loss, metrics


def _joint_forward(model, cfg, batch, rng, gather):
    dev = model_device(model)
    model.nci.train(rng is not None)
    model.tower.eval()
    with compute_autocast(dev, model.nci.dims.t5.dtype):
        return joint_loss_fn(model, to_device(batch, dev), cfg, gather)


def make_joint_train_step(model: JointModel, cfg: JointStepConfig,
                          mesh: Optional[Mesh] = None):
    """``step(state, batch, rng=None) -> (state, metrics)``; ``rng``: a
    ``torch.Generator`` for the NCI's dropout, or None.  With ``mesh``,
    ``batch`` is this rank's data slice and the step is the global
    batch's (``trainer``'s data parallelism)."""
    gather = batch_gather(mesh)
    salt = mesh.index(DATA_AXIS) if mesh is not None else 0

    def step(state: TrainState, batch, rng=None):
        with dropout_rng(rng, model_device(model), salt):
            loss, metrics = _joint_forward(model, cfg, batch, rng, gather)
            state = apply_gradients(state, rank_share(loss, mesh), mesh)
        return state, detach_metrics(metrics)

    return step


def make_joint_train_step_ema(model: JointModel, cfg: JointStepConfig,
                              decay: float = 0.99,
                              mesh: Optional[Mesh] = None):
    """Variant with EMA codebook updates (``--pq_update_method ema``,
    ``pq.py:371-433``): gradients never move the codebooks (label them
    'frozen'); after each update the positives are re-embedded by the
    new tower, assigned, and the cluster statistics EMA-averaged with
    dead-code restart.  ``step(state, ema_state, batch, rng=None) ->
    (state, ema_state, metrics)``; the restart rows are drawn from a
    device generator seeded from ``rng`` (seed 0 without one).  With
    ``mesh``, the statistics and the restart draw are the global
    batch's: the re-embedded positives are gathered over the data axis,
    and ``rng`` must be seeded alike on every rank."""
    dev = model_device(model)
    gather = batch_gather(mesh)
    salt = mesh.index(DATA_AXIS) if mesh is not None else 0

    def step(state: TrainState, ema_state: rq_ops.EMAState, batch, rng=None):
        b = to_device(batch, dev)
        with dropout_rng(rng, dev, salt):
            loss, metrics = _joint_forward(model, cfg, b, rng, gather)
            state = apply_gradients(state, rank_share(loss, mesh), mesh)
        seed = 0 if rng is None else int(
            torch.randint(0, 2 ** 62, (), generator=rng))
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            with compute_autocast(dev, model.nci.dims.t5.dtype):
                p_reps = model.tower_rep(b["pos_doc_ids"],
                                         b["pos_doc_mask"]).float()
            p_reps = gather(p_reps)
            codes = rq_ops.assign(p_reps, model.codebooks, "rq",
                                  cfg.dist_mode)
            ema_state, new_cbs = rq_ops.ema_update(
                ema_state, model.codebooks, p_reps, codes, gen, decay=decay)
            model.codebooks.copy_(new_cbs)
        return state, ema_state, detach_metrics(metrics)

    return step
