"""Training harness (port of ``mevi_tpu.train.trainer``): AdamW in label
groups, the NCI and twin-tower train steps.

Reference: ``configure_optimizers`` (``main_models.py:3373-3486``) builds
AdamW with per-part learning rates (encoder + shared at
``learning_rate``, everything decode-side at ``decoder_learning_rate``,
the twin tower at ``docenc_learning_rate`` with no weight decay), no
decay on biases and norms, and a linear warmup + decay schedule.  The
JAX package writes it as ``optax.multi_transform`` over parameter
labels; :class:`GroupedAdamW` computes the same updates:

* one ``clip_by_global_norm`` per label, inside that label's chain: each
  group is clipped by its own norm, not by the norm over every
  parameter;
* ``torch.optim.AdamW`` per (label, decay) group, the schedule evaluated
  at the update count before its increment (so with warmup the first
  update has learning rate 0), decoupled decay ``lr * wd * p``;
* labels and the decay mask are rules on the flattened flax paths of the
  parameters (``weights.flax_names``), so they are the JAX package's
  exactly: the PAWA ``in_proj_bias``, ``memory_embedding`` and
  ``adaptor_kernel`` are decayed;
* 'frozen' parameters are not stepped (``optax.set_to_zero``);
* ``gradient_accumulation`` k is ``optax.MultiSteps``: the running mean
  of k micro-gradients feeds one update; ``TrainState.step`` still moves
  every micro-batch.

A step takes an optional ``torch.Generator`` in place of the JAX rng:
without one the forward is deterministic (``eval()`` mode); with one,
dropout runs in ``train()`` mode on the device's default generator
seeded from it for the span of the step (what ``torch.utils.checkpoint``
saves and replays), and the caller's global RNG state is restored after.
``make_nci_train_chunk`` (K steps in one ``lax.scan`` program, which
exists to amortize a TPU's per-dispatch floor) is not ported: steps taken
one by one compute the same thing.

Data parallelism: a step made with a ``mesh`` (``parallel.mesh.Mesh``)
takes the rank's data slice of the batch and computes **the step on the
global batch**, as jit over a batch-sharded mesh does.  The per-row
tensors each loss reads are all-gathered over the data group (a gather
whose backward sums each rank's block over the ranks), every rank
computes the loss of the gathered batch and backpropagates ``1/data`` of
it, then the gradients are summed over the data group in flattened
buckets (``all_reduce_sum_``) before ``GroupedAdamW``, so the per-label
clip sees global gradients.  (DDP's ``module.`` prefix would break the
optimizer's path labels.)  Dropout on each rank is seeded from the
step's generator plus the rank's data index.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import as_device_tensor
from ..config import TrainConfig
from ..models.nci import NCIT5, compact_labels, make_labels
from ..parallel.mesh import DATA_AXIS, Mesh, all_reduce_sum_, gather_rows
from ..weights import flax_names
from . import losses as L


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: "GroupedAdamW"
    step: int = 0


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def nci_param_labels(paths: Iterable[str]) -> Dict[str, str]:
    """'encoder' vs 'decoder' LR groups by flax path: shared + encoder at
    the encoder LR, everything else decode-side."""
    return {p: "encoder" if p.split("/")[0] in ("shared", "encoder")
            else "decoder" for p in paths}


def no_decay_mask(paths: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies: not a leaf named ``bias``, and
    not ``weight``/``scale``/``bias`` under a path containing 'norm'."""
    def decays(path):
        p = path.lower()
        leaf = p.split("/")[-1]
        return not (("norm" in p and leaf in ("weight", "scale", "bias"))
                    or leaf == "bias")
    return {p: decays(p) for p in paths}


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int):
    """HF ``get_linear_schedule_with_warmup``, in float32 as the JAX
    package evaluates it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        up = s / f32(max(warmup_steps, 1))
        down = f32(max(f32(total_steps) - s, f32(0))) \
            / f32(max(total_steps - warmup_steps, 1))
        return float(f32(lr) * (up if s < warmup_steps else down))
    return schedule


class GroupedAdamW:
    """AdamW in label groups with a per-label global-norm clip and
    optional gradient accumulation (see the module docstring).

    ``named``: flax path -> parameter; ``labels``: flax path -> label;
    ``lrs`` / ``weight_decay``: per label ('frozen' is never stepped).
    :meth:`step` is called after every micro-batch's backward and
    returns whether it applied an update."""

    def __init__(self, named: Dict[str, nn.Parameter], labels: Dict[str, str],
                 lrs: Dict[str, float], weight_decay: Dict[str, float],
                 warmup_steps: int, total_steps: int, max_grad_norm: float,
                 eps: float = 1e-8, accumulate: int = 1):
        self.max_grad_norm = max_grad_norm
        self.accumulate = accumulate
        self.schedules = {lab: linear_warmup_decay(lr, warmup_steps,
                                                   total_steps)
                          for lab, lr in lrs.items()}
        decay = no_decay_mask(named)
        paths = [p for p in named if labels[p] != "frozen"]
        self.by_label: Dict[str, list] = {}
        groups = {}
        for p in paths:
            lab = labels[p]
            self.by_label.setdefault(lab, []).append(named[p])
            groups.setdefault((lab, decay[p]), []).append(named[p])
        self.params = [named[p] for p in paths]
        self.inner = torch.optim.AdamW(
            [{"params": ps, "label": lab,
              "weight_decay": weight_decay[lab] if dec else 0.0}
             for (lab, dec), ps in groups.items()],
            lr=0.0, betas=(0.9, 0.999), eps=eps)
        self.count = 0          # updates applied (the schedule's count)
        self.mini_step = 0
        self.acc: Optional[list] = None

    def _grads(self):
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._grads()
        if self.accumulate > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulate
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        for p, g in zip(self.params, grads):
            p.grad = g
        for ps in self.by_label.values():
            g_norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([p.grad for p in ps])))
            # optax: g if norm < max else g / norm * max (no host sync)
            scale = torch.where(g_norm < self.max_grad_norm,
                                torch.ones_like(g_norm),
                                self.max_grad_norm / g_norm)
            for p in ps:
                p.grad.mul_(scale)
        for group in self.inner.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.inner.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict):
        self.inner.load_state_dict(sd["adamw"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self.acc = None if sd["acc"] is None else [
            a.to(p.device) for a, p in zip(sd["acc"], self.params)]


def make_optimizer(cfg: TrainConfig, model: nn.Module, total_steps: int,
                   labels: Optional[Dict[str, str]] = None) -> GroupedAdamW:
    """AdamW groups with per-label LRs and global-norm clip over
    ``model``'s parameters; ``labels`` (flax path -> label) defaults to
    :func:`nci_param_labels`."""
    names = flax_names(model)
    params = dict(model.named_parameters())
    named = {path: params[n] for n, path in names.items()}
    if labels is None:
        labels = nci_param_labels(named)
    lrs = {"encoder": cfg.learning_rate,
           "decoder": cfg.decoder_learning_rate,
           "docenc": cfg.docenc_learning_rate}
    wd = {"encoder": cfg.weight_decay, "decoder": cfg.weight_decay,
          "docenc": 0.0}
    return GroupedAdamW(named, labels, lrs, wd, cfg.warmup_steps,
                        total_steps, cfg.max_grad_norm, cfg.adam_epsilon,
                        max(int(cfg.gradient_accumulation), 1))


def init_state(model: nn.Module, optimizer: GroupedAdamW) -> TrainState:
    """The model's parameters take gradients from here on."""
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    return TrainState(model, optimizer, 0)


# --------------------------------------------------------------------------
# step plumbing
# --------------------------------------------------------------------------

def compute_autocast(device: torch.device, dtype: torch.dtype):
    """The compute dtype over float32 parameters: ``torch.autocast`` in
    ``dtype`` (off for float32)."""
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


@contextlib.contextmanager
def dropout_rng(generator: Optional[torch.Generator], device: torch.device,
                salt: int = 0):
    """Dropout's draws seeded from ``generator`` (plus ``salt``, a data
    rank's index) for the span of the block, on the device's default
    generator (the one ``torch.utils.checkpoint`` saves and replays);
    the global RNG state is restored on exit.  Without a generator,
    nothing changes."""
    if generator is None:
        yield
        return
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator)) + salt
    cuda = []
    if device.type == "cuda":
        cuda = [device.index if device.index is not None
                else torch.cuda.current_device()]
    with torch.random.fork_rng(devices=cuda):
        (torch.cuda.default_generators[cuda[0]] if cuda
         else torch.default_generator).manual_seed(seed)
        yield


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: as_device_tensor(v, device) for k, v in batch.items()}


def data_parallel(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.data > 1


def batch_gather(mesh: Optional[Mesh]):
    """The gather of a loss's per-row inputs over the data axis: the
    identity on one data rank; float tensors go as float32 (every loss
    computes in float32)."""
    if not data_parallel(mesh):
        return lambda x: x
    return lambda x: gather_rows(x.float() if x.is_floating_point() else x,
                                 mesh, DATA_AXIS)


def rank_share(loss: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """What one data rank backpropagates of a loss every rank computes
    over the gathered batch."""
    return loss / mesh.data if data_parallel(mesh) else loss


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> TrainState:
    """Backward, the gradients summed over the data group (with a mesh),
    one optimizer (micro-)step, then every gradient of the model dropped
    (frozen parameters' too: the optimizer keeps its own accumulation).
    ``loss``: this rank's share (:func:`rank_share`)."""
    loss.backward()
    if data_parallel(mesh):
        all_reduce_sum_([p.grad for p in state.optimizer.params
                         if p.grad is not None], mesh, DATA_AXIS)
    state.optimizer.step()
    state.model.zero_grad(set_to_none=True)
    state.step += 1
    return state


def detach_metrics(metrics: Dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


# --------------------------------------------------------------------------
# NCI training step (headline config: CE on code labels, optional R-drop)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NCIStepConfig:
    rdrop: float = 0.0
    rdrop_loss: str = "Contrast"


def nci_loss_fn(model: NCIT5, batch: Dict[str, torch.Tensor],
                step_cfg: NCIStepConfig, gather=lambda x: x
                ) -> Tuple[torch.Tensor, Dict]:
    """batch: query_ids (b, Lq), query_mask, codes (b, M), on the
    model's device.  Dropout follows the model's ``train()`` mode.
    ``gather``: applied to each per-row tensor the losses read
    (:func:`batch_gather`; the identity on one rank)."""
    dims = model.dims
    codes = batch["codes"]
    _, dec_in = make_labels(codes, dims.kary, dims.max_output_length)
    labels = compact_labels(codes, dims)
    input_ids, mask = batch["query_ids"], batch["query_mask"]
    if step_cfg.rdrop > 0:
        # two stochastic passes of the doubled batch in one forward
        input_ids, mask, dec_in = (torch.cat([x, x], 0)
                                   for x in (input_ids, mask, dec_in))
    logits, _, dec_h, _ = model(input_ids, mask, dec_in)
    labels = gather(labels)
    if step_cfg.rdrop <= 0:
        ce = L.nci_ce_loss(gather(logits), labels)
        return ce, {"nci_loss": ce, "loss": ce}
    b = logits.shape[0] // 2
    la, lb = gather(logits[:b]), gather(logits[b:])
    ce = L.nci_ce_loss(torch.cat([la, lb]), torch.cat([labels, labels]))
    if step_cfg.rdrop_loss == "KL":
        dist = L.rdrop_kl(la, lb)
    elif step_cfg.rdrop_loss == "Contrast":
        dist = L.rdrop_contrast(gather(dec_h[:b]), gather(dec_h[b:]))
    else:
        dist = L.rdrop_l2(la, lb)
    loss = ce + step_cfg.rdrop * dist
    return loss, {"nci_loss": ce, "dist_loss": dist, "loss": loss}


def make_nci_train_step(model: NCIT5,
                        step_cfg: NCIStepConfig = NCIStepConfig(),
                        mesh: Optional[Mesh] = None):
    """``step(state, batch, rng=None) -> (state, metrics)``: one
    micro-batch through the model (in place) and the optimizer.
    ``rng``: a ``torch.Generator`` for dropout, or None (deterministic,
    as the JAX step with ``rng=None`` and no R-drop).  With ``mesh``,
    ``batch`` is this rank's data slice and the step is the global
    batch's (module docstring); metrics are the global batch's."""
    dev = model_device(model)
    dtype = model.dims.t5.dtype
    gather = batch_gather(mesh)
    salt = mesh.index(DATA_AXIS) if mesh is not None else 0

    def step(state: TrainState, batch, rng=None):
        model.train(rng is not None or step_cfg.rdrop > 0)
        with dropout_rng(rng, dev, salt):
            with compute_autocast(dev, dtype):
                loss, metrics = nci_loss_fn(model, to_device(batch, dev),
                                            step_cfg, gather)
            state = apply_gradients(state, rank_share(loss, mesh), mesh)
        return state, detach_metrics(metrics)

    return step


# --------------------------------------------------------------------------
# twin-tower training step (contrastive with sampled hard negatives)
# --------------------------------------------------------------------------

def make_twin_train_step(tower, mesh: Optional[Mesh] = None):
    """``step(state, batch) -> (state, metrics)``; batch: query_ids/mask
    (b, Lq), doc_ids/mask (b*(1+neg), Ld) grouped per query with the
    positive first (co-loss, ``document_encoder.py:61-102``).  ``tower``:
    a :class:`~mevi_tpu_torch.models.twin_tower.Tower`; deterministic, as
    the JAX step.  With ``mesh``, ``batch`` is this rank's data slice and
    the in-batch negatives are the global batch's, as under jit over a
    batch-sharded mesh: the reps are gathered over the data axis.  (The
    JAX step's ``negatives_x_device`` names that axis for a caller that
    runs the step per shard under ``shard_map``; no caller of the port
    does, so the step takes none.)"""
    from ..models import twin_tower as tt
    dev = model_device(tower.module)
    dtype = tower.module.dims.dtype
    axis = DATA_AXIS if data_parallel(mesh) else None

    def step(state: TrainState, batch):
        tower.module.eval()
        b = to_device(batch, dev)
        with compute_autocast(dev, dtype):
            q = tower.rep(b["query_ids"], b["query_mask"])
            d = tower.rep(b["doc_ids"], b["doc_mask"])
            loss, _ = tt.contrastive_loss(q, d, axis_name=axis, mesh=mesh)
        state = apply_gradients(state, rank_share(loss, mesh), mesh)
        return state, {"co_loss": loss.detach()}

    return step
