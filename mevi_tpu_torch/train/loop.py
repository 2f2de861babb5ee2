"""Training orchestration: epochs, alternating stages, validation-driven
artifact regeneration (port of ``mevi_tpu.train.loop``).

Rebuilds the reference's training choreography
(``T5FineTunerWithValidation``):

* **alt-stage switching** (``on_train_epoch_start``,
  ``main_models.py:2838-2867``): epochs alternate between NCI-training
  and twin/VQ-training phases by swapping which step runs,
* **validation-driven regeneration** (``on_validation_epoch_start``,
  ``main_models.py:4215-4273``): when the document tower trains, every
  validation re-embeds the corpus with the live tower, refits the RQ
  codebooks (Hungarian-aligned to the previous fit so code labels stay
  stable, ``pq.py:600-611``), re-assigns with the aligned books,
  rebuilds the fine index and re-evaluates,
* **checkpointing on recall** with top-k retention (``main.py:89-170``).

The state is the port's ``TrainState`` (a module, its ``GroupedAdamW``
and the step count): a joint run's module is a ``JointModel``
(``nci`` / ``tower`` / ``codebooks``), an NCI run's the ``NCIT5``.
Checkpoints are the module's and optimizer's state dicts, the step and
the epoch, through the port's ``CheckpointManager``.  The JAX package's
``PRNGKey`` split per step is one ``torch.Generator`` per loop, handed to
every step.  The RQ refit draws from a torch generator seeded from
``LoopConfig.seed``, so its codebooks are not the JAX package's (they
are held to ``assign`` under the aligned books, not to JAX's fit).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import as_device_tensor, resolve_device, synchronize
from ..config import MEVIConfig
from ..eval.run_eval import Evaluator
from ..eval.searcher import build_fine_index
from ..index.build import build_rq_index, embed_corpus
from ..ops import rq as rq_ops
from ..utils.logging import MetricsLogger
from .checkpoints import CheckpointManager
from .trainer import TrainState, compute_autocast


@dataclasses.dataclass
class LoopConfig:
    num_epochs: int = 10
    val_every: int = 1                 # epochs between validations
    refit_rq: bool = False             # re-cluster when the tower trains
    rq_iters: int = 10
    align_codebooks: bool = True       # Hungarian label stability
    alt_epochs: Optional[tuple] = None  # (nci_epochs, cycle) alt schedule
    monitor: str = "recall100"
    seed: int = 42


class TrainLoop:
    """Drives (train step(s), datasets, evaluator, artifact jobs).

    ``steps``: {'nci': step, 'twin': step (optional)}, each
    ``(state, batch, generator) -> (state, metrics)``.
    ``dataset_fn(epoch)`` -> iterator of batches for the active stage.
    ``tower_rep(ids, mask)`` -> (b, d) document embeddings from the live
    tower, called with tensors on ``device``.
    ``eval_inputs``: {queries, query_ids, query_mask, gt_docids}.
    """

    def __init__(self, cfg: MEVIConfig, loop: LoopConfig, nci_model,
                 steps: Dict[str, Callable], state: Optional[TrainState],
                 dataset_fn: Optional[Callable[[int], Any]],
                 tower_rep: Optional[Callable] = None,
                 doc_tokens: Optional[np.ndarray] = None,
                 doc_masks: Optional[np.ndarray] = None,
                 eval_inputs: Optional[dict] = None,
                 ckpt_dir: str = "ckpts", log_dir: str = "logs",
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loop = loop
        self.nci_model = nci_model
        self.steps = steps
        self.state = state
        self.dataset_fn = dataset_fn
        self.tower_rep = tower_rep
        self.doc_tokens = doc_tokens
        self.doc_masks = doc_masks
        self.eval_inputs = eval_inputs
        self.ckpts = CheckpointManager(ckpt_dir, keep=2,
                                       monitor=loop.monitor, mode="max")
        self.logger = MetricsLogger(log_dir, "trainloop")
        self.codebooks: Optional[np.ndarray] = None
        self.doc_codes: Optional[np.ndarray] = None
        self.fine_index = None
        self.start_epoch = 0
        # the last refit's seconds by part and its label stability
        self.refit_stats: Dict[str, float] = {}
        self.last_validation: Dict[str, float] = {}
        self._gen = torch.Generator().manual_seed(loop.seed)

    # -- resume (reference: --resume_from_checkpoint, main.py:128,158) ----

    def save_state(self, tag: str, metric: Optional[float] = None,
                   force: bool = False):
        """Full-state checkpoint (module + optimizer + step + epoch)."""
        payload = {"model": self.state.model.state_dict(),
                   "optimizer": self.state.optimizer.state_dict(),
                   "step": self.state.step, "epoch": self.start_epoch}
        return self.ckpts.save(tag, payload, metric=metric, force=force)

    def resume(self, tag: Optional[str] = None) -> bool:
        """Restore the full train state from ``tag`` (or the best saved
        checkpoint); True when something was restored."""
        tag = tag or self.ckpts.best_tag()
        if tag is None:
            return False
        restored = self.ckpts.restore(tag)
        self.state.model.load_state_dict(restored["model"])
        self.state.optimizer.load_state_dict(restored["optimizer"])
        self.state.step = int(restored["step"])
        self.start_epoch = int(restored["epoch"]) + 1
        return True

    # -- stage scheduling (alt NCI / twin) --------------------------------

    def stage_for_epoch(self, epoch: int) -> str:
        if self.loop.alt_epochs is None or "twin" not in self.steps:
            return "nci"
        nci_part, cycle = self.loop.alt_epochs
        return "nci" if (epoch % cycle) < nci_part else "twin"

    # -- artifact regeneration --------------------------------------------

    def _tick(self, name: str, t0: float) -> float:
        synchronize(self.device)
        t1 = time.perf_counter()
        self.refit_stats[name] = t1 - t0
        return t1

    def regenerate_index(self, tower_rep: Optional[Callable] = None
                         ) -> None:
        """Re-embed the corpus with the live tower, refit RQ, align the
        books to the previous fit and re-assign with them, rebuild the
        fine index (validation-start semantics)."""
        rep = tower_rep or self.tower_rep
        assert rep is not None
        cfg, dev = self.cfg, self.device
        self.refit_stats = {}
        t = time.perf_counter()
        emb = embed_corpus(rep, self.doc_tokens, self.doc_masks,
                           batch_size=cfg.train.encode_batch_size,
                           device=dev)
        t = self._tick("embed_s", t)
        old, prev_codes = self.codebooks, self.doc_codes
        arts = build_rq_index(cfg, emb, seed=self.loop.seed,
                              iters=self.loop.rq_iters, device=dev)
        t = self._tick("refit_s", t)
        codebooks, codes = np.asarray(arts.codebooks), np.asarray(arts.codes)
        if old is not None and self.loop.align_codebooks:
            codebooks = rq_ops.align_codebooks(old, codebooks,
                                               cfg.rq.dist_mode)
            # re-assign with the aligned books so labels stay stable
            codes = rq_ops.assign(
                as_device_tensor(emb, dev),
                as_device_tensor(codebooks, dev).float(), cfg.rq.pq_type,
                cfg.rq.dist_mode).cpu().numpy()
            t = self._tick("align_s", t)
        if prev_codes is not None and prev_codes.shape == codes.shape:
            # shares of docs whose whole code, and whose code at each
            # level, the refit kept (with and without the alignment)
            for tag, c in (("aligned", codes),
                           ("unaligned", np.asarray(arts.codes))):
                same = c == prev_codes
                self.refit_stats[f"unchanged_{tag}"] = float(
                    same.all(1).mean())
                self.refit_stats[f"unchanged_{tag}_by_level"] = [
                    float(x) for x in same.mean(0)]
        self.codebooks = codebooks
        self.doc_codes = codes
        self.fine_index = build_fine_index(codes, emb, cfg.rq.kary,
                                           device=dev)
        self._tick("csr_s", t)

    # -- validation --------------------------------------------------------

    def validate(self, query_rep_fn=None) -> Dict[str, float]:
        """Coarse + fine metrics of the live NCI through ``Evaluator``
        (in its compute dtype, dropout off); {} without an eval set."""
        if self.eval_inputs is None or self.fine_index is None:
            return {}
        nci = self.nci_model
        nci.eval()
        ev = Evaluator(nci, self.cfg.infer, fine_index=self.fine_index,
                       query_rep_fn=query_rep_fn, doc_codes=self.doc_codes,
                       device=self.device)
        with compute_autocast(self.device, nci.dims.t5.dtype):
            out = ev.evaluate(self.eval_inputs["queries"],
                              self.eval_inputs["query_ids"],
                              self.eval_inputs["query_mask"],
                              self.eval_inputs["gt_docids"],
                              batch_size=self.cfg.train.eval_batch_size)
        flat = {}
        if out.coarse:
            for k, v in out.coarse["recall"].items():
                flat[f"coarse_recall{k}"] = v
        if out.fine:
            for k, v in out.fine["recall"].items():
                flat[f"recall{k}"] = v
            for k, v in out.fine["mrr"].items():
                flat[f"mrr{k}"] = v
        flat["ndoc"] = out.ndoc_per_query
        return flat

    # -- main loop ----------------------------------------------------------

    def run(self, query_rep_fn=None) -> TrainState:
        for epoch in range(self.start_epoch, self.loop.num_epochs):
            self.start_epoch = epoch
            stage = self.stage_for_epoch(epoch)
            step = self.steps[stage]
            metrics = {}
            for batch in self.dataset_fn(epoch):
                self.state, metrics = step(self.state, batch, self._gen)
            self.logger.log({f"train_{k}": float(v)
                             for k, v in metrics.items()}
                            | {"epoch": epoch, "stage": stage},
                            self.state.step)

            if (epoch + 1) % self.loop.val_every == 0:
                if self.loop.refit_rq and self.tower_rep is not None:
                    self.regenerate_index()
                val = self.validate(query_rep_fn)
                if val:
                    self.logger.log(val, self.state.step)
                    metric = val.get(self.loop.monitor,
                                     val.get("recall100", 0.0))
                else:
                    # no eval set: rank checkpoints by the training loss
                    metric = -float(metrics.get("loss", 0.0))
                self.last_validation = val
                self.save_state(f"epoch{epoch}", metric=metric)
        return self.state
