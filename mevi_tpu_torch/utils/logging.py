"""Experiment logging (port of ``mevi_tpu.utils.logging``): an
append-only metrics.jsonl, with wandb attached when it is installed and
asked for."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def run_name(tag: str, cfg) -> str:
    """Compact run name from the load-bearing config dims."""
    rq = cfg.rq
    return (f"{tag}_{cfg.dataset}_rq{rq.subvector_num}x{rq.subvector_bits}"
            f"_d{rq.emb_size}_b{cfg.train.train_batch_size}")


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "run",
                 use_wandb: bool = False, wandb_project: str = "mevi_tpu",
                 config: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project, name=name,
                                         config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        """One jsonl record; numbers (numpy or 0-d tensors included) as
        floats."""
        flat = {k: (float(v) if hasattr(v, "item") or
                    isinstance(v, (int, float)) else v)
                for k, v in metrics.items()}
        rec = {"ts": time.time(), "step": step, **flat}
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(flat, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
