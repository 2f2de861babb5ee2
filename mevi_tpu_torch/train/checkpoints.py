"""Checkpoints and the artifact cache (port of
``mevi_tpu.train.checkpoints``).

* ``ArtifactCache``: numpy artifacts under ``<root>/<key>/<name>``,
  where ``key`` comes from ``MEVIConfig.artifact_key``: regenerate
  lazily, never recompute what an earlier run already produced (the
  reference's ``get_current_path`` cache, ``main_models.py:2944-2978``).
  The layout and keys are the JAX package's, so either package finds the
  other's artifacts.
* ``CheckpointManager``: metric-ranked top-k retention with the JAX
  package's ``leaderboard.json`` / ``leaderboard.meta.json``; each tag is
  a directory holding one ``torch.save`` of the state (model and
  optimizer state dicts, step, epoch) where the JAX package writes orbax.
* ``save_params_npz`` / ``load_params_npz``: the JAX package's flat npz
  of '/'-joined flax paths, through the port's weight bridge, so either
  package reads the other's file.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..weights import state_dict_to_flax

_STATE_FILE = "state.pt"


class ArtifactCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, key: str, name: str) -> str:
        d = osp.join(self.root, key)
        os.makedirs(d, exist_ok=True)
        return osp.join(d, name)

    def has(self, key: str, name: str) -> bool:
        return osp.exists(self.path(key, name))

    def save_array(self, key: str, name: str, arr) -> str:
        p = self.path(key, name)
        np.save(p + ".tmp.npy", np.asarray(arr))
        os.replace(p + ".tmp.npy", p)
        return p

    def load_array(self, key: str, name: str) -> np.ndarray:
        return np.load(self.path(key, name))

    def save_json(self, key: str, name: str, obj) -> str:
        p = self.path(key, name)
        with open(p, "w") as fw:
            json.dump(obj, fw)
        return p

    def load_json(self, key: str, name: str):
        with open(self.path(key, name)) as fr:
            return json.load(fr)


class CheckpointManager:
    """Torch checkpoints with metric-ranked retention (save_top_k
    semantics, ``main.py:96-127``)."""

    def __init__(self, directory: str, keep: int = 2,
                 monitor: str = "recall100", mode: str = "max"):
        self.directory = osp.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.monitor = monitor
        self.mode = mode
        self._board_path = osp.join(self.directory, "leaderboard.json")
        self._board: Dict[str, float] = {}
        if osp.exists(self._board_path):
            with open(self._board_path) as fr:
                self._board = json.load(fr)
        # a board written under another monitor/mode holds incomparable
        # values (a loss of 2.3 would outrank every hit@10 <= 1 under
        # mode=max, and keep-k pruning would evict the new best): demote
        # its entries to the worst rank; the tags stay restorable until
        # new entries evict them
        meta_p = osp.join(self.directory, "leaderboard.meta.json")
        if self._board and osp.exists(meta_p):
            try:
                with open(meta_p) as fr:
                    meta = json.load(fr)
            except (OSError, ValueError):
                meta = {}
            if (meta.get("monitor", monitor), meta.get("mode", mode)) \
                    != (monitor, mode):
                with open(osp.join(self.directory,
                                   "leaderboard.prev.json"), "w") as fw:
                    json.dump({"meta": meta, "board": self._board}, fw,
                              indent=1)
                demoted = float("-inf") if mode == "max" else float("inf")
                self._board = {t: demoted for t in self._board}
                self._flush_board()

    def _flush_board(self):
        with open(self._board_path, "w") as fw:
            json.dump(self._board, fw, indent=1)
        # what the floats mean, for a reader that opens the directory
        # later and must rank with the writer's monitor/mode
        with open(osp.join(self.directory, "leaderboard.meta.json"),
                  "w") as fw:
            json.dump({"monitor": self.monitor, "mode": self.mode}, fw)

    @classmethod
    def from_dir(cls, directory: str, keep: int = 2,
                 default_monitor: str = "loss",
                 default_mode: str = "min") -> "CheckpointManager":
        """Open an existing checkpoint directory ranking by the monitor
        its writer recorded (the defaults for boards without meta)."""
        meta_p = osp.join(osp.abspath(directory), "leaderboard.meta.json")
        monitor, mode = default_monitor, default_mode
        if osp.exists(meta_p):
            try:
                with open(meta_p) as fr:
                    meta = json.load(fr)
                monitor = meta.get("monitor", monitor)
                mode = meta.get("mode", mode)
            except (OSError, ValueError):
                pass
        return cls(directory, keep=keep, monitor=monitor, mode=mode)

    def _rank_key(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def save(self, tag: str, state: Any, metric: Optional[float] = None,
             force: bool = False) -> Optional[str]:
        """Save ``state`` (anything ``torch.save`` takes) when it is
        within the top k by the monitored metric."""
        if metric is not None and not force and len(self._board) >= self.keep:
            worst = min(self._rank_key(v) for v in self._board.values())
            if self._rank_key(metric) <= worst:
                return None
        path = osp.join(self.directory, tag)
        if osp.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(state, osp.join(path, _STATE_FILE + ".tmp"))
        os.replace(osp.join(path, _STATE_FILE + ".tmp"),
                   osp.join(path, _STATE_FILE))
        self._board[tag] = float(metric) if metric is not None else 0.0
        if metric is not None and len(self._board) > self.keep:
            order = sorted(self._board,
                           key=lambda t: self._rank_key(self._board[t]))
            for tag_out in order[:len(self._board) - self.keep]:
                victim = osp.join(self.directory, tag_out)
                if osp.exists(victim):
                    shutil.rmtree(victim)
                del self._board[tag_out]
        self._flush_board()
        return path

    def best_tag(self) -> Optional[str]:
        if not self._board:
            return None
        return max(self._board,
                   key=lambda t: self._rank_key(self._board[t]))

    def restore(self, tag: str) -> Any:
        """The state saved under ``tag``, on the host."""
        return restore_tree_host(osp.join(self.directory, tag))


def restore_tree_host(path: str) -> Any:
    """Load a checkpoint of this package (a tag directory or its state
    file) onto the host, whatever device it was saved from."""
    if osp.isdir(path):
        path = osp.join(path, _STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params_npz(path: str, module: nn.Module) -> None:
    """Flat npz of ``module``'s parameters under their '/'-joined flax
    paths (the JAX package's ``save_params_npz`` format)."""
    np.savez(path, **state_dict_to_flax(module))


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """A ``save_params_npz`` file of either package as flattened flax
    params (``weights.load_flax_params`` loads them into a module)."""
    with np.load(path) as z:
        return {key: z[key] for key in z.files}
