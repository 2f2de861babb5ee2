"""Content-addressed artifact cache (port of
``mevi_tpu.train.checkpoints.ArtifactCache``; the parameter checkpoints
come with the training slice).

Numpy artifacts live under ``<root>/<key>/<name>``, where ``key`` comes
from ``MEVIConfig.artifact_key``: regenerate lazily, never recompute what
an earlier run already produced (the reference's ``get_current_path``
cache, ``main_models.py:2944-2978``).  The layout and keys are the JAX
package's, so either package finds the other's artifacts.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


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
