"""Finding a part of the benchmark by its name: a module loaded from its
file, and a configuration's query-tower family, the port's side in
``perfbench/towers/<family>.py`` and its plain reference in
``perfbench/reference/<family>.py``.

A family's module in ``towers/`` gives:

* ``build(c, W, dev, dtype)``: the port's model, from the configuration's
  ``tower`` keys ``c``, with the weights ``W`` loaded, as the callable
  ``(ids, mask) -> (b, d)`` the server's tower is;
* ``flops(lengths, c)``: the analytic operations over a batch with these
  real lengths (``counts.py``'s rules);
* ``TINY``: the family's ``tower`` keys at a size the CPU tests run.

Its reference gives ``tower_specs(c)``, the weight specs
(``weights.make``), and ``rep(W, c, ids, mask, P)``, the plain
representation in precision ``P``.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
TOWERS = os.path.join(HERE, "towers")
REFERENCE = os.path.join(HERE, "reference")

_loaded = {}


def load_module(path: str, name: str):
    """The module in file ``path``, executed once a path."""
    path = os.path.abspath(path)
    if path not in _loaded:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def _family(where: str, package: str, family: str):
    path = os.path.join(where, family + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"tower family {family!r}: no file {path}")
    return load_module(path, f"{package}.{family}")


def tower(family: str):
    """The port's side of the query-tower family ``family``."""
    return _family(TOWERS, "perfbench.towers", family)


def reference(family: str):
    """The plain reference of the query-tower family ``family``."""
    return _family(REFERENCE, "perfbench.reference", family)


def tower_families() -> List[str]:
    """The families that have a module in ``towers/``."""
    return sorted(f[:-3] for f in os.listdir(TOWERS)
                  if f.endswith(".py") and not f.startswith("_"))
