"""Seeded random weights, made on the device in a few large calls: one
``randn`` for every normal leaf and one ``rand`` for every uniform leaf,
in float32, scaled per leaf and rounded once to the configuration's
dtype.  The scales are those of the port's random init (lecun-normal
dense kernels and adaptor kernel, 1/sqrt(d) embeddings, xavier-uniform
PAWA in-projections, a uniform [0, 1) memory vector, ones and zeros for
norms and biases).  A spec is ``(name, shape, kind, arg)``; the names
are the port's ``state_dict`` names, the checkpoint format both sides
read."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .data import generator

TOWER_STREAM, NCI_STREAM = 2, 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def make(specs: List, seed: int, stream: int, device,
         dtype) -> Dict[str, torch.Tensor]:
    g = generator(seed, stream, device)
    sizes = {k: sum(math.prod(s[1]) for s in specs if s[2] == k)
             for k in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, arg in specs:
        n = math.prod(shape)
        if kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = pools[kind][at[kind]:at[kind] + n].reshape(shape)
            at[kind] += n
            t = t * arg if kind == "normal" else arg[0] + (arg[1] - arg[0]) * t
        out[name] = t.to(dtype)
    return out


def as_f32(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in w.items()}
