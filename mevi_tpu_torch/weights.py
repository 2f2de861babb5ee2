"""Weights: the flax -> torch bridge and seeded random init.

``flax_to_state_dict`` maps the JAX package's params, flattened to a
dict keyed by the flax path joined with ``/`` (for example
``encoder/block_0/self_attn/q/kernel``), onto the port's ``state_dict``
names (``encoder.blocks.0.self_attn.q.weight``):

* Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in),
* PAWA ``in_proj_kernel`` (dm, 3dm) -> packed ``in_proj_weight`` (3dm, dm),
* ``Embed.embedding``, ``LayerNorm.scale`` -> ``weight``; RMSNorm
  ``weight``, biases and raw params (``adaptor_kernel`` (d, d*V),
  ``memory_embedding``, ``untied_head``) carry over as they are.

The caller flattens (``flax.traverse_util.flatten_dict(params, sep="/")``),
so the port itself never sees JAX.  ``state_dict_to_flax`` is the exact
inverse: it reads each parameter's owner module to tell a Linear
``kernel`` from an Embedding ``embedding``, a LayerNorm ``scale`` and an
RMSNorm ``weight``; ``flax_names`` gives the flax path of each parameter
(the optimizer's labels and decay mask are rules on those paths).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(block|layer)_(\d+)$")
_INDEXED_PATH = re.compile(r"\b(block|layer)s\.(\d+)\b")


def _module_name(part: str) -> str:
    m = _INDEXED.match(part)
    return f"{m[1]}s.{m[2]}" if m else part


def flax_to_state_dict(flat: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        arr = np.asarray(arr)
        if arr.dtype.kind not in "fiub":       # ml_dtypes bfloat16 & co
            arr = arr.astype(np.float32)
        t = torch.tensor(arr)
        leaf = parts[-1]
        if leaf == "kernel":
            leaf, t = "weight", t.T
        elif leaf == "in_proj_kernel":
            leaf, t = "in_proj_weight", t.T
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        name = ".".join([_module_name(p) for p in parts[:-1]] + [leaf])
        out[name] = t.contiguous()
    return out


def _flax_leaf(owner: nn.Module, leaf: str) -> str:
    if leaf == "weight":
        for cls, name in ((nn.Linear, "kernel"), (nn.Embedding, "embedding"),
                          (nn.LayerNorm, "scale")):
            if isinstance(owner, cls):
                return name
    if leaf == "in_proj_weight":
        return "in_proj_kernel"
    return leaf


def flax_names(module: nn.Module) -> Dict[str, str]:
    """Each parameter's name -> its flattened flax path
    (``encoder.blocks.0.self_attn.q.weight`` ->
    ``encoder/block_0/self_attn/q/kernel``)."""
    owners = dict(module.named_modules())
    out = {}
    for name, _ in module.named_parameters():
        mod_path, _, leaf = name.rpartition(".")
        path = _INDEXED_PATH.sub(r"\1_\2", mod_path)
        out[name] = "/".join(filter(None, path.split(".")
                                    + [_flax_leaf(owners[mod_path], leaf)]))
    return out


def state_dict_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s parameters as flattened flax params (numpy, bf16 as
    float32): the inverse of :func:`flax_to_state_dict`."""
    params = dict(module.named_parameters())
    out = {}
    for name, path in flax_names(module).items():
        t = params[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if path.rsplit("/", 1)[-1] in ("kernel", "in_proj_kernel"):
            t = t.T
        out[path] = t.contiguous().numpy().copy()
    return out


def load_flax_params(module: nn.Module, flat: Dict[str, np.ndarray]):
    """Copy flattened flax params into ``module`` (strict: every
    parameter on both sides must match by name and shape)."""
    module.load_state_dict(flax_to_state_dict(flat), strict=True)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, seed: int):
    """Seeded random init with the scales of the flax initializers the
    JAX package uses: lecun-normal Dense kernels and adaptor kernel,
    1/sqrt(d) embeddings, xavier-uniform PAWA in-projection,
    uniform[0, 1) memory vector, ones/zeros for norms and biases."""
    gens = {}
    for name, p in module.named_parameters():
        g = gens.get(p.device)
        if g is None:
            g = gens[p.device] = torch.Generator(device=p.device)
            g.manual_seed(seed)
        leaf = name.rsplit(".", 1)[-1]
        owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
        if leaf.endswith("bias"):          # incl. PAWA's in_proj_bias
            p.zero_()
        elif "norm" in owner:
            p.fill_(1.0)
        elif leaf == "in_proj_weight":
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=g)
        elif leaf == "memory_embedding":
            p.uniform_(0.0, 1.0, generator=g)
        elif leaf == "adaptor_kernel":
            p.normal_(0.0, p.shape[0] ** -0.5, generator=g)
        elif p.ndim == 2:   # Linear (out, in) and Embedding (n, d)
            p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
        else:
            raise ValueError(f"no init rule for parameter {name}")
    return module
