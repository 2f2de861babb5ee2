"""PyTorch/CUDA port of ``mevi_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module
layout (``mevi_tpu/X.py`` -> ``mevi_tpu_torch/X.py``) and never imports
it, nor JAX.  Every public entry point takes an explicit ``device``,
defaulting to ``"cuda"``; without a card it raises unless the caller
passes ``device="cpu"`` (what the CPU tests do).  Importing the package
imports no torch: the host-only parts (``data``, the CLI's host
commands) start without it.
"""

from __future__ import annotations

import functools


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    (the default) and no card is present."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mevi_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU")
    return dev


def frozen_eval(module: torch.nn.Module) -> torch.nn.Module:
    """The serving default of a model as it is built: ``eval()`` mode
    (no dropout) and no gradients.  Training code turns both on
    (``train()``, ``requires_grad_(True)``)."""
    module.requires_grad_(False)
    return module.eval()


def as_device_tensor(x, device) -> torch.Tensor:
    """A tensor or array on ``device`` (no copy when it is there already;
    a read-only array, such as a memmap, is copied on the host first)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x).to(device)


@functools.lru_cache(maxsize=None)
def device_constant(fn, *args, device) -> torch.Tensor:
    """``fn(*args)``, a tensor built on the host, copied to ``device`` once
    per (``fn``, ``args``, ``device``) and kept there.  An op on it keeps
    its operands and bits (a host scalar in its place would not: CUDA
    divides by one by multiplying by its reciprocal) and copies nothing
    from the host, which a CUDA graph cannot capture.  Built outside
    inference mode, so that autograd may read it."""
    import torch
    with torch.inference_mode(False):
        return fn(*args).to(device)


def synchronize(device: torch.device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
