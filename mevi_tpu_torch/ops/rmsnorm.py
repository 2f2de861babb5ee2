"""Fused RMSNorm: the norm of ``models.t5.RMSNorm`` (every T5 block of
the query tower and the NCI beam, and DeepSeek-V2's stack) in one pass.

``out = (float(w) * (float(x) * rsqrt(mean(float(x)^2) + eps))).to(x.dtype)``
over the last dimension, in float32 with one rounding at the end.  The
JAX package's ``RMSNorm`` (``mevi_tpu/models/t5.py:53``) is plain jnp,
which XLA fuses; the same arithmetic as PyTorch ops launches nine kernels
a call that each move the row in float32, about 40 bytes for each bf16
element where one pass moves 4.  ``csrc/rmsnorm.cu`` is that one pass, a
kernel bound by bytes (its source note gives the design).

:func:`rmsnorm` decides by what it can see of its inputs
(:func:`use_kernel` over their :func:`layout`): the plain composition
below on any device but CUDA (the CPU, the meta device); the kernel for
every CUDA call, ``ValueError`` for a CUDA input the kernel does not
take, never a silent fallback.  While autograd records, the kernel runs
inside :class:`_KernelNorm`, whose backward (:func:`rmsnorm_backward`,
plain PyTorch in float32) recomputes each row's rsqrt from the saved x.
Each launch adds one to the counter ``rmsnorm.kernel`` of
``utils.timers`` (:func:`launch_count`); a CUDA graph's replay launches
without counting.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.timers import count, counter
from .nvcc import KernelLibrary, build_library

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "rmsnorm.cu"
_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192


def rmsnorm_plain(x, weight, eps: float):
    """The composition the kernel fuses: the CPU path and its oracle."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (weight.float() * y).to(x.dtype)


def rmsnorm_backward(g, x, weight, eps: float, need_x: bool = True,
                     need_w: bool = True):
    """Gradients (dx in x's dtype, dw in the weight's; None where not
    needed) of :func:`rmsnorm_plain` at (x, weight) for the output's
    gradient g, in float32: with ``xh = x r``, ``r = rsqrt(mean(x^2) +
    eps)`` and ``gh = g w``, ``dx = r (gh - xh mean(gh xh))`` and ``dw``
    the sum of ``g xh`` over the rows."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xh = xf * r
    gf = g.float()
    dx = dw = None
    if need_x:
        gh = gf * weight.float()
        dx = (r * (gh - xh * (gh * xh).mean(-1, keepdim=True))).to(x.dtype)
    if need_w:
        dw = (gf * xh).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
    return dx, dw


class Layout(NamedTuple):
    """What the dispatch rule reads of (x, weight)."""
    device_type: str              # x's
    x_dtype: torch.dtype
    w_dtype: torch.dtype
    d: int                        # x's last dimension
    row_stride: Optional[int]     # None: no single stride between rows
    inner_stride: int             # x's last dimension's stride
    w_shape: Tuple[int, ...]
    w_stride: Tuple[int, ...]
    same_device: bool             # weight on x's device
    x_addr: int                   # x's first element, bytes
    w_addr: int


def use_kernel(lay: Layout) -> bool:
    """The dispatch rule: False for the plain composition (a device other
    than CUDA), True for the kernel.  Raises ``ValueError`` for a CUDA
    input the kernel does not take: x or weight not bfloat16 / float32,
    ``d`` not a multiple of 8 in ``[8, MAX_D]``, an inner stride other
    than 1, rows that do not lie ``row_stride >= d`` elements apart at
    16-byte steps, a weight that is not one contiguous ``(d,)`` vector on
    x's device, or x or the weight not 16-byte aligned."""
    if lay.device_type != "cuda":
        return False
    for name, dt in (("x", lay.x_dtype), ("weight", lay.w_dtype)):
        if dt not in _CODES:
            raise ValueError(f"rmsnorm kernel: {name} dtype {dt} is not "
                             "bfloat16 or float32")
    d = lay.d
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm kernel: d={d} must be a multiple of 8 "
                         f"in [8, {MAX_D}]")
    if lay.inner_stride != 1:
        raise ValueError("rmsnorm kernel: the last dimension must be "
                         f"contiguous (stride {lay.inner_stride})")
    itemsize = 4 if lay.x_dtype == torch.float32 else 2
    rs = lay.row_stride
    if rs is None or rs < d or rs * itemsize % 16:
        raise ValueError("rmsnorm kernel: rows must lie row_stride >= d "
                         "elements apart, 16-byte aligned, in one stride "
                         f"(got {rs})")
    if tuple(lay.w_shape) != (d,) or tuple(lay.w_stride) != (1,):
        raise ValueError(f"rmsnorm kernel: weight must be contiguous ({d},),"
                         f" not {tuple(lay.w_shape)} at {tuple(lay.w_stride)}")
    if not lay.same_device:
        raise ValueError("rmsnorm kernel: weight is not on x's device")
    if lay.x_addr % 16 or lay.w_addr % 16:
        raise ValueError("rmsnorm kernel: x and weight must be 16-byte "
                         "aligned")
    return True


def _row_stride(x, d):
    """The stride between x's rows of d as one (rows, d) view without a
    copy: d for one row, None if the leading dimensions do not collapse
    into one stride."""
    try:
        r = x.view(-1, d)
    except RuntimeError:
        return None
    return r.stride(0) if r.shape[0] > 1 else d


def layout(x, weight) -> Layout:
    """The :class:`Layout` of (x, weight)."""
    d = x.shape[-1]
    return Layout(x.device.type, x.dtype, weight.dtype, d, _row_stride(x, d),
                  x.stride(-1), tuple(weight.shape), weight.stride(),
                  weight.device == x.device, x.data_ptr(), weight.data_ptr())


@functools.lru_cache(maxsize=None)
def build_kernel() -> KernelLibrary:
    """Build ``csrc/rmsnorm.cu`` with nvcc into ``build/`` (file named by
    the source's hash) unless it is there, and load it with ctypes."""
    k = build_library(_SRC, "mevi_rmsnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    k.lib.mevi_rmsnorm.argtypes = [p, i, ctypes.c_longlong, p, i, i, i,
                                   ctypes.c_float, p, p]
    k.lib.mevi_rmsnorm.restype = i
    k.lib.mevi_rmsnorm_error_string.argtypes = [i]
    k.lib.mevi_rmsnorm_error_string.restype = ctypes.c_char_p
    return k


def _launch(x, weight, eps: float, lay: Layout):
    """The kernel over inputs :func:`use_kernel` took: a contiguous
    output of x's dtype and shape."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.view(-1, lay.d)
    if rows.shape[0] == 0:
        return out
    lib = build_kernel().lib
    err = lib.mevi_rmsnorm(
        rows.data_ptr(), _CODES[lay.x_dtype], lay.row_stride,
        weight.data_ptr(), _CODES[lay.w_dtype], lay.d, rows.shape[0], eps,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.mevi_rmsnorm_error_string(err).decode())
    count("rmsnorm.kernel")
    return out


class _KernelNorm(torch.autograd.Function):
    """The kernel's forward under autograd; x and the weight are saved,
    the rsqrt of each row recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, weight, eps, lay):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch(x, weight, eps, lay)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward(g, x, weight, ctx.eps,
                                  ctx.needs_input_grad[0],
                                  ctx.needs_input_grad[1])
        return dx, dw, None, None


def rmsnorm(x, weight, eps: float):
    """RMSNorm of x (..., d) by weight (d,): the kernel for CUDA inputs
    (under :class:`_KernelNorm` while autograd records), else
    :func:`rmsnorm_plain` (see the module note).  The kernel's output is
    contiguous, of x's dtype and shape."""
    lay = layout(x, weight)
    if not use_kernel(lay):
        return rmsnorm_plain(x, weight, eps)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or weight.requires_grad):
        return _KernelNorm.apply(x, weight, eps, lay)
    return _launch(x, weight, eps, lay)


def launch_count() -> int:
    """Kernel launches in this process so far (the plain path launches
    none; a CUDA graph's replays are not counted)."""
    return counter("rmsnorm.kernel")
