"""Arithmetic shared by the plain references: float32 with TF32 off, and
the control's lower precision.

``Precision("f32")`` is the reference.  ``Precision("fp8")`` is the
control: every operand of a matrix product (weights, activations, query
and corpus rows) is rounded to float8 e4m3 with one scale per tensor
(its largest magnitude mapped to 448) before a float32 product, the
step below the bfloat16 the configurations serve in.  Norms, softmax
and sums stay in float32.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as float32, rounded to this precision's operands."""
        x = x.float()
        if self.kind == "f32":
            return x
        amax = x.abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def linear(self, x, w, b=None):
        """``x @ w.T (+ b)``, w (out, in)."""
        y = self.q(x) @ self.q(w).T
        return y if b is None else y + b.float()

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


F32 = Precision("f32")


def rms_norm(x, w, eps):
    x = x.float()
    return w.float() * (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                        + eps))


def layer_norm(x, w, b, eps):
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],),
                                          w.float(), b.float(), eps)


def additive_mask(mask):
    """(b, k) 1/0 -> (b, 1, 1, k) float32: 0 where kept, -1e9 elsewhere."""
    return (mask[:, None, None, :].float() - 1.0) * 1e9
