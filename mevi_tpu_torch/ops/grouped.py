"""Grouped matrix products for a mixture of experts: the rows of each
expert side by side in one operand, one product for all experts.

``grouped_mm(x, w, ends)``: ``x`` (M, K) holds the rows of expert 0,
then expert 1, ...; ``ends`` (E,) int32 the cumulative row counts (the
end of each expert's rows), made on the device; ``w`` (E, N, K) the
experts' weights in ``nn.Linear`` layout.  Row ``i`` of the result is
``x[i] @ w[e].T`` for the expert ``e`` whose rows hold ``i``.  It is
``torch._grouped_mm`` (a CUTLASS grouped GEMM on Hopper in bf16; a plain
loop elsewhere), which reads the group ends on the device: no count
comes back to the host, so the product neither waits for the device
nor breaks a CUDA graph.

``torch.utils.flop_counter`` has no rule for ``aten._grouped_mm``; one
is registered here (2 M K N, every row in exactly one group) so that
``FlopCounterMode`` (``utils.profiling.flops_of``) counts the expert
products as it counts ``mm``.
"""

from __future__ import annotations

import math

import torch


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """(M, K) rows grouped by ``ends`` times ``w[e].T`` (E, N, K) ->
    (M, N), in ``x``'s dtype."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """The same product, one expert at a time (reads ``ends`` on the
    host)."""
    out, start = [], 0
    for e, end in enumerate(ends.tolist()):
        out.append(x[start:end] @ w[e].T)
        start = end
    return torch.cat(out)


def _register_flops():
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    op = torch.ops.aten._grouped_mm
    if op in flop_registry:
        return

    @register_flop_formula(op)
    def _grouped_mm_flop(a_shape, b_shape, *args, **kwargs) -> int:
        # every row of ``a`` meets one group's (K, N) block of ``b``
        return 2 * math.prod(a_shape[:-1]) * a_shape[-1] * b_shape[-1]


_register_flops()
