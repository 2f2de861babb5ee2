"""The whole step's share of the chip's bf16 peak: the analytic model
FLOPs (tower and beam, ``perfbench/counts.py``) of the batches the
untraced window served over that window's wall seconds."""

from perfbench import counts


def read(w):
    if w.wall_flops <= 0 or w.wall_s <= 0:
        return None
    return 100.0 * w.wall_flops / w.wall_s / counts.H100_BF16_FLOPS
