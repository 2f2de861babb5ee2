"""Share of the bucket stage's roofline: its least time (the larger of
the bytes the inputs need over the HBM bandwidth and its operations
over the bf16 peak, ``perfbench/counts.py``) over the device time of the
kernels launched inside the server's bucket stage (``pb.bucket``)."""

from perfbench import counts


def read(w):
    s = w.trace.layer_seconds("bucket")
    if s is None or w.bucket_bytes <= 0:
        return None
    return 100.0 * counts.least_seconds(w.bucket_bytes, w.bucket_flops) / s
