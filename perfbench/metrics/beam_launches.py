"""Kernels a batch launched by the NCI beam (the coarse stage less the
tower)."""


def read(w):
    ops = w.trace.layer_ops("coarse", outside="tower")
    return len(ops) / w.n if ops else None
