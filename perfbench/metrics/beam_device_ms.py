"""Device ms a batch of the NCI beam: kernels launched inside the server's
coarse stage (``pb.coarse``) and not inside the tower (``decode/beam.py``,
``models/nci.py``, ``models/pawa.py``)."""


def read(w):
    s = w.trace.layer_seconds("coarse", outside="tower")
    return None if s is None else s * 1e3 / w.n
