"""Device ms a batch of kernels launched inside the query tower's range
(``pb.tower``: ``models/t5.py`` or ``models/bert.py``)."""


def read(w):
    s = w.trace.layer_seconds("tower")
    return None if s is None else s * 1e3 / w.n
