"""Device ms a batch of the pool top-k (``pb.pool``:
``eval/searcher.merge_pool``)."""


def read(w):
    s = w.trace.layer_seconds("pool")
    return None if s is None else s * 1e3 / w.n
