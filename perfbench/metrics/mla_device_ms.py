"""Device ms a batch of the query tower's multi-head latent attention
blocks (``pb.mla``, opened by ``towers/deepseek_v2.py`` around each
layer's attention: projections, kv norm, RoPE, attention, ``o_proj``)."""


def read(w):
    s = w.trace.layer_seconds("mla")
    return None if s is None else s * 1e3 / w.n
