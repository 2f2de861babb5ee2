"""Device ms a batch of the query tower's MoE blocks (``pb.moe``, opened
by ``towers/deepseek_v2.py`` around each MoE layer's feed-forward:
router, dispatch, routed and shared experts, combine)."""


def read(w):
    s = w.trace.layer_seconds("moe")
    return None if s is None else s * 1e3 / w.n
