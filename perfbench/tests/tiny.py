"""A cell and configuration at a size the CPU runs in seconds, with the
shapes of the real ones (4 code levels, PAWA, aligned windows)."""

import copy

from perfbench import harness


def tiny(cell_name: str = "marco.b512", family: str = "t5"):
    cell, cfg = harness.load_cell(cell_name)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    cfg["corpus"].update(ndoc=3000, d=64, pool_rows=64)
    cfg["index"]["kary"] = 4
    small = dict(d_model=64, d_kv=16, d_ff=128, num_heads=4, num_layers=2)
    cfg["nci"].update(small, vocab_size=128, num_decoder_layers=2, kary=4,
                      pawa={"num_layers": 2, "num_heads": 4, "d_ff": 96,
                            "layer_norm_epsilon": 1e-05})
    if family == "t5":
        cfg["tower"].update(small, vocab_size=128, num_decoder_layers=2)
    else:
        cfg["tower"] = {"family": "bert", "rep": "cls_rep",
                        "vocab_size": 120, "d_model": 64, "num_layers": 2,
                        "num_heads": 4, "d_ff": 128,
                        "max_position_embeddings": 16, "type_vocab_size": 4,
                        "layer_norm_epsilon": 1e-12,
                        "initializer_range": 0.02}
    cfg["serving"].update(num_beams=3, cap=16, pool=20, query_length=8)
    # shorter than the padded length, so that the masks are exercised
    cfg["query_lengths"] = {"kind": "fixed", "tokens": 5}
    cell["traffic"]["params"].update(batch=4, check_queries=12, max_qps=400,
                                     warm_batches=1, trace_batches=2)
    return cell, cfg
