"""Share of the MoE blocks' roofline in ``marco-dsv2lite.b512``: their
least time over a batch (the larger of the bytes over the HBM bandwidth
and the operations over the bf16 peak, ``towers/deepseek_v2.py``'s
``moe_counts``: every routed, shared and gate weight read once, each
block's token rows read and written once; the gate's, the routed
(row, expert) pairs' and the shared experts' products) over the device
time a batch of the kernels launched inside ``pb.moe``, whatever kernels
do the work.  The batch's tokens and the widths come from that cell's
workload and configuration files, which the reader names (``CELL``):
``Window`` carries neither the run's configuration nor its token count.
So the reader is valid for this one cell only, and ``BENCHMARK.json``
lists no other cell for it; another cell's trace read here would be
divided by this cell's least time."""

from perfbench import data, harness, lookup, weights

CELL = "marco-dsv2lite.b512"


def read(w):
    s = w.trace.layer_seconds("moe")
    if s is None:
        return None
    cell, cfg = harness.load_cell(CELL)
    tokens = int(data.length_table(cfg["query_lengths"],
                                   cell["traffic"]["params"]["batch"]).sum())
    itemsize = weights.dtype_of(cfg).itemsize
    least = lookup.tower(cfg["tower"]["family"]).moe_least_seconds(
        cfg["tower"], tokens, itemsize)
    return 100.0 * least / (s / w.n)
