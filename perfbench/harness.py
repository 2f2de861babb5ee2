"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Everything a cell needs is found by name: its file
``perfbench/workloads/<cell>.json`` (configuration, traffic kind and
parameters, limits), the configuration ``perfbench/configs/<config>.json``,
the traffic module ``perfbench/traffic/<kind>.py``, the query tower's
family ``perfbench/towers/<family>.py`` with its plain reference
``perfbench/reference/<family>.py`` (``lookup.py``) and, for each
per-layer metric ``BENCHMARK.json`` gives the cell, the reader
``perfbench/metrics/<metric>.py``.

The program under test is ``mevi_tpu_torch``: its models and
``serve.BucketServer`` over a ``FineIndex`` whose CSR the program builds
(``utils.native.build_csr``) from the benchmark's document codes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, counts, data, weights
from .lookup import load_module, tower as tower_family
from .reference import nci as ref_nci

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mevi_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as fr:
        return json.load(fr)


def cell_metrics(bench, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``BENCHMARK.json`` gives ``cell``."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

class TowerTap:
    """The query tower as ``BucketServer`` calls it (``first_token_rep``),
    whatever the family's own name for the representation; keeps only
    its last output (``last``), which the traffic takes beside the
    batch's handle."""

    def __init__(self, rep):
        self.rep = rep
        self.last: Optional[torch.Tensor] = None

    def first_token_rep(self, ids, mask):
        self.last = self.rep(ids, mask)
        return self.last


def build_program(cfg, seed: int, corpus: data.Corpus, dev):
    """(server, tap): the port's models with the seed's weights and its
    server over the corpus, laid out by the port's CSR."""
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.models.nci import NCIDims, NCIT5
    from mevi_tpu_torch.models.t5 import T5Dims
    from mevi_tpu_torch.serve import BucketServer
    from mevi_tpu_torch.utils.native import build_csr

    dt = weights.dtype_of(cfg)
    ix, sv = cfg["index"], cfg["serving"]
    t0 = time.time()
    offsets, doc_ids = build_csr(corpus.codes().cpu().numpy(), ix["kary"])
    semb = data.fill_rows(corpus, torch.from_numpy(doc_ids), dt)
    index = FineIndex(torch.from_numpy(offsets.astype(np.int32)).to(dev),
                      torch.from_numpy(doc_ids).to(dev), semb,
                      ix["levels"], ix["kary"], host_offsets=offsets,
                      host_doc_ids=doc_ids)
    sync(dev)
    log(f"index (port CSR + rows in its order): {time.time() - t0:.2f}s")

    t0 = time.time()
    c = cfg["nci"]
    t5 = T5Dims(vocab_size=c["vocab_size"], d_model=c["d_model"],
                d_kv=c["d_kv"], d_ff=c["d_ff"], num_heads=c["num_heads"],
                num_layers=c["num_layers"],
                num_decoder_layers=c["num_decoder_layers"],
                relative_attention_num_buckets=c[
                    "relative_attention_num_buckets"],
                relative_attention_max_distance=c[
                    "relative_attention_max_distance"],
                layer_norm_epsilon=c["layer_norm_epsilon"], dropout_rate=0.0,
                dtype=dt)
    pw = c["pawa"]
    nci = NCIT5(NCIDims(t5=t5, kary=c["kary"],
                        max_output_length=c["max_output_length"],
                        adaptor_layer_num=pw["num_layers"],
                        adaptor_num_heads=pw["num_heads"],
                        adaptor_d_ff=pw["d_ff"]), device=dev, dtype=dt)
    nci.load_state_dict(weights.make(ref_nci.specs(c), seed,
                                     weights.NCI_STREAM, dev, dt))
    tc = cfg["tower"]
    tw = weights.make(compare.tower_specs(cfg), seed, weights.TOWER_STREAM,
                      dev, dt)
    tap = TowerTap(tower_family(tc["family"]).build(tc, tw, dev, dt))
    del tw
    server = BucketServer(tap, nci, index, num_beams=sv["num_beams"],
                          cap=sv["cap"], pool=sv["pool"],
                          length_penalty=sv["length_penalty"], device=dev)
    sync(dev)
    log(f"models + server: {time.time() - t0:.2f}s")
    return server, tap


def add_ranges(server, tap):
    """Wrap the server's own stages and the tower in ``pb.<layer>``
    profiler ranges (traced runs only).  A stage the server no longer
    has is left out, and its metric finds nothing to read."""
    from torch.profiler import record_function

    def ranged(fn, name):
        def call(*a, **k):
            with record_function("pb." + name):
                return fn(*a, **k)
        return call
    for attr, name in (("coarse", "coarse"), ("bucket", "bucket"),
                       ("pool_topk", "pool")):
        if hasattr(server, attr):
            setattr(server, attr, ranged(getattr(server, attr), name))
    tap.rep = ranged(tap.rep, "tower")


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a traffic module hands back: end-to-end values, counts, the
    served sample, and (traced runs) the window's reading."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    sample: Optional[compare.Sample]
    window: Optional[object] = None


@dataclasses.dataclass
class Window:
    """What a traced run reads.  From the profiled batches: the trace,
    their number and their bucket bytes and operations (analytic).  From
    the untraced window before them (the profiler slows the host): the
    host seconds of each ``finalize``, the window's wall seconds and the
    model FLOPs (analytic) of the batches it served."""
    trace: object
    n: int
    bucket_bytes: float
    bucket_flops: float
    finalize_s: List[float]
    wall_flops: float
    wall_s: float


@dataclasses.dataclass
class Context:
    """What a traffic module drives: the cell, the server, the corpus,
    and the FLOP and byte counters of the configuration."""
    cell: dict
    cfg: dict
    seed: int
    dev: torch.device
    server: object
    tap: TowerTap
    corpus: data.Corpus
    offsets: np.ndarray
    state: dict = dataclasses.field(default_factory=dict)

    def queries(self, n: int, stream: int, batch: int) -> data.Queries:
        sv, tc = self.cfg["serving"], self.cfg["tower"]
        return data.make_queries(self.corpus, n, sv["query_length"],
                                 tc["vocab_size"], self.cfg["query_lengths"],
                                 sv["num_beams"], self.seed, stream, batch)

    def model_flops(self, lengths) -> float:
        return (counts.tower_flops(lengths, self.cfg["tower"])
                + counts.beam_flops(lengths, self.cfg["nci"],
                                    self.cfg["serving"]["num_beams"]))

    def bucket_counts(self, cidx) -> tuple:
        sv, ix = self.cfg["serving"], self.cfg["index"]
        return counts.bucket_counts(
            np.asarray(cidx, np.int64), self.offsets, sv["cap"],
            ix["window_align"], self.cfg["corpus"]["d"],
            torch.tensor([], dtype=weights.dtype_of(self.cfg)).element_size())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_cell(name: str):
    """(cell, configuration) dicts of the cell ``name``."""
    cell = load_json(HERE, "workloads", name + ".json")
    return cell, load_json(HERE, "configs", cell["config"] + ".json")


def run_cell(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
             dev, t_start: float, keep=None) -> dict:
    """One run; returns the result line's fields (and fills ``keep``
    with the sample and the reference when given)."""
    traffic = load_module(os.path.join(HERE, "traffic",
                                       cell["traffic"]["kind"] + ".py"),
                          "perfbench_traffic_" + cell["traffic"]["kind"])
    t0 = time.time()
    corpus = data.make_corpus(data.CorpusSpec.from_config(cfg), seed, dev)
    sync(dev)
    log(f"corpus draws: {time.time() - t0:.2f}s")
    server, tap = build_program(cfg, seed, corpus, dev)
    ix = cfg["index"]
    sizes = torch.bincount(corpus.cluster, minlength=ix["kary"] ** ix["levels"])
    offsets = np.concatenate([[0], np.cumsum(sizes.cpu().numpy())])
    ctx = Context(cell, cfg, seed, dev, server, tap, corpus, offsets)
    if trace:
        add_ranges(server, tap)
    traffic.prepare(ctx, seconds, trace)
    traffic.warm(ctx)
    sync(dev)
    setup_s = time.time() - t_start
    log(f"set-up: {setup_s:.2f}s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = (traffic.traced(ctx, seconds) if trace
           else traffic.measure(ctx, seconds))
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    # the program's state goes before the reference runs
    del ctx, server, tap
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ref = compare.Reference(cfg, corpus, seed, dev)
    numbers = compare.readings(ref, run.sample)
    log(f"comparison over {run.sample.ids.shape[0]} queries: "
        f"{time.time() - t0:.2f}s")
    correct, checks = compare.judge(numbers, cell.get("limits"), run.failed)
    if keep is not None:
        keep.update(sample=run.sample, reference=ref, numbers=numbers)
    return dict(correct=correct, attempted=run.attempted, failed=run.failed,
                metrics=dict(run.metrics, setup_s=setup_s), window=run.window,
                memory_peak_bytes=mem_peak, checks=checks)


def result_line(res: dict, bench: dict, cell_name: str, trace: bool,
                dev) -> dict:
    """The contract's last line.  Untraced: the cell's end-to-end
    metrics; traced: its per-layer metrics (a reader that finds nothing
    leaves its metric out)."""
    metrics = {}
    if trace:
        for m in cell_metrics(bench, cell_name, "per_layer"):
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "perfbench_metric_" + m["name"])
            v = reader.read(res["window"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell_name, "end_to_end"):
            if m["name"] not in res["metrics"]:
                raise KeyError(f"{cell_name} does not report {m['name']}")
            metrics[m["name"]] = {"value": res["metrics"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        w = res["window"]
        device.update(busy_s=w.trace.busy_s(), window_s=w.trace.window_s)
        line["breakdown"] = {"device_ops": w.trace.device_ops(),
                             "idle_gaps": w.trace.idle_gaps()}
    line["checks"] = res["checks"]
    return line
