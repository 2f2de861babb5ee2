"""The NCI beam replayed from CUDA graphs, for a serving loop that runs
it on many batches of one shape (``serve.BucketServer``'s coarse stage).

:func:`.beam.nci_beam_search_incremental` has no host control flow that
depends on data: ``t`` is a Python int, every shape follows from (B, Lq,
nb, K, M), top-k is a stable sort on the device and the KV caches are
reordered by device gathers, also with PAWA prefix tables.  So one CUDA
graph holds a whole call, and a replay is one launch where the eager
beam launches ~3,400 kernels a batch of 512 at T5-base widths.

:class:`BeamGraph` keeps one graph per input shape, the ``SHAPES`` most
recently used.  A shape's first call runs the beam eagerly once (cuBLAS
and the sort set up their workspaces then), captures it on a side
stream and replays the capture, so a caller's single warm-up call of a
shape leaves it captured.  Every call replays: it copies its inputs into
the graph's static buffers, replays, and clones the outputs out of them,
since the caller may issue the next batch before it reads this one's.
Off CUDA every call runs eagerly.

Counters: ``beam.graph.eager``, ``beam.graph.capture`` (once each a
shape, on the first call) and ``beam.graph.replay`` (every call on
CUDA); off CUDA ``beam.graph.eager`` every call.  Spans: a replay opens
``beam`` with one child, ``beam.graph.replay``; the beam's inner spans
(``beam.encode``, ``beam.step``, ``beam.topk``, ``beam.reorder``) open
on eager and capture calls only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..utils.timers import count, span


def _eager_only(t: torch.Tensor) -> bool:
    return t.device.type != "cuda"


class _Graph(NamedTuple):
    """A captured call: the graph, its static inputs and outputs."""
    graph: "torch.cuda.CUDAGraph"
    ids: torch.Tensor
    mask: Optional[torch.Tensor]
    codes: torch.Tensor
    scores: torch.Tensor


class BeamGraph:
    """Calls of ``beam`` (:func:`.beam.nci_beam_search_incremental` or a
    function of its signature) over ``model`` with fixed arguments:
    ``num_beams``, ``length_penalty`` and the tables (``level_tables``,
    ``pawa_tables`` as the beam takes them).  A captured graph reads
    these tensors where they lie, so they live as long as the runner."""

    SHAPES = 4

    def __init__(self, beam, model, num_beams: int, length_penalty: float,
                 level_tables=None, pawa_tables=None):
        self.beam = beam
        self.model = model
        self.args = (num_beams, length_penalty)
        self.tables = dict(level_tables=level_tables,
                           pawa_tables=pawa_tables)
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()

    def _call(self, input_ids, attention_mask):
        return self.beam(self.model, input_ids, attention_mask, *self.args,
                         **self.tables)

    @torch.inference_mode()
    def __call__(self, input_ids, attention_mask):
        """(codes (B, nb, M) int32, normalized scores (B, nb)), fresh
        tensors."""
        if _eager_only(input_ids):
            count("beam.graph.eager")
            return tuple(self._call(input_ids, attention_mask)[:2])
        key = (tuple(input_ids.shape), input_ids.dtype,
               None if attention_mask is None else attention_mask.dtype,
               input_ids.device)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(input_ids, attention_mask)
            if len(self._graphs) > self.SHAPES:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        with span("beam"):
            with span("beam.graph.replay"):
                g.ids.copy_(input_ids)
                if g.mask is not None:
                    g.mask.copy_(attention_mask)
                g.graph.replay()
                count("beam.graph.replay")
                return g.codes.clone(), g.scores.clone()

    def _capture(self, input_ids, attention_mask) -> _Graph:
        count("beam.graph.eager")
        self._call(input_ids, attention_mask)
        ids = input_ids.clone()
        mask = None if attention_mask is None else attention_mask.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._call(ids, mask)
        count("beam.graph.capture")
        return _Graph(graph, ids, mask, out[0], out[1])
