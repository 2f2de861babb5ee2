"""Process mesh and collectives on ``torch.distributed`` (port of
``mevi_tpu.parallel.mesh``).

The JAX package runs one jit program over a 2-D device mesh:

* ``data``   shards query batches (data parallelism),
* ``corpus`` shards the document matrix and every corpus-wide job;
  per-shard top-k results merge by ``all_gather``.

Here each mesh position is one process (a rank).  Rank ``r`` of a
``data x corpus`` mesh sits at ``(r // corpus, r % corpus)``, the JAX
grid's row-major order, and holds one process group per axis: the data
group joins the ranks with its corpus index, the corpus group the ranks
with its data index.  Every collective names its group through the mesh;
nothing relies on the default group.  Every rank's device is explicit:
``cuda:LOCAL_RANK`` unless the caller passes one (several ranks may share
one card, as ``launch_local(device="cuda:0")`` does).

``launch_local`` takes the place of ``virtual_cpu_devices``: it spawns
the ranks of a one-host world, rendezvous through a file store.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

DATA_AXIS = "data"
CORPUS_AXIS = "corpus"
AXES = (DATA_AXIS, CORPUS_AXIS)
_BUCKET_ELEMS = 1 << 26         # gradient all-reduce bucket, elements
_TIMEOUT = datetime.timedelta(minutes=15)   # a collective's longest wait


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``data x corpus`` mesh: its rank, device and
    one process group per axis (None without a ``torch.distributed``
    world: collectives over the axis are then identities)."""
    data: int
    corpus: int
    rank: int
    device: torch.device
    groups: Dict[str, Optional[dist.ProcessGroup]]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, CORPUS_AXIS: self.corpus}

    @property
    def coords(self):
        """(data index, corpus index) of this rank."""
        return divmod(self.rank, self.corpus)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``lax.axis_index``)."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def _rank_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda:LOCAL_RANK``; raises without a
    card when CUDA is asked for."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} is not present "
                               f"({torch.cuda.device_count()} cards)")
        torch.cuda.set_device(dev)
    return dev


def make_mesh(data: Optional[int] = None, corpus: int = 1,
              device=None) -> Mesh:
    """This rank's ``data x corpus`` mesh over the initialized world.

    ``data`` defaults to ``world // corpus`` (``MeshConfig.axis_sizes``
    gives both sizes of a config).  Every rank builds every group in the
    same order (``new_group`` is collective), in the world's backend.
    Without an initialized world the mesh is :func:`single_device_mesh`;
    with one, every axis has its group, also of one rank (so a one-rank
    NCCL world runs its collectives)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // corpus
    if data * corpus != world:
        raise ValueError(f"mesh {data} x {corpus} != world of {world}")
    if not dist.is_initialized():
        return single_device_mesh(device)
    rank = dist.get_rank()
    dev = _rank_device(device)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for c in range(corpus):
        ranks = [d * corpus + c for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[DATA_AXIS] = g
    for d in range(data):
        ranks = [d * corpus + c for c in range(corpus)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups[CORPUS_AXIS] = g
    return Mesh(data, corpus, rank, dev, groups)


def single_device_mesh(device=None) -> Mesh:
    """The 1 x 1 mesh of one process: no process group, collectives are
    identities."""
    return Mesh(1, 1, 0, _rank_device(device), {a: None for a in AXES})


def init_distributed(backend: str, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> None:
    """Join the world (counterpart of ``initialize_multihost``): from
    torchrun's ``RANK`` / ``WORLD_SIZE`` (``env://``) when ``rank`` is
    None, else from the explicit arguments and ``init_method`` (a
    ``file://`` path every rank can reach)."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    elif init_method is None or world_size is None:
        raise ValueError("explicit ranks need world_size and init_method")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)


def pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_rows(x, mesh: Mesh, axis: str = CORPUS_AXIS) -> torch.Tensor:
    """This rank's rows of ``x`` (a host array or a tensor) along
    ``axis``, on the rank's device: rows padded with zeros to a multiple
    of the axis size, as the JAX package pads them, then split evenly.
    The shard is the rank's own allocation (a copy, also when ``x`` is
    on the device already)."""
    size = mesh.size(axis)
    n = x.shape[0]
    per = pad_to(n, size) // size
    lo = mesh.index(axis) * per
    hi = min(lo + per, n)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    out = torch.zeros((per,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=mesh.device)
    if hi > lo:
        out[:hi - lo].copy_(t[lo:hi])
    return out


def data_slice(x, mesh: Mesh):
    """This rank's rows of a global batch (the batch divides ``data``)."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"batch of {n} does not divide data={mesh.data}")
    per = n // mesh.data
    s = mesh.index(DATA_AXIS) * per
    return x[s:s + per]


# ---------------------------------------------------------------------------
# collectives over one axis
# ---------------------------------------------------------------------------

def all_gather_list(x: torch.Tensor, mesh: Mesh, axis: str
                    ) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in axis order (no gradient)."""
    if mesh.group(axis) is None:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(out, x, group=mesh.group(axis))
    return out


class _GatherRows(torch.autograd.Function):
    """Tiled all-gather along dim 0 whose backward sums the gradient of
    this rank's block over the ranks, the transpose JAX gives
    ``all_gather`` (``psum_scatter``).  The backward is one all-reduce of
    the whole gathered gradient (``torch.distributed.nn``'s gather falls
    back to global-rank scatters over gloo, which miss subgroups)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, x.shape[0]
        return torch.cat(all_gather_list(x, mesh, axis), 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.group(ctx.axis))
        s = ctx.mesh.index(ctx.axis) * ctx.n
        return g[s:s + ctx.n], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
                ) -> torch.Tensor:
    """``all_gather(x, axis, tiled=True)``: the ranks' rows concatenated
    in axis order.  Gradients flow back to each rank's rows, summed over
    the ranks; equal row counts on every rank."""
    if mesh.group(axis) is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, mesh, axis)
    return torch.cat(all_gather_list(x, mesh, axis), 0)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    axis: str = DATA_AXIS) -> None:
    """Sum ``tensors`` over ``axis`` in place, in flattened buckets of
    one dtype (one collective per bucket)."""
    if mesh.group(axis) is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        start = 0
        while start < len(ts):
            end, n = start + 1, ts[start].numel()
            while end < len(ts) and n + ts[end].numel() <= _BUCKET_ELEMS:
                n += ts[end].numel()
                end += 1
            flat = torch.cat([t.reshape(-1) for t in ts[start:end]])
            dist.all_reduce(flat, group=mesh.group(axis))
            o = 0
            for t in ts[start:end]:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()
            start = end


# ---------------------------------------------------------------------------
# a one-host launcher (tests, the dry run, chip_smoke.py)
# ---------------------------------------------------------------------------

def _local_device(device: str, rank: int) -> str:
    """``"cuda"`` means ``cuda:LOCAL_RANK``; an indexed device is shared
    by every rank; ``"cpu"`` is the host."""
    return f"cuda:{rank}" if device == "cuda" else device


def _rank_main(rank, fn, world, backend, device, workdir, args):
    os.environ["LOCAL_RANK"] = str(rank)
    dev = _local_device(device, rank)
    if torch.device(dev).type == "cpu":
        torch.set_num_threads(1)      # the ranks share the host's cores
    else:
        torch.cuda.set_device(torch.device(dev))
    init_distributed(backend, rank, world,
                     "file://" + os.path.join(workdir, "store"))
    try:
        out = fn(torch.device(dev), *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def launch_local(fn: Callable, world: int, backend: str, device: str,
                 *args, workdir: Optional[str] = None) -> List:
    """Run ``fn(device, *args)`` in ``world`` spawned ranks of one host
    and return their results in rank order.

    Each rank joins a ``backend`` world through a ``file://`` store
    (``init_distributed``) in a fresh temporary directory under
    ``workdir`` (the system's by default), runs ``fn`` on
    its device (see :func:`_local_device`) and saves what it returns
    (host objects) for the parent.  ``fn`` must be importable by name
    (spawn pickles it); tensors among ``args`` reach the ranks through
    shared memory, CUDA ones through CUDA IPC.  Pass big host arrays as
    tensors (``torch.from_numpy``): arguments pickled by value past the
    pipe's buffer hold the parent until each rank has imported, so the
    ranks start one after another.  If a rank fails, the others are
    stopped and this raises."""
    import torch.multiprocessing as tmp

    resolve_device(device)
    with tempfile.TemporaryDirectory(dir=workdir) as wd:
        tmp.start_processes(_rank_main, args=(fn, world, backend, device, wd,
                                              args),
                            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(wd, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
