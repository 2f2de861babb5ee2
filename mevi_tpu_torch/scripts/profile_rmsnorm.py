"""Time the fused RMSNorm kernel (``ops.rmsnorm``) against its byte bound
and against the plain composition it replaces, at the served shapes.

Each shape is rows x d of bf16 (x and weight, as the towers and the NCI
beam serve them); ``rows x d/stride`` reads d of each stride-wide row in
place (DeepSeek-V2's ``kv_a_layernorm``: 512 of 576).  A timing is the
median over ``--reps`` replays of a CUDA graph of one launch on each of
enough distinct inputs to hold four times the card's 50 MB L2 cache,
divided by their number: every launch reads its input from device
memory, and the host's launch cost is left out, as in the beam's
replay.  The bound is the bytes one pass must move (x read, output
written, the weight once) at 3.35 TB/s.

    python -m mevi_tpu_torch.scripts.profile_rmsnorm [--shapes
        16384x768,5120x768,16384x2048,16384x512/576] [--reps R]

Prints one JSON line: the device's name and, for each shape, the
kernel's and the plain composition's ms, the yardstick's (PyTorch's own
``torch.nn.functional.rms_norm``, which the port never calls), the
bytes, the bound, the kernel's share of it and the largest difference
between the kernel's and the plain composition's outputs.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.rmsnorm import rmsnorm, rmsnorm_plain
from ..utils.profiling import H100_SXM_HBM_BYTES_PER_S as HBM_BYTES_PER_S

SHAPES = "16384x768,5120x768,16384x2048,16384x512/576"
L2_BYTES = 50 * 2 ** 20
EPS = 1e-6


def parse_shape(s: str):
    """``RxD`` or ``RxD/S`` -> (rows, d, row stride)."""
    rows, rest = s.split("x")
    d, _, stride = rest.partition("/")
    return int(rows), int(d), int(stride or d)


def bytes_of(rows: int, d: int, item: int = 2, w_item: int = 2) -> int:
    """Bytes one pass moves: each input element read and each output
    element written once, the weight read once."""
    return rows * d * 2 * item + d * w_item


def _timed_ms(fn, inputs, reps: int) -> float:
    """Device ms a call: one launch on each input, captured in one CUDA
    graph (so the host's launch cost is out of it, as in the beam's
    replay), the median over ``reps`` replays between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:                           # warm up, build
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / len(inputs))
    del graph
    return statistics.median(out)


def profile(shapes, reps: int = 20, seed: int = 0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    res = {}
    for s in shapes:
        rows, d, stride = parse_shape(s)
        nbytes = bytes_of(rows, d)
        n = max(2, -(-4 * L2_BYTES // (rows * stride * 2)))
        inputs = [torch.randn((rows, stride), generator=g, device=dev)
                  .to(torch.bfloat16)[:, :d] for _ in range(n)]
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
            torch.bfloat16)
        with torch.inference_mode():
            err = (rmsnorm(inputs[0], w, EPS).float()
                   - rmsnorm_plain(inputs[0], w, EPS).float()).abs().max()
            kernel_ms = _timed_ms(lambda x: rmsnorm(x, w, EPS), inputs, reps)
            plain_ms = _timed_ms(lambda x: rmsnorm_plain(x, w, EPS), inputs,
                                 reps)
            library_ms = _timed_ms(
                lambda x: torch.nn.functional.rms_norm(x, (d,), w, EPS),
                inputs, reps)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[s] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms,
                  "bytes": nbytes, "bound_ms": bound_ms,
                  "share_pct": 100.0 * bound_ms / kernel_ms,
                  "max_abs_diff": float(err), "inputs": n}
        del inputs
    return {"device": torch.cuda.get_device_name(dev), "shapes": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rmsnorm: CUDA is not available")
    print(json.dumps({"reps": args.reps,
                      **profile(args.shapes.split(","), args.reps,
                                args.seed)}))


if __name__ == "__main__":
    main()
