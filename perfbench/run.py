"""Run one cell of the benchmark of ``mevi_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (corpus, index, weights, server, warm-up of the cell's own shapes)
counts as ``setup_s``; then the cell's traffic runs for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics) or through a short
profiled window (``--trace 1``: its per-layer metrics).  A sample of the
served queries is then compared with the plain reference, and the last
line of standard output is the result, a JSON object.  Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits
non-zero; so it does when a JAX module is loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fr:
        bench = json.load(fr)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from perfbench import harness
    dev = torch.device("cuda:0")
    cell, cfg = harness.load_cell(args.workload)
    res = harness.run_cell(cell, cfg, args.seed, args.seconds,
                           bool(args.trace), dev, T_START)
    line = harness.result_line(res, bench, args.workload, bool(args.trace),
                               dev)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
