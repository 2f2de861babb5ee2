"""The readings the limits of a cell were set from: the program's compared
numbers over many seeds and the control's over a few, each from a short
window at the cell's own load, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds a,b,...
        --control <k> --seconds <s>

For each seed one JSON line on standard output: the program's numbers
and, for the first ``k`` seeds, the control's (``compare.control_sample``:
the reference in float8 put in the program's place on the same sample).
Not part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import compare, harness

    dev = torch.device("cuda:0")
    cell, cfg = harness.load_cell(args.workload)
    for k, seed in enumerate(int(x) for x in args.seeds.split(",")):
        keep = {}
        res = harness.run_cell(cell, cfg, seed, args.seconds, False, dev,
                               time.time(), keep=keep)
        line = {"seed": seed, "program": keep["numbers"],
                "metrics": res["metrics"]}
        if k < args.control:
            ctrl = compare.control_sample(keep["reference"], keep["sample"])
            line["control"] = compare.readings(keep["reference"], ctrl)
        print(json.dumps(line), flush=True)
        del keep, res
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
