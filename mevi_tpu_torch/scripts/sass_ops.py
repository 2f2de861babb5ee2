"""Opcode counts of the bucket kernels as compiled: ``cuobjdump -sass``
of the library ``ops.bucket.build_kernel`` builds (the CUDA toolkit's
``cuobjdump``, on the card's machine).

    python -m mevi_tpu_torch.scripts.sass_ops [--match TEXT ...]
        [--sass FILE]

For each kernel whose demangled name (``c++filt``, where present)
contains every ``--match`` text, prints one JSON line: the name, its
instruction count, its opcode counts (guard predicates and modifiers
stripped: ``@!P0 LDS.U.128`` counts as ``LDS``) and ``lds128_ahead``:
the 16-byte shared loads between the last barrier (``BAR``) and the
first ``FFMA``, i.e. the loads a warp has issued for a tile before its
first product.  ``--sass`` reads a saved dump instead of building.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess

_FUNC = re.compile(r"^\s*Function : (\S+)", re.M)
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _demangle(names):
    if not shutil.which("c++filt"):
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return [n.replace("(anonymous namespace)::", "")
            for n in out.splitlines()]


def kernel_ops(sass: str):
    """{demangled name: (opcode Counter, lds128_ahead, instructions)}."""
    heads = list(_FUNC.finditer(sass))
    names = _demangle([m.group(1) for m in heads])
    out = {}
    for i, (m, name) in enumerate(zip(heads, names)):
        end = heads[i + 1].start() if i + 1 < len(heads) else len(sass)
        insns = _INSN.findall(sass[m.end():end])
        ops = collections.Counter(op.split(".")[0] for op in insns)
        first = next((j for j, op in enumerate(insns)
                      if op.split(".")[0] == "FFMA"), None)
        ahead = 0
        if first is not None:
            bar = max((j for j, op in enumerate(insns[:first])
                       if op.startswith("BAR")), default=-1)
            ahead = sum(1 for op in insns[bar + 1:first]
                        if op.startswith("LDS") and op.endswith(".128"))
        out[name] = (ops, ahead, len(insns))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", action="append", default=[],
                    help="text the kernel's name must contain (repeatable)")
    ap.add_argument("--sass", help="a saved cuobjdump -sass dump")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as f:
            sass = f.read()
    else:
        from ..ops.bucket import build_kernel
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "-sass", str(build_kernel().path)],
                              capture_output=True, text=True,
                              check=True).stdout
    for name, (ops, ahead, n) in kernel_ops(sass).items():
        if all(t in name for t in args.match):
            print(json.dumps({"kernel": name, "instructions": n,
                              "lds128_ahead": ahead,
                              "ops": dict(ops.most_common())}))


if __name__ == "__main__":
    main()
