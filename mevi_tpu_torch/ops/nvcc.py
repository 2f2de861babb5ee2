"""Build a CUDA source of ``csrc/`` with nvcc into a shared library with
a plain C interface, and load it with ctypes.

The library goes to ``build/`` at the root of the checkout, named by the
source's hash (``lib<stem>_<sha256[:12]>.so``), so an unchanged source is
built once for every process of a checkout and a changed one is rebuilt.
A build writes a temporary file and renames it into place, so processes
that build at once never load half a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

BUILD = Path(__file__).resolve().parents[2] / "build"


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: Optional[float]    # None: built by an earlier process
    build_log: str


def build_library(src_path: Path, stem: str,
                  extra_flags: Sequence[str] = ()) -> KernelLibrary:
    """nvcc ``src_path`` for sm_90a (``-O3``, ``-Xptxas -v``, plus
    ``extra_flags``) into ``build/lib<stem>_<hash>.so`` unless it is
    there, and load it; raises ``RuntimeError`` if nvcc is missing or
    fails (its output in the message)."""
    src = src_path.read_bytes()
    path = BUILD / f"lib{stem}_{hashlib.sha256(src).hexdigest()[:12]}.so"
    secs, log = None, ""
    if not path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"{stem}: nvcc not found")
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               *extra_flags, "-Xptxas", "-v", "-o", tmp, str(src_path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{stem}: nvcc failed:\n{log}")
        os.replace(tmp, path)
    return KernelLibrary(ctypes.CDLL(str(path)), path, secs, log)
