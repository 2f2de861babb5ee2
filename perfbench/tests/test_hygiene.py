"""What the benchmark may import, and how it refuses to run."""

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

HERE = harness.HERE


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        for name in _imports(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN, (path,
                                                                    name)
    names = {os.path.splitext(f)[0].split(".", 1)[0]
             for f in os.listdir(HERE)}
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in _modules():
        if os.sep + "reference" + os.sep in path:
            for name in _imports(path):
                assert not name.startswith("mevi_tpu"), (path, name)
                assert name.split(".", 1)[0] in ("__future__", "math",
                                                 "numpy", "torch"), name


def test_every_name_in_benchmark_json_has_its_file():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fr:
        bench = json.load(fr)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in bench["workloads"]:
        cell, cfg = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] == cfg["name"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           cell["traffic"]["kind"] + ".py"))
        for d in ("towers", "reference"):
            assert os.path.exists(os.path.join(
                HERE, d, cfg["tower"]["family"] + ".py"))
        assert set(cell["limits"]) == set(harness.compare.NAMES)
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_without_a_card_no_result_and_a_failing_exit():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "marco.b512", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
