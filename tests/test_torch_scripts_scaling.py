"""``mevi_tpu_torch.scripts.scaling_curve`` on the CPU: two tiny corpus
sizes over a tiny port bundle (``quality_full`` at ``QF_TINY``), each a
``mevi_tpu_torch.bench --device cpu`` child.

* every row holds the JAX script's ``KEEP`` keys, equal to its child's
  line, and a sidecar per size;
* a re-run resumes from the sidecars without a child (``subprocess.run``
  patched to fail);
* a child that fails or times out stops the run with a non-zero exit
  naming its size (the JAX script skips the size);
* the default outputs lie under ``build/``, none is a file the JAX round
  left in the repository.
"""

import json
import os
import os.path as osp
import subprocess
from unittest import mock

import pytest

from mevi_tpu_torch.scripts import scaling_curve as sc
from torch_one_thread import one_thread  # noqa: F401

TINY_ENV = {
    "QF_TINY": "1", "QF_NDOC": "400", "QF_UTT": "2", "QF_EPOCHS": "1",
    "QF_BATCH": "16", "QF_TOWER_STEPS": "8", "QF_TOWER_BATCH": "32",
    "QF_TOWER_SCAN": "4", "QF_NDEV": "64", "QF_EVAL_BATCH": "32",
    "QF_CAP": "64", "QF_POOL": "50",
}
SIZES = (300, 400)
JAX_KEEP = ("ndoc", "trained_coarse_hit@1", "trained_coarse_hit@10",
            "trained_fine_recall@100", "trained_fine_mrr@10",
            "trained_fine_recall@100_beam_major",
            "trained_fine_mrr@10_beam_major",
            "trained_ndoc_per_query", "cluster_sizes", "value",
            "corpus_dtype", "batch", "cap")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.scripts import quality_full as qf
    base = tmp_path_factory.mktemp("scaling")
    work = str(base / "bundle")
    with mock.patch.dict(os.environ, dict(TINY_ENV, QF_WORKDIR=work)), \
            mock.patch.object(synth, "default_cache_base",
                              lambda: str(base / "synth")):
        qf.main(["--device", "cpu"])
    return work


@pytest.fixture(scope="module")
def first_run(bundle, tmp_path_factory):
    side = str(tmp_path_factory.mktemp("side"))
    env = dict(os.environ, TMPDIR=str(tmp_path_factory.mktemp("tmp")))
    with mock.patch.dict(os.environ, env):
        curve, lines = sc.run(SIZES, "int8", "cpu", ckpt=bundle,
                              side_dir=side, timeout=600,
                              extra=("--nbatch", "2"))
    return side, curve, lines


def test_keep_is_the_jax_scripts():
    assert sc.KEEP == JAX_KEEP


def test_rows_hold_keep(first_run, bundle):
    side, curve, lines = first_run
    assert curve["metric"] == "trained_recall_vs_corpus_size"
    assert curve["dtype"] == "int8" and curve["bundle"] == bundle
    assert [r["ndoc"] for r in curve["curve"]] == list(SIZES)
    for row in curve["curve"]:
        line = lines[f"size_{row['ndoc']}_int8"]
        assert line["pipeline"] == "trained"
        for k in JAX_KEEP:
            assert row[k] == line[k], k
        assert row["secs"] > 0
        with open(osp.join(side, f"size_{row['ndoc']}_int8.json")) as fr:
            assert json.load(fr) == row


def test_rerun_resumes_without_a_child(first_run, bundle):
    side, curve, _ = first_run

    def no_child(*a, **k):
        raise AssertionError("a child ran")
    with mock.patch.object(subprocess, "run", no_child):
        again, lines = sc.run(SIZES, "int8", "cpu", ckpt=bundle,
                              side_dir=side)
    assert again == curve and lines == {}


def test_fresh_and_cap_sweep_run_children(first_run, bundle, tmp_path):
    """``fresh`` measures every size again; a cap sweep adds the largest
    size at each cap, with ``--cap`` passed to its child."""
    import shutil
    side = str(tmp_path / "side")
    shutil.copytree(first_run[0], side)
    seen = []

    def child(ndoc, dtype, device, ckpt, extra, timeout):
        seen.append((ndoc, tuple(extra)))
        return {"ndoc": ndoc, "cap": 32, "corpus_dtype": dtype}
    with mock.patch.object(sc, "run_child", child):
        curve, lines = sc.run(SIZES, "int8", "cpu", ckpt=bundle,
                              side_dir=side, caps=(32,), fresh=True)
    assert seen == [(300, ()), (400, ()), (400, ("--cap", "32"))]
    assert sorted(lines) == ["size_300_int8", "size_400_int8",
                             "size_400_int8_cap32"]
    assert len(curve["curve"]) == 3


def test_failing_child_exits_naming_the_size(bundle, tmp_path):
    def failed(cmd, **k):
        return subprocess.CompletedProcess(cmd, 1, stdout=b"")
    with mock.patch.object(subprocess, "run", failed):
        with pytest.raises(SystemExit, match="ndoc=300"):
            sc.run(SIZES, "int8", "cpu", ckpt=bundle,
                   side_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_timed_out_child_exits_naming_the_size(bundle, tmp_path):
    def slow(cmd, **k):
        raise subprocess.TimeoutExpired(cmd, k.get("timeout"))
    with mock.patch.object(subprocess, "run", slow):
        with pytest.raises(SystemExit, match="size 300: bench child timed"):
            sc.run(SIZES, "int8", "cpu", ckpt=bundle, side_dir=str(tmp_path),
                   timeout=1)


def test_main_writes_the_curve(first_run, bundle, tmp_path, capsys):
    side, curve, _ = first_run
    out = tmp_path / "curve.json"
    env = {"SC_SIZES": ",".join(map(str, SIZES)), "SC_STAGE_DIR": side,
           "SC_OUT": str(out), "BENCH_CKPT": bundle}
    with mock.patch.dict(os.environ, env):
        got = sc.main(["--device", "cpu"])
    assert got == curve
    assert json.loads(out.read_text()) == curve
    assert json.loads(capsys.readouterr().out.strip()) == curve


def test_defaults_stay_under_build():
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    assert sc.BUILD_DIR == osp.join(repo, "build")
    with open(osp.join(repo, ".gitignore")) as fr:
        assert "/build/" in fr.read().split()
