"""Port parity: the ``evaluate`` and ``ensemble`` commands of
``mevi_tpu_torch.cli.main`` against ``mevi_tpu.cli.main`` on the
fixtures of tests/test_cli.py: the same printed lines and the same
output files."""

import pickle

import numpy as np
import pytest

from mevi_tpu.cli.main import main as jmain
from mevi_tpu_torch.cli.main import main as tmain
from mevi_tpu_torch.data import io


def run_both(capsys, tmp_path, argv, ofile=None):
    outs = []
    for tag, fn in (("jax", jmain), ("torch", tmain)):
        extra = ["--ofile", str(tmp_path / f"{tag}_{ofile}")] if ofile \
            else []
        fn(argv + extra)
        text = capsys.readouterr().out
        if ofile:
            with open(tmp_path / f"{tag}_{ofile}") as fr:
                text += "\n--file--\n" + fr.read()
        outs.append(text)
    assert outs[1] == outs[0]
    return outs[1]


@pytest.fixture()
def eval_files(tmp_path):
    gt = str(tmp_path / "gt.tsv")
    io.write_query_docids_tsv(gt, [("q1", [3]), ("q2", [7]), ("q3", [1, 2])])
    ranks = str(tmp_path / "ranks.tsv")
    with open(ranks, "w") as fw:
        fw.write("q1\t\t[3, 5]\t[0.9, 0.1]\n")
        fw.write("q2\t\t[5, 3]\t[0.9, 0.1]\n")
        fw.write("q3\t\t[2, 9, 1]\t[0.5, 0.4, 0.3]\n")
    return gt, ranks


@pytest.mark.parametrize("extra", [
    ["--pred_col", "2", "--recall_num", "1,2"],
    ["--pred_col", "2"],
    ["--pred_col", "3", "--recall_num", "1,3"],
])
@pytest.mark.parametrize("ofile", [None, "m.json"])
def test_evaluate_same_output(tmp_path, capsys, eval_files, extra, ofile):
    gt, ranks = eval_files
    out = run_both(capsys, tmp_path,
                   ["evaluate", "--gt_file", gt, "--ranks_file", ranks]
                   + extra, ofile)
    assert out.startswith("RECALL")


@pytest.fixture()
def ensemble_files(tmp_path):
    gt = str(tmp_path / "gt.tsv")
    io.write_query_docids_tsv(gt, [("q1", [0]), ("q2", [2])])
    ance = str(tmp_path / "ance.tsv")
    with open(ance, "w") as fw:
        fw.write("q1\t\t[0, 1, 2]\t[0.9, 0.8, 0.1]\n")
        fw.write("q2\t\t[1, 2, 0]\t[0.7, 0.6, 0.5]\n")
    coarse = str(tmp_path / "coarse.tsv")
    io.write_coarse_results(coarse, [
        ("q1", [[0, 0], [1, 1]], [0], [0.5, 0.3]),
        ("q2", [[1, 0], [0, 0]], [2], [0.6, 0.2])])
    fine = str(tmp_path / "fine.tsv")
    io.write_hardneg_results(fine, [("q1", [0.5], [1, 0], [0.4, 0.3]),
                                    ("q2", [0.1], [2, 1], [0.9, 0.2])])
    codes = np.array([[0, 0], [1, 1], [1, 0]], np.int32)
    npy = str(tmp_path / "codes.npy")
    np.save(npy, codes)
    pkl = str(tmp_path / "codes.pkl")
    with open(pkl, "wb") as fw:
        pickle.dump({i: tuple(c.tolist()) for i, c in enumerate(codes)}, fw)
    return dict(gt=gt, ance=ance, coarse=coarse, fine=fine, npy=npy,
                pkl=pkl)


@pytest.mark.parametrize("mapping", ["npy", "pkl"])
@pytest.mark.parametrize("extra", [
    ["--recall_num", "1,2"],
    ["--recall_num", "1,2,3", "--alphas", "0.2,0.6", "--betas", "0,0.5",
     "--gammas", "0.02,1.0"],
    ["--fine", "--recall_num", "1,3", "--gammas", "0.0,0.3"],
])
def test_ensemble_same_output(tmp_path, capsys, ensemble_files, mapping,
                              extra):
    f = ensemble_files
    argv = ["ensemble", "--gt_file", f["gt"], "--ance_file", f["ance"],
            "--coarse_file", f["coarse"], "--mapping_file", f[mapping]]
    if extra[0] == "--fine":
        argv += ["--fine_file", f["fine"]]
        extra = extra[1:]
    out = run_both(capsys, tmp_path, argv + extra, "ens.txt")
    assert out.startswith("alpha=")
