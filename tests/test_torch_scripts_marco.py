"""The port's MS MARCO pipeline script (``mevi_tpu_torch/scripts/
marco_pipeline.sh``) on the CPU at tiny widths: its ``all`` stages,
prepare -> index -> train -> eval -> ann -> ensemble, over MS MARCO's
raw layouts from ``chip_smoke.py``'s phase-8 maker and a seeded HF
``T5Model`` as ``t5-ance.pt``, with ``DEVICE_FLAGS=--device cpu`` and
``TOKENIZER_FLAGS=--allow_hash_tokenizer`` (no HF tokenizer files here).

``prepare``'s files are held byte for byte against the JAX CLI's
``prepare`` on the same raw files, the eval report's recall and MRR
against ``evaluate``'s over the fine tsv the run wrote (to 1e-12), and
the ``ann`` and ``ensemble`` files are read back."""

import json

import numpy as np
import pytest
import torch

from test_torch_scripts_nqdpr import chip_smoke, run_stage, script_env
from mevi_tpu.cli.main import main as jmain
from mevi_tpu_torch.data import io
from mevi_tpu_torch.eval.metrics import evaluate_ranks

transformers = pytest.importorskip("transformers")

TINY = dict(chip_smoke.PIPE8, passages=300, words=12, vocab_words=600,
            train_queries=64, dev_queries=40, query_words=4)
CFG = {
    "dataset": "marco", "ckpt_dir": "ckpts",
    "rq": {"pq_type": "rq", "subvector_num": 2, "subvector_bits": 3,
           "dist_mode": "l2", "emb_size": 32},
    "model": {"num_layers": 1, "num_decoder_layers": 1, "d_model": 32,
              "d_kv": 8, "d_ff": 64, "num_heads": 4, "adaptor_layer_num": 1,
              "adaptor_num_heads": 4, "dropout_rate": 0.0},
    "encoder": {"family": "t5", "d_model": 32, "num_layers": 1,
                "num_heads": 4, "d_ff": 64},
    "train": {"train_batch_size": 8, "encode_batch_size": 64,
              "num_train_epochs": 1},
    "infer": {"num_return_sequences": 10}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("marco")
    data = work / "marco"
    chip_smoke.synth_marco_text(str(data / "raw"), TINY, 3)
    (data / "ckpts").mkdir()
    torch.manual_seed(5)
    tower = transformers.T5Model(transformers.T5Config(
        vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_heads=4,
        num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
        feed_forward_proj="relu"))
    torch.save(tower.state_dict(), str(data / "ckpts" / "t5-ance.pt"))
    (work / "cfg.json").write_text(json.dumps(CFG))
    env = script_env(work, DATA_DIR=str(data), CFG=str(work / "cfg.json"),
                     TOKENIZER_FLAGS="--allow_hash_tokenizer",
                     DEVICE_FLAGS="--device cpu")
    return work, data, run_stage("marco_pipeline.sh", "all", work, env,
                                 timeout=600)


@pytest.mark.parametrize("name", ["train_mevi.tsv", "dev_mevi_dedup.tsv",
                                  "doc_aug.tsv"])
def test_prepare_writes_the_jax_files(run, name, capsys):
    work, data, _ = run
    ref = work / "jax_origin"
    if not (ref / name).exists():
        jmain(["prepare", "--raw_dir", str(data / "raw"), "--origin_dir",
               str(ref), "--doc_aug"])
        capsys.readouterr()
    got = (data / "origin" / name).read_bytes()
    assert got == (ref / name).read_bytes() and len(got) > 0


def test_eval_report_equals_a_recomputation(run):
    """The eval stage's recall and MRR at every k equal ``evaluate``'s
    semantics over the fine tsv it wrote and the dev ground truth."""
    _, data, r = run
    out = r.stdout
    start = out.index('{\n "ndoc_per_query"')
    report, _ = json.JSONDecoder().raw_decode(out[start:])
    gts = dict(io.read_query_docids_tsv(str(data / "origin" /
                                            "dev_mevi_dedup.tsv")))
    preds, _, _ = io.parse_result_tsv(
        str(data / "ance" / "nci_result_rq45_top10_fine.tsv"),
        {"query": 0, "pred": 2})
    ks = (1, 5, 10, 20, 50, 100, 1000)
    want = evaluate_ranks(gts, preds, ks)
    for m in ("recall", "mrr"):
        for k in ks:
            assert abs(report["fine"][m][str(k)] - want[m][k]) <= 1e-12
    assert report["fine"]["recall"]["1000"] > 0


def test_ann_and_ensemble_read_back(run):
    """``ann`` writes the top-1000 (capped at the corpus) of every dev
    query, scores descending; ``ensemble`` fuses it with the eval tsvs
    into its result file."""
    _, data, _ = run
    preds, scores, _ = io.parse_result_tsv(
        str(data / "ance" / "ann1000.tsv"),
        {"query": 0, "pred": 2, "score": 3})
    assert len(preds) == len(io.read_query_docids_tsv(
        str(data / "origin" / "dev_mevi_dedup.tsv")))
    for q, ids in preds.items():
        assert len(ids) == len(set(ids)) == min(1000, TINY["passages"])
        assert np.all(np.diff(scores[q]) <= 0)
    text = (data / "ance" / "ensemble_result.txt").read_text()
    assert text.strip()
