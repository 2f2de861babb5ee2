"""The port's NQ-DPR pipeline script (``mevi_tpu_torch/scripts/
nqdpr_pipeline.sh``) on the CPU at tiny widths, stage by stage, as
``chip_smoke.py``'s phase 12a runs it on the card (its raw-file maker,
AR2 checkpoint and report recomputation are the ones used here).

``prepare`` and ``answers`` must write ``origin/corpus.tsv``,
``train_mevi.tsv`` and the inverse answer arrays byte for byte as the
JAX package's ``nq_corpus_rows`` / ``nq_biencoder_pairs`` /
``build_answer_arrays`` give them, called as ``scripts/
nqdpr_pipeline.sh:17-50`` calls them (there ``eval(ans)``; the port's
script reads the same list literals with ``ast.literal_eval``).  Then
``index`` -> ``train`` -> ``eval`` with ``DEVICE_FLAGS=--device cpu``
and ``TOKENIZER_FLAGS=--allow_hash_tokenizer`` (no HF tokenizer files
here), ending in a report whose hits equal a recomputation from the
written files: exactly, to 1e-12."""

import csv
import json
import os
import os.path as osp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# the raw files: phase 12a's maker at a tiny scale, plus a quoted
# passage and a curly apostrophe, which both packages must read alike;
# answers may hold common words, so that many passages answer and the
# recomputed hit ranks are not all -1
TINY = dict(chip_smoke.NQ12, passages=150, words=30, vocab_words=400,
            common_words=0, train_items=48, test_questions=24,
            question_words=6)
CFG = {
    "dataset": "nq_dpr", "ckpt_dir": "ckpts",
    "rq": {"pq_type": "rq", "subvector_num": 2, "subvector_bits": 4,
           "dist_mode": "l2", "emb_size": 32},
    "model": {"num_layers": 1, "num_decoder_layers": 1, "d_model": 32,
              "d_kv": 8, "d_ff": 64, "num_heads": 4, "adaptor_layer_num": 1,
              "adaptor_num_heads": 4, "dropout_rate": 0.0},
    "encoder": {"family": "bert", "d_model": 32, "num_layers": 2,
                "num_heads": 4, "d_ff": 64, "vocab_size": 30522,
                "type_vocab_size": 4, "query_length": 32, "doc_length": 128},
    "train": {"train_batch_size": 8, "encode_batch_size": 32,
              "num_train_epochs": 1},
    "infer": {"num_return_sequences": 10}}


def script_env(work, **flags):
    """The environment a script stage runs in: ``python`` on PATH is this
    interpreter, the checkout importable, two threads, the script's
    variables, and no ``transformers`` (as on the card: the tokenizer
    falls back to the hash stub at once, and nothing reaches the HF
    hub)."""
    bindir = work / "bin"
    bindir.mkdir(exist_ok=True)
    shim = bindir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    hidden = work / "no_transformers" / "transformers"
    hidden.mkdir(parents=True, exist_ok=True)
    (hidden / "__init__.py").write_text(
        'raise ImportError("no transformers in this environment")\n')
    env = dict(os.environ, HF_HUB_OFFLINE="1", **flags)
    env["PATH"] = os.pathsep.join([str(bindir), env.get("PATH", "")])
    env["PYTHONPATH"] = os.pathsep.join(
        [str(hidden.parent), str(ROOT)]
        + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env[k] = "2"
    return env


def run_stage(script, stage, work, env, timeout=300):
    r = subprocess.run(["bash", str(ROOT / "mevi_tpu_torch" / "scripts"
                                    / script), stage], cwd=work, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"{script} {stage}: {r.stderr[-3000:]}"
    return r


def write_raw(raw, seed):
    chip_smoke.synth_nq_raw(str(raw), TINY, seed)
    with open(raw / "psgs_w100.tsv", "a") as fw:
        fw.write(f'{TINY["passages"] + 1}\t"said ""w1 w2"" then"\t'
                 'Quoted\n')
    items = json.loads((raw / "biencoder-nq-train.json").read_text())
    items[0]["question"] += " it’s"
    (raw / "biencoder-nq-train.json").write_text(json.dumps(items))
    lines = (raw / "nq-test.qa.csv").read_text().splitlines()
    q, ans = lines[0].split("\t")
    lines[0] = f"{q} it’s\t{ans}"
    (raw / "nq-test.qa.csv").write_text("\n".join(lines) + "\n")


def write_ar2_pkl(path, enc, seed):
    """AR2's layout from the port's towers under chip_smoke's spelled-out
    HF ``BertModel`` names."""
    from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
    dims = BertDims(vocab_size=enc["vocab_size"], d_model=enc["d_model"],
                    num_layers=enc["num_layers"], num_heads=enc["num_heads"],
                    d_ff=enc["d_ff"],
                    type_vocab_size=enc["type_vocab_size"],
                    dropout_rate=0.0)
    sd = {}
    for i, prefix in enumerate(("ctx_model.", "question_model.")):
        m = chip_smoke.hf_bert_init_(BertEncoderModel(dims, device="cpu"),
                                     seed + i)
        sd.update({prefix + k: v for k, v in
                   chip_smoke.hf_bert_state_dict(m, seed + 10 + i).items()})
    torch.save({"model_dict": sd, "epoch": 0}, path)
    return sd


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("nqdpr")
    data = work / "nq"
    write_raw(data / "raw", 7)
    (data / "ckpts").mkdir()
    write_ar2_pkl(data / "ckpts" / "ar2_nq.pkl", CFG["encoder"], 11)
    (work / "cfg.json").write_text(json.dumps(CFG))
    env = script_env(work, DATA_DIR=str(data), CFG=str(work / "cfg.json"),
                     TOKENIZER_FLAGS="--allow_hash_tokenizer",
                     DEVICE_FLAGS="--device cpu")
    out = {s: run_stage("nqdpr_pipeline.sh", s, work, env)
           for s in ("prepare", "answers", "index", "train", "eval")}
    return work, data, out


def jax_reference(data, ref):
    """What ``scripts/nqdpr_pipeline.sh``'s prepare and answers heredocs
    write, through the JAX package's functions."""
    from mevi_tpu.data import io as jio, prepare as jP
    ref.mkdir(exist_ok=True)
    rows = list(jP.nq_corpus_rows(str(data / "raw" / "psgs_w100.tsv")))
    with open(ref / "corpus.tsv", "w") as fw:
        for did, title, text in rows:
            fw.write(f"{did}\t{title}\t{text}\n")
    pairs = jP.nq_biencoder_pairs(str(data / "raw" /
                                      "biencoder-nq-train.json"))
    jio.write_query_docids_tsv(str(ref / "train_mevi.tsv"),
                               [(q, [d]) for q, d in pairs])
    passages = []
    with open(ref / "corpus.tsv") as fr:
        for line in fr:
            _, title, text = (line.rstrip("\n").split("\t") + ["", ""])[:3]
            passages.append(f"{title} {text}")
    answers = []
    with open(data / "raw" / "nq-test.qa.csv") as fr:
        for q, ans in csv.reader(fr, delimiter="\t"):
            answers.append(eval(ans))      # as the JAX script reads them
    offsets, array = jP.build_answer_arrays(passages, answers)
    offsets.tofile(str(ref / "test_inverse_offsets.bin"))
    array.tofile(str(ref / "test_inverse_array.bin"))


@pytest.mark.parametrize("name", ["corpus.tsv", "train_mevi.tsv",
                                  "test_inverse_offsets.bin",
                                  "test_inverse_array.bin"])
def test_prepare_and_answers_write_the_jax_files(run, name):
    work, data, _ = run
    ref = work / "jax_origin"
    if not (ref / name).exists():
        jax_reference(data, ref)
    got = (data / "origin" / name).read_bytes()
    assert got == (ref / name).read_bytes()
    assert len(got) > 0


def test_corpus_tokens_fit_the_bert_table(run):
    from mevi_tpu_torch.data import io
    _, data, _ = run
    tok, mask = io.open_token_memmaps(str(data / "ar2" / "all_document"),
                                      128)
    assert tok.shape == (TINY["passages"] + 1, 128)
    assert 0 <= int(np.asarray(tok).min()) and \
        int(np.asarray(tok).max()) < CFG["encoder"]["vocab_size"]
    assert (np.asarray(mask).sum(1) > 0).all()


def test_eval_report_equals_a_recomputation(run):
    """The eval stage (``--nci_ckpt ckpts/nci/best``, the leaderboard's
    best tag of ``train``) prints a report whose every hit rate, recall
    and MRR equals one recomputed from the result tsvs, ``rq_codes.npy``
    and the inverse arrays; on the CPU no kernel launches."""
    _, data, out = run
    report = json.loads(out["eval"].stdout[out["eval"].stdout.index("{"):])
    codes = np.load(data / "ar2" / "index" / "rq_codes.npy")
    inv_off = np.fromfile(data / "origin" / "test_inverse_offsets.bin",
                          np.int64)
    inv_arr = np.fromfile(data / "origin" / "test_inverse_array.bin",
                          np.int32)
    want = chip_smoke.nq_report_recomputed(
        str(data / "ar2" / "nci_result_rq45_top10"), codes, inv_off,
        inv_arr, (1, 5, 10, 20, 50, 100, 1000), 10)
    chip_smoke.reports_equal("cpu", report, want)
    assert report["fine"]["hitrate"]["1000"] > 0
    assert '{"bucket_launches": {"v3": 0}}' in out["eval"].stderr
    with open(data / "ar2" / "nci_result_rq45_top10_fine.tsv") as fr:
        assert sum(1 for _ in fr) == TINY["test_questions"]


def test_hf_bert_names_are_transformers_names():
    """chip_smoke spells HF ``BertModel``'s names out (no transformers on
    the card): they are the library's, and the converter reads them
    back into the port's tower exactly."""
    transformers = pytest.importorskip("transformers")
    from mevi_tpu_torch.models import convert
    from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
    dims = BertDims(vocab_size=100, d_model=16, num_layers=2, num_heads=2,
                    d_ff=32, type_vocab_size=4, dropout_rate=0.0)
    m = chip_smoke.hf_bert_init_(BertEncoderModel(dims, device="cpu"), 3)
    sd = chip_smoke.hf_bert_state_dict(m, 4)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=100, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32, type_vocab_size=4))
    want = {k: v.shape for k, v in hf.state_dict().items()
            if not k.endswith(("position_ids", "token_type_ids"))}
    assert {k: v.shape for k, v in sd.items()} == want
    back = convert.convert_bert_model(sd, 2)
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    assert set(back) == set(m.state_dict())
    # HF's initialization: the padding row zero, LayerNorm 1 / 0
    assert not m.embeddings.word.weight[0].any()
    assert torch.equal(m.layers[0].ff_norm.weight,
                       torch.ones_like(m.layers[0].ff_norm.weight))
    assert abs(float(m.layers[1].ff_out.weight.std()) - 0.02) < 0.005
