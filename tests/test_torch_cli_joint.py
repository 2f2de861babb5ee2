"""The port's ``train-joint`` and ``doc2query`` commands on the CPU at a
tiny config, held on their own terms (the initial weights and the sample
streams come from torch generators, not the JAX package's): mirrors of
``tests/test_cli_train_joint.py`` and
``tests/test_generate.py::test_doc2query_repair_loop``, plus the
RQ-refit validation, a bit-for-bit resume and seeded generation."""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from mevi_tpu_torch.cli.main import main
from mevi_tpu_torch.config import (EncoderConfig, InferConfig, MEVIConfig,
                                   ModelConfig, RQConfig, TrainConfig)
from mevi_tpu_torch.data import io
from mevi_tpu_torch.train.checkpoints import restore_tree_host

transformers = pytest.importorskip("transformers")

KARY, M, D = 4, 2, 32


@pytest.fixture(autouse=True)
def no_hf_download(monkeypatch):
    """No HF tokenizer files here: ``from_pretrained`` fails at once (no
    download attempt), so ``--allow_hash_tokenizer`` takes the stub."""
    def offline(*a, **k):
        raise OSError("no HF tokenizer files (offline test)")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        offline)


@pytest.fixture()
def workdir(tmp_path):
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=M, subvector_bits=2, emb_size=D),
        model=ModelConfig(num_layers=1, num_decoder_layers=1, d_model=D,
                          d_kv=8, d_ff=64, num_heads=4, adaptor_layer_num=1,
                          adaptor_num_heads=4, dropout_rate=0.0),
        encoder=EncoderConfig(family="t5", d_model=D, num_layers=1,
                              num_heads=4, d_ff=64),
        train=TrainConfig(train_batch_size=4, num_train_epochs=2,
                          gradient_accumulation=2, co_neg_num=2,
                          warmup_steps=0, learning_rate=1e-3,
                          decoder_learning_rate=1e-3,
                          docenc_learning_rate=1e-3, encode_batch_size=8,
                          eval_batch_size=4),
        infer=InferConfig(num_return_sequences=3, recall_num=(1, 5),
                          max_cluster_docs=32),
        ckpt_dir=str(tmp_path / "ckpts"))
    cfg.finalize()
    cfgp = str(tmp_path / "cfg.json")
    with open(cfgp, "w") as fw:
        fw.write(cfg.to_json())
    rng = np.random.default_rng(0)
    nq, ndoc, lq, ld = 16, 24, 8, 12
    io.write_token_memmaps(str(tmp_path / "q"),
                           rng.integers(2, 60, (nq, lq)).astype(np.int64),
                           np.ones((nq, lq), np.int64))
    io.write_token_memmaps(str(tmp_path / "d"),
                           rng.integers(2, 60, (ndoc, ld)).astype(np.int64),
                           np.ones((ndoc, ld), np.int64))
    io.write_query_docids_tsv(
        str(tmp_path / "train.tsv"),
        [(f"q{i}", [int(rng.integers(0, ndoc))]) for i in range(nq)])
    io.write_query_docids_tsv(str(tmp_path / "dev.tsv"),
                              [(f"w{i} w{i + 1}", [i]) for i in range(6)])
    np.save(str(tmp_path / "codes.npy"),
            rng.integers(0, KARY, (ndoc, M)).astype(np.int32))
    np.save(str(tmp_path / "cbs.npy"),
            rng.normal(size=(M, KARY, D)).astype(np.float32))
    return dict(tmp=tmp_path, cfgp=cfgp, lq=lq, ld=ld)


def base_args(w):
    return ["train-joint", "--config", w["cfgp"],
            "--queries", str(w["tmp"] / "q"), "--query_length", str(w["lq"]),
            "--train_tsv", str(w["tmp"] / "train.tsv"),
            "--documents", str(w["tmp"] / "d"), "--doc_length", str(w["ld"]),
            "--codes", str(w["tmp"] / "codes.npy"),
            "--codebooks", str(w["tmp"] / "cbs.npy"), "--device", "cpu"]


def board(w):
    with open(osp.join(str(w["tmp"] / "ckpts"), "joint",
                       "leaderboard.json")) as fr:
        return json.load(fr)


def test_train_joint_runs_and_checkpoints(workdir, capsys):
    tl = main(base_args(workdir) + ["--max_epochs", "2"])
    out = capsys.readouterr().out
    assert "done: step 8" in out           # 2 epochs x 4 micro-batches
    assert "epoch1" in board(workdir)
    assert tl.state.optimizer.count == 4    # accumulation 2


def test_train_joint_resume_bit_for_bit(workdir, capsys):
    first = main(base_args(workdir) + ["--max_epochs", "1"])
    capsys.readouterr()
    again = main(base_args(workdir) + ["--max_epochs", "1", "--resume",
                                       "best"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "done: step 4" in out
    for k, v in first.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k
    cont = main(base_args(workdir) + ["--max_epochs", "2", "--resume",
                                      "best"])
    assert "done: step 8" in capsys.readouterr().out
    assert cont.state.step == 8


def test_train_joint_ema_alt_remat(workdir, capsys):
    tl = main(base_args(workdir) + ["--max_epochs", "2", "--pq_update",
                                    "ema", "--alt_epochs", "1,2",
                                    "--remat"])
    assert "done: step" in capsys.readouterr().out
    assert tl.nci_model.dims.t5.remat
    cbs0 = np.load(str(workdir["tmp"] / "cbs.npy"))
    # the EMA moved the codebooks, which the optimizer does not step
    assert not np.allclose(tl.state.model.codebooks.detach().numpy(), cbs0)


def test_train_joint_fix_flags(workdir):
    """fixdocenc: the tower does not move; the codebooks (grad mode,
    not fixpq) do."""
    with open(workdir["cfgp"]) as fr:
        raw = json.load(fr)
    raw["train"]["fixdocenc"] = True
    raw["train"]["gradient_accumulation"] = 1
    with open(workdir["cfgp"], "w") as fw:
        json.dump(raw, fw)
    from mevi_tpu_torch.cli.main import load_config
    from mevi_tpu_torch.models.twin_tower import tower_from_config
    from mevi_tpu_torch.weights import init_random_
    cfg = load_config(workdir["cfgp"])
    tower0 = init_random_(tower_from_config(cfg.encoder, device="cpu")
                          .module, cfg.train.seed + 1).state_dict()
    main(base_args(workdir) + ["--max_epochs", "1"])
    sd = restore_tree_host(str(workdir["tmp"] / "ckpts" / "joint" /
                               "epoch0"))["model"]
    for k, v in tower0.items():
        assert torch.equal(sd[f"tower.{k}"], v), k
    assert not np.allclose(sd["codebooks"].numpy(),
                           np.load(str(workdir["tmp"] / "cbs.npy")))


def test_train_joint_refit_validation(workdir, capsys):
    """--dev_tsv: each validation re-embeds the corpus with the live
    tower, refits RQ aligned to --codebooks, evaluates, and ranks the
    checkpoints on the monitored recall."""
    tl = main(base_args(workdir) + ["--max_epochs", "1", "--dev_tsv",
                                    str(workdir["tmp"] / "dev.tsv"),
                                    "--monitor", "recall5",
                                    "--allow_hash_tokenizer"])
    capsys.readouterr()
    st = tl.refit_stats
    assert {"embed_s", "refit_s", "align_s", "csr_s", "unchanged_aligned",
            "unchanged_unaligned"} <= set(st)
    assert tl.doc_codes.shape == (24, M)
    assert set(tl.last_validation) >= {"recall1", "recall5", "mrr5",
                                       "coarse_recall1", "ndoc"}
    assert board(workdir)["epoch0"] == tl.last_validation["recall5"]


# ---------------------------------------------------------------------------
# doc2query
# ---------------------------------------------------------------------------

@pytest.fixture()
def qg_ckpt(tmp_path):
    torch.manual_seed(0)
    hf = transformers.T5Model(transformers.T5Config(
        vocab_size=32128, d_model=16, d_kv=4, d_ff=32, num_heads=4,
        num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
        feed_forward_proj="relu")).eval()
    path = str(tmp_path / "qg.pt")
    torch.save(hf.state_dict(), path)
    corpus = tmp_path / "corpus.tsv"
    corpus.write_text("0\tT0\tsome passage text here\n"
                      "1\tT1\tanother different passage\n"
                      "2\tT2\ta third one\n")
    return path, str(corpus)


D2Q = ["--n_gen_query", "2", "--num_layers", "1", "--d_model", "16",
       "--d_kv", "4", "--d_ff", "32", "--num_heads", "4", "--batch", "2",
       "--query_max_len", "4", "--doc_max_len", "8",
       "--allow_hash_tokenizer", "--device", "cpu"]


def test_doc2query_generates_seeded_rows(qg_ckpt, tmp_path):
    ck, corpus = qg_ckpt
    outs = []
    for i in range(2):
        out = str(tmp_path / f"qg{i}.tsv")
        main(["doc2query", "--checkpoint", ck, "--corpus", corpus,
              "--output", out, "--seed", "3"] + D2Q)
        outs.append(open(out).read())
    assert outs[0] == outs[1]                      # seeded
    rows = [ln.split("\t") for ln in outs[0].strip().split("\n")]
    assert [int(d) for _, d in rows] == [0, 0, 1, 1, 2, 2]
    assert all(q.startswith("t") for q, _ in rows)  # HashTokenizer words


def test_doc2query_repair_loop(qg_ckpt, tmp_path):
    """--repair regenerates queries for docs with empty / duplicate rows
    (complement_qg10.py semantics)."""
    ck, corpus = qg_ckpt
    qg = tmp_path / "qg.tsv"
    qg.write_text("good q one\t0\nsecond q\t0\n"
                  "dup\t1\ndup\t1\n   \t1\nx\t2\ny\t2\n")
    out = str(tmp_path / "qg_fixed.tsv")
    main(["doc2query", "--checkpoint", ck, "--corpus", corpus,
          "--output", out, "--repair", str(qg), "--repair_rounds", "2"]
         + D2Q)
    per_doc = {}
    for line in open(out).read().strip().split("\n"):
        q, d = line.split("\t")
        per_doc.setdefault(int(d), []).append(q)
    assert per_doc[0] == ["good q one", "second q"]
    assert per_doc[2] == ["x", "y"]
    assert per_doc[1][0] == "dup" and len(per_doc[1]) >= 2
    assert all(q.strip() for qs in per_doc.values() for q in qs)
