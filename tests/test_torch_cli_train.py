"""The port's ``train`` command on the CPU at a tiny config: it runs,
writes its tags and leaderboard, ``--resume`` continues from the next
epoch, the dev probe's hit@10 ranks the checkpoints, and the loss falls;
the JAX package's ``train`` runs on the same files with the same flags."""

import json
import os.path as osp

import numpy as np
import pytest

from mevi_tpu_torch.cli.main import main
from mevi_tpu_torch.config import (EncoderConfig, MEVIConfig, ModelConfig,
                                   RQConfig, TrainConfig)
from mevi_tpu_torch.data import io

KARY, M, D = 4, 2, 32
NQ, NDOC, LQ = 32, 24, 8


def write_config(path, ckpt_dir, dropout=0.1, epochs=3):
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=M, subvector_bits=2, emb_size=D),
        model=ModelConfig(num_layers=2, num_decoder_layers=2, d_model=D,
                          d_kv=8, d_ff=64, num_heads=4, adaptor_layer_num=1,
                          adaptor_num_heads=4, dropout_rate=dropout,
                          vocab_size=64),
        encoder=EncoderConfig(family="t5", d_model=D, num_layers=1,
                              num_heads=4, d_ff=64),
        train=TrainConfig(train_batch_size=8, num_train_epochs=epochs,
                          warmup_steps=0, learning_rate=3e-3,
                          decoder_learning_rate=3e-3),
        ckpt_dir=ckpt_dir)
    cfg.finalize()
    with open(path, "w") as fw:
        fw.write(cfg.to_json())


@pytest.fixture()
def workdir(tmp_path):
    rng = np.random.default_rng(0)
    # a learnable query language: the first token names the document
    docs = rng.integers(0, NDOC, NQ)
    qids = rng.integers(30, 60, (NQ, LQ)).astype(np.int64)
    qids[:, 0] = 2 + docs
    io.write_token_memmaps(str(tmp_path / "q"), qids,
                           np.ones((NQ, LQ), np.int64))
    io.write_query_docids_tsv(str(tmp_path / "train.tsv"),
                              [(f"q{i}", [int(d)]) for i, d in
                               enumerate(docs)])
    codes = rng.integers(0, KARY, (NDOC, M)).astype(np.int32)
    np.save(str(tmp_path / "codes.npy"), codes)
    np.save(str(tmp_path / "dev_q.npy"), qids[:16].astype(np.int32))
    np.save(str(tmp_path / "dev_codes.npy"), codes[docs[:16]])
    write_config(str(tmp_path / "cfg.json"), str(tmp_path / "ckpts"))
    return tmp_path


def args(w, *extra, cfg="cfg.json"):
    return ["train", "--config", str(w / cfg), "--queries", str(w / "q"),
            "--query_length", str(LQ), "--codes", str(w / "codes.npy"),
            "--train_tsv", str(w / "train.tsv"), *extra]


def board(w, ckpts="ckpts"):
    d = w / ckpts / "nci"
    with open(d / "leaderboard.json") as fr, \
            open(d / "leaderboard.meta.json") as fm:
        return json.load(fr), json.load(fm)


def test_train_writes_tags_and_resumes(workdir, capsys):
    state = main(args(workdir, "--device", "cpu", "--max_epochs", "1"))
    out = capsys.readouterr().out
    assert "epoch 0: loss" in out
    assert state.step == NQ // 8
    tags, meta = board(workdir)
    assert set(tags) == {"epoch0"} and meta == {"monitor": "loss",
                                               "mode": "min"}
    assert osp.exists(workdir / "ckpts" / "nci" / "epoch0" / "state.pt")
    state = main(args(workdir, "--device", "cpu", "--max_epochs", "2",
                      "--resume", "best"))
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "epoch 1: loss" in out
    assert "epoch 0:" not in out
    assert state.step == 2 * (NQ // 8)
    assert set(board(workdir)[0]) == {"epoch0", "epoch1"}


def test_dev_probe_ranks_checkpoints_and_loss_falls(workdir, capsys):
    main(args(workdir, "--device", "cpu", "--log_every", "1",
              "--log_dir", str(workdir / "logs"),
              "--dev_queries", str(workdir / "dev_q.npy"),
              "--dev_codes", str(workdir / "dev_codes.npy"),
              "--dev_batch", "8"))
    out = capsys.readouterr().out
    hits = [float(ln.rsplit(" ", 1)[1]) for ln in out.splitlines()
            if "dev coarse hit@10" in ln]
    assert len(hits) == 3 and all(0.0 <= h <= 1.0 for h in hits)
    tags, meta = board(workdir)
    assert meta == {"monitor": "dev_hit10", "mode": "max"}
    assert len(tags) == 2                                  # keep=2
    assert sorted(tags.values()) == sorted(hits)[1:]
    from mevi_tpu_torch.train.checkpoints import CheckpointManager
    best = CheckpointManager.from_dir(str(workdir / "ckpts" / "nci"))
    assert tags[best.best_tag()] == max(hits)
    logs = list((workdir / "logs").glob("*_metrics.jsonl"))
    recs = [json.loads(ln) for ln in logs[0].read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 3 * (NQ // 8)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_jax_train_takes_the_same_files(workdir, capsys):
    from mevi_tpu.cli.main import main as jax_main
    write_config(str(workdir / "cfg_jax.json"), str(workdir / "ckpts_jax"),
                 dropout=0.0, epochs=1)
    jax_main(args(workdir, "--max_epochs", "1", cfg="cfg_jax.json"))
    assert "epoch 0: loss" in capsys.readouterr().out
    assert set(board(workdir, "ckpts_jax")[0]) == {"epoch0"}
