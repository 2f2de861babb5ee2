"""The port's ``gen-embeddings`` and ``eval`` commands against the JAX
package's on the same input files (a tiny config, ``--device cpu``):
the same printed lines and JSON report, the same result tsvs.  The
towers are one HF ``T5Model`` checkpoint; the NCI is given to both CLIs
as the same reference-layout Lightning ``.pt``.

Tolerances: embeddings 2e-5 (the JAX package's f32 parity tolerance;
two float32 T5 forwards are not bitwise equal, so the embedding file is
held to that tolerance, its shape and size exactly); beam scores in the
coarse tsv and tower scores in the hard-negative tsv 2e-5 plus 1e-6 of
the row's largest |score| (int8 rows reach 127, so those scores reach
~10^2-10^3 and float32 sums cancel at that scale); every rank, id,
count and metric equal.  ``max_cluster_docs`` (cap 4096) exceeds the
largest cluster by far more than 7, so the card's aligned bucket window
truncates nothing."""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from mevi_tpu.cli.main import main as jmain
from mevi_tpu_torch.cli.main import main as tmain
from mevi_tpu_torch.config import (EncoderConfig, MEVIConfig, ModelConfig,
                                   RQConfig)
from mevi_tpu_torch.data import io

transformers = pytest.importorskip("transformers")

D, FF, V, KARY, M = 32, 64, 32128, 4, 2
ADAPT_FF = 2048            # NCIDims.adaptor_d_ff, the reference's default
NDOC, LD = 60, 12


@pytest.fixture(autouse=True)
def no_hf_download(monkeypatch):
    """No HF tokenizer files here: ``from_pretrained`` fails at once (no
    download attempt), so ``--allow_hash_tokenizer`` takes the stub."""
    def offline(*a, **k):
        raise OSError("no HF tokenizer files (offline test)")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        offline)


def reference_nci_file(path, seed=0):
    """A reference Lightning NCI checkpoint ('model.' prefix): HF T5
    encoder/decoder at random init, decode embeddings, the PAWA adaptor
    (torch TransformerDecoder layout) and ``adaptor_linear``."""
    torch.manual_seed(seed)
    hf = transformers.T5Model(transformers.T5Config(
        vocab_size=V, d_model=D, d_kv=8, d_ff=FF, num_heads=4,
        num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
        feed_forward_proj="relu")).state_dict()
    sd = {f"model.{k}": v for k, v in hf.items()}
    g = torch.Generator().manual_seed(seed + 1)
    vdec = KARY * (M + 2) + 2

    def put(name, *shape, scale=0.1):
        sd[f"model.{name}"] = torch.randn(shape, generator=g) * scale
    put("decode_embeddings.weight", vdec, D, scale=1.0)
    put("adaptor_linear.weight", D * vdec, D)
    put("adaptor_embeddings", D, scale=1.0)
    p = "adaptor.layers.0"
    for att in ("self_attn", "multihead_attn"):
        put(f"{p}.{att}.in_proj_weight", 3 * D, D)
        put(f"{p}.{att}.in_proj_bias", 3 * D)
        put(f"{p}.{att}.out_proj.weight", D, D)
        put(f"{p}.{att}.out_proj.bias", D)
    for n in ("norm1", "norm2", "norm3"):
        sd[f"model.{p}.{n}.weight"] = torch.ones(D)
        sd[f"model.{p}.{n}.bias"] = torch.zeros(D)
    put(f"{p}.linear1.weight", ADAPT_FF, D)
    put(f"{p}.linear1.bias", ADAPT_FF)
    put(f"{p}.linear2.weight", D, ADAPT_FF, scale=0.02)
    put(f"{p}.linear2.bias", D)
    torch.save({"state_dict": sd}, path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = tmp_path_factory.mktemp("pipeline")
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=M, subvector_bits=2, emb_size=D),
        model=ModelConfig(num_layers=1, num_decoder_layers=1, d_model=D,
                          d_kv=8, d_ff=FF, num_heads=4, adaptor_layer_num=1,
                          adaptor_num_heads=4, dropout_rate=0.0),
        encoder=EncoderConfig(family="t5", d_model=D, num_layers=1,
                              num_heads=4, d_ff=FF))
    cfg.train.encode_batch_size = 16
    cfg.finalize()
    (w / "cfg.json").write_text(cfg.to_json())
    torch.manual_seed(1)
    tower = transformers.T5Model(transformers.T5Config(
        vocab_size=V, d_model=D, d_kv=8, d_ff=FF, num_heads=4,
        num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
        feed_forward_proj="relu")).eval()
    torch.save(tower.state_dict(), str(w / "tower.pt"))
    reference_nci_file(str(w / "nci.pt"))
    rng = np.random.default_rng(0)
    tok = rng.integers(2, V, (NDOC, LD)).astype(np.int64)
    mask = np.ones_like(tok)
    mask[::3, 8:] = 0
    tok[mask == 0] = 0
    io.write_token_memmaps(str(w / "docs"), tok, mask)
    np.save(str(w / "codes.npy"),
            rng.integers(0, KARY, (NDOC, M)).astype(np.int32))
    io.write_query_docids_tsv(str(w / "dev.tsv"), [
        (f"query number {i} about w{3 * i}", [i, (i + 7) % NDOC])
        for i in range(6)])
    return w


def test_gen_embeddings_same_as_jax(world, capsys):
    w = world
    outs = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        path = str(w / f"emb_{tag}.bin")
        args = ["gen-embeddings", "--config", str(w / "cfg.json"),
                "--checkpoint", str(w / "tower.pt"),
                "--documents", str(w / "docs"), "--doc_length", str(LD),
                "--output", path] + (["--device", "cpu"] if tag == "port"
                                     else [])
        main(args)
        outs[tag] = (capsys.readouterr().out.replace(path, "<out>"),
                     io.open_embedding_memmap(path, D))
    assert outs["port"][0] == outs["jax"][0]
    assert osp.getsize(str(w / "emb_port.bin")) == \
        osp.getsize(str(w / "emb_jax.bin")) == NDOC * D * 4
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], atol=2e-5,
                               rtol=0)


def test_gen_embeddings_profile_table(world, capsys):
    tmain(["gen-embeddings", "--config", str(world / "cfg.json"),
           "--checkpoint", str(world / "tower.pt"),
           "--documents", str(world / "docs"), "--doc_length", str(LD),
           "--output", str(world / "unused.bin"), "--profile",
           "--device", "cpu"])
    lines = capsys.readouterr().err.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        f"bs={b}" for b in (1, 2, 4, 8, 16, 32, 64, 128, 256)]
    assert not osp.exists(str(world / "unused.bin"))


def read_rows(path):
    return [ln.rstrip("\n").split("\t") for ln in open(path)]


def float_lists_close(a, b):
    got, want = np.array(eval(a), float), np.array(eval(b), float)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 + 1e-6 * np.abs(want).max())


@pytest.mark.parametrize("flags", [[], ["--host_stream"],
                                   ["--corpus_int8", "--rank_mode",
                                    "beam_major"]],
                         ids=["device", "host_stream", "int8_beam_major"])
def test_eval_same_as_jax(world, capsys, flags):
    w = world
    emb = np.random.default_rng(5).normal(size=(NDOC, D)).astype(np.float32)
    io.write_embedding_memmap(str(w / "docemb.bin"), emb)
    reports = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        save = str(w / f"res_{tag}.tsv")
        main(["eval", "--config", str(w / "cfg.json"),
              "--nci_ckpt", str(w / "nci.pt"),
              "--tower_ckpt", str(w / "tower.pt"),
              "--embeddings", str(w / "docemb.bin"),
              "--codes", str(w / "codes.npy"), "--dev_tsv", str(w / "dev.tsv"),
              "--num_return_sequences", "3", "--recall_num", "1,5,10",
              "--batch_size", "4", "--save_path", save,
              "--allow_hash_tokenizer"] + flags
             + (["--device", "cpu"] if tag == "port" else []))
        reports[tag] = json.loads(capsys.readouterr().out)
    assert reports["port"] == reports["jax"]
    assert reports["port"]["fine"]["recall"]["10"] > 0
    for part in ("coarse", "fine", "hn"):
        got = read_rows(str(w / f"res_port_{part}.tsv"))
        want = read_rows(str(w / f"res_jax_{part}.tsv"))
        assert len(got) == len(want) == 6
        for g, r in zip(got, want):
            if part == "coarse":       # query, codes, gts, beam scores
                assert g[:3] == r[:3]
                float_lists_close(g[3], r[3])
            elif part == "fine":       # query, ndoc, ids, gts
                assert g == r
            else:                      # query, [], ids, tower scores
                assert g[:3] == r[:3]
                float_lists_close(g[3], r[3])


def test_eval_reads_the_ports_checkpoint_dir(world, capsys, tmp_path):
    """``--nci_ckpt`` as a tag directory of the port's CheckpointManager
    (what ``train`` writes) gives the same report as the file it was
    converted from."""
    from mevi_tpu_torch.cli.main import _load_nci, load_config
    from mevi_tpu_torch.train.checkpoints import CheckpointManager
    w = world
    cfg = load_config(str(w / "cfg.json"))
    model = _load_nci(str(w / "nci.pt"), cfg, torch.device("cpu"))
    CheckpointManager(str(tmp_path / "nci")).save(
        "epoch0", {"model": model.state_dict(), "step": 0, "epoch": 0})
    args = ["eval", "--config", str(w / "cfg.json"),
            "--tower_ckpt", str(w / "tower.pt"),
            "--embeddings", str(w / "docemb.bin"),
            "--codes", str(w / "codes.npy"), "--dev_tsv", str(w / "dev.tsv"),
            "--num_return_sequences", "3", "--recall_num", "1,5,10",
            "--batch_size", "4", "--allow_hash_tokenizer", "--bf16",
            "--device", "cpu"]
    out_file = tmain(args + ["--nci_ckpt", str(w / "nci.pt")])
    out_dir = tmain(args + ["--nci_ckpt", str(tmp_path / "nci" / "epoch0")])
    capsys.readouterr()
    assert out_dir["report"] == out_file["report"]
    # --bf16 reaches the host-streamed corpus too: the same report
    out_hs = tmain(args + ["--nci_ckpt", str(w / "nci.pt"),
                           "--host_stream"])
    assert out_hs["report"] == out_file["report"]
    assert out_hs["evaluator"].fine_index.sorted_emb.dtype == torch.bfloat16


def test_eval_nq_answer_mode_same_as_jax(world, capsys):
    """``--nq_answer_offsets`` / ``--nq_answer_array``: hits through the
    inverse doc -> answering-query arrays; the same report as JAX's."""
    w = world
    emb = np.random.default_rng(5).normal(size=(NDOC, D)).astype(np.float32)
    io.write_embedding_memmap(str(w / "docemb.bin"), emb)
    answers = [[d % 6, (d + 1) % 6] if d < 30 else [] for d in range(NDOC)]
    offsets = np.zeros(NDOC + 1, np.int64)
    np.cumsum([len(a) for a in answers], out=offsets[1:])
    offsets.tofile(str(w / "inv_offsets.bin"))
    np.asarray([q for a in answers for q in a], np.int32).tofile(
        str(w / "inv_array.bin"))
    reports = {}
    for tag, main in (("jax", jmain), ("port", tmain)):
        main(["eval", "--config", str(w / "cfg.json"),
              "--nci_ckpt", str(w / "nci.pt"),
              "--tower_ckpt", str(w / "tower.pt"),
              "--embeddings", str(w / "docemb.bin"),
              "--codes", str(w / "codes.npy"), "--dev_tsv", str(w / "dev.tsv"),
              "--num_return_sequences", "3", "--recall_num", "1,5,10",
              "--batch_size", "4", "--allow_hash_tokenizer",
              "--nq_answer_offsets", str(w / "inv_offsets.bin"),
              "--nq_answer_array", str(w / "inv_array.bin")]
             + (["--device", "cpu"] if tag == "port" else []))
        reports[tag] = json.loads(capsys.readouterr().out)
    assert reports["port"] == reports["jax"]
    assert reports["port"]["fine"]["hitrate"]["10"] > 0
