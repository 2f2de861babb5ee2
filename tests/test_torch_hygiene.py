"""The port stands alone: no file of ``mevi_tpu_torch/`` or
``chip_smoke.py`` imports JAX, flax or the JAX package, and every entry
point runs on the card unless it is given ``device="cpu"``."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "mevi_tpu", "jaxlib", "optax", "orbax")


def _port_sources():
    files = sorted((ROOT / "mevi_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path, source=None):
    tree = ast.parse(path.read_text() if source is None else source,
                     str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def _shell_scripts():
    return sorted((ROOT / "mevi_tpu_torch").rglob("*.sh"))


@pytest.mark.parametrize("path", _shell_scripts(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_shell_scripts(path):
    """A pipeline script of the port runs Python through its heredocs and
    ``python -m``: neither reaches JAX or the JAX package."""
    text = path.read_text()
    bodies = [b for _, b in re.findall(r"<<\s*'?(\w+)'?\n(.*?)\n\1\n",
                                       text, re.S)]
    modules = re.findall(r"python3?\s+(?:-\S+\s+)*-m\s+([\w.]+)", text)
    assert modules, f"{path} runs no module"
    bad = {m.split(".")[0] for m in modules} | {
        r for b in bodies for r in _imported_roots(path, b)}
    assert not bad & set(FORBIDDEN), f"{path} reaches {bad & set(FORBIDDEN)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, mevi_tpu_torch\n"
            "for m in pkgutil.walk_packages(mevi_tpu_torch.__path__,"
            " 'mevi_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry points run on it")


def _entry_points(tmp=None):
    from mevi_tpu_torch.config import InferConfig
    from mevi_tpu_torch.eval.run_eval import Evaluator
    from mevi_tpu_torch.eval.searcher import (FineIndex, FineReranker,
                                              bucket_scores_dispatch,
                                              build_fine_index)
    from mevi_tpu_torch.eval.streaming import (HostStreamFineReranker,
                                               streaming_mips_topk)
    from mevi_tpu_torch.config import MEVIConfig, RQConfig
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.data.datasets import device_prefetch
    from mevi_tpu_torch.eval import ceiling
    from mevi_tpu_torch.index.build import build_rq_index, embed_corpus
    from mevi_tpu_torch.index.csr import make_index
    from mevi_tpu_torch.index.hierarchical import hierarchical_kmeans_ids
    from mevi_tpu_torch.models.nci import NCIDims, NCIT5
    from mevi_tpu_torch.models.pawa import PawaAdaptor, PawaDims
    from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
    from mevi_tpu_torch.models.t5 import T5Dims, T5EncoderModel, T5Model
    from mevi_tpu_torch.models.twin_tower import make_tower
    from mevi_tpu_torch.ops.adc import adc_search, fill_onehot_matrix
    from mevi_tpu_torch.ops.kmeans import kmeans_fit
    from mevi_tpu_torch.ops.rq import rq_train
    from mevi_tpu_torch.ops.bucket import (bucket_scores, bucket_scores_fused,
                                           bucket_scores_v2, bucket_scores_v3)
    from mevi_tpu_torch.scripts import profile_bucket
    from mevi_tpu_torch.serve import BucketServer
    from mevi_tpu_torch.decode.brute import brute_force_topk
    from mevi_tpu_torch.decode.generate import generate
    from mevi_tpu_torch.decode.trie import build_trie, trie_beam_search
    from mevi_tpu_torch.train.loop import LoopConfig, TrainLoop
    from mevi_tpu_torch.eval.searcher import sharded_fine_rerank
    from mevi_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
    t5 = T5Dims(vocab_size=16, d_model=8, d_kv=2, d_ff=8, num_heads=4,
                num_layers=1, num_decoder_layers=1)
    nd = NCIDims(t5=t5, kary=2, max_output_length=3, adaptor_layer_num=1,
                 adaptor_num_heads=2, adaptor_d_ff=8)
    semb = torch.zeros(8, 8)
    z = torch.zeros(2, dtype=torch.int32)
    q = torch.zeros(2, 8)
    codes = np.zeros((8, 1), np.int32)
    emb = np.zeros((8, 8), np.float32)
    index = FineIndex(torch.tensor([0, 8, 8], dtype=torch.int32),
                      torch.arange(8, dtype=torch.int32), semb, 1, 2)

    def server(**kw):
        return BucketServer(T5Model(t5, device="cpu"),
                            NCIT5(nd, device="cpu"), index, **kw)

    def evaluator(**kw):
        return Evaluator(NCIT5(nd, device="cpu"), InferConfig(), index,
                         **kw)
    off = torch.tensor([0, 8, 8], dtype=torch.int32)
    cfg = MEVIConfig(rq=RQConfig(subvector_num=1, subvector_bits=1,
                                 emb_size=8))
    cfg.encoder.d_model = 8
    cfg.finalize()
    tok = np.ones((3, 4), np.int64)

    def rep(ids, mask):
        return torch.zeros(ids.shape[0], 8, device=ids.device)
    spec = synth.SynthSpec(ndoc=8, d=8, kary=2, levels=2, pool_n=4,
                           qlen=8, n_filler_vocab=4)
    tables = synth.make_tables(spec)
    draws = synth.make_draws(spec)
    codes8 = np.zeros((8, 2), np.int32)
    qtok = synth.query_tokens(spec, draws[:1], np.random.default_rng(0))
    obs = ceiling.observed_info(spec, qtok)
    ids2 = np.full((1, 3), 2, np.int32)
    child, term = build_trie([[0], [1, 0]], 2)
    return {
        "generate": lambda **kw: generate(
            T5Model(t5, device="cpu"), ids2, np.ones_like(ids2),
            max_length=2, **kw),
        "trie_beam_search": lambda **kw: trie_beam_search(
            NCIT5(nd, device="cpu"), ids2, np.ones_like(ids2), child, term,
            num_beams=2, max_steps=2, **kw),
        "brute_force_topk": lambda **kw: brute_force_topk(
            NCIT5(nd, device="cpu"), ids2, np.ones_like(ids2), 1, **kw),
        "TrainLoop": lambda **kw: TrainLoop(
            cfg, LoopConfig(), None, {}, None, None, ckpt_dir=f"{tmp}/ck",
            log_dir=f"{tmp}/log", **kw),
        "T5Model": lambda **kw: T5Model(t5, **kw),
        "T5EncoderModel": lambda **kw: T5EncoderModel(t5, **kw),
        "BertEncoderModel": lambda **kw: BertEncoderModel(BertDims(
            vocab_size=16, d_model=8, num_layers=1, num_heads=2, d_ff=8,
            max_position_embeddings=8), **kw),
        "make_tower": lambda **kw: make_tower("t5", t5, **kw),
        "NCIT5": lambda **kw: NCIT5(nd, **kw),
        "PawaAdaptor": lambda **kw: PawaAdaptor(PawaDims(8, 2, 8, 1), **kw),
        "build_fine_index": lambda **kw: build_fine_index(codes, emb, 2,
                                                          **kw),
        "FineReranker": lambda **kw: FineReranker(index, 4, 4, **kw),
        "BucketServer": server,
        "bucket_scores_v3": lambda **kw: bucket_scores_v3(semb, z, z, q, 4,
                                                          **kw),
        "bucket_scores_fused": lambda **kw: bucket_scores_fused(
            semb, off, z, q, 4, **kw),
        "bucket_scores_v2": lambda **kw: bucket_scores_v2(semb, z, z, q, 4,
                                                          **kw),
        "bucket_scores": lambda **kw: bucket_scores(semb, z, q, 4, **kw),
        "bucket_scores_dispatch": lambda **kw: bucket_scores_dispatch(
            semb, z, q, 4, **kw),
        "streaming_mips_topk": lambda **kw: streaming_mips_topk(q, emb, 3,
                                                                **kw),
        "HostStreamFineReranker": lambda **kw: HostStreamFineReranker(
            emb, off.numpy(), np.arange(8), 2, 4, 4, **kw),
        "make_index": lambda **kw: make_index(codes, 2, **kw),
        "Evaluator": evaluator,
        "profile_bucket.profile": lambda **kw: profile_bucket.profile(
            semb, off, z, q, 4, reps=1, **kw),
        "kmeans_fit": lambda **kw: kmeans_fit(emb, 2, iters=1, **kw),
        "rq_train": lambda **kw: rq_train(emb, 1, 2, iters=1, **kw),
        "build_rq_index": lambda **kw: build_rq_index(cfg, emb, iters=1,
                                                      **kw),
        "adc_search": lambda **kw: adc_search(emb[:2], np.zeros(
            (1, 2, 8), np.float32), np.zeros((8, 2), np.int8), 3, **kw),
        "fill_onehot_matrix": lambda **kw: fill_onehot_matrix(codes, 2,
                                                              **kw),
        "hierarchical_kmeans_ids": lambda **kw: hierarchical_kmeans_ids(
            np.eye(8, dtype=np.float32), k=2, c=4, iters=1, **kw),
        "embed_corpus": lambda **kw: embed_corpus(rep, tok, tok, 2, **kw),
        "synth.fit_rq_codes": lambda **kw: synth.fit_rq_codes(
            spec, tables, draws, cache_base=tmp, fit_sample=8, iters=1,
            **kw),
        "synth.fill_sorted_matrix": lambda **kw: synth.fill_sorted_matrix(
            spec, tables, draws, np.arange(8), 0, torch.float32, **kw),
        "synth.rows_abs_max": lambda **kw: synth.rows_abs_max(tables, draws,
                                                              **kw),
        "ceiling.candidate_stats": lambda **kw: ceiling.candidate_stats(
            spec, draws, codes8, obs, np.zeros(1, np.int64), **kw),
        "ceiling.exact_mips_topk": lambda **kw: ceiling.exact_mips_topk(
            np.ones((1, 8), np.float32), spec, tables, draws, 2, **kw),
        "ceiling.ceiling_report": lambda **kw: ceiling.ceiling_report(
            spec, tables, draws, codes8, qtok, np.zeros(1, np.int64), **kw),
        "device_prefetch": lambda **kw: list(device_prefetch(
            iter([{"x": np.zeros(2)}]), **kw)),
        "make_mesh": lambda **kw: make_mesh(**kw),
        "single_device_mesh": lambda **kw: single_device_mesh(**kw),
        "sharded_fine_rerank": lambda **kw: sharded_fine_rerank(
            q, torch.zeros((2, 1, 1), dtype=torch.int32), index,
            single_device_mesh("cpu"), 4, 4, **kw),
    }


ENTRY_NAMES = ["T5Model", "T5EncoderModel", "BertEncoderModel",
               "make_tower", "NCIT5", "PawaAdaptor", "build_fine_index",
               "FineReranker", "BucketServer", "bucket_scores_v3",
               "bucket_scores_fused", "bucket_scores_v2", "bucket_scores",
               "bucket_scores_dispatch", "streaming_mips_topk",
               "HostStreamFineReranker", "make_index", "Evaluator",
               "profile_bucket.profile", "kmeans_fit", "rq_train",
               "build_rq_index", "adc_search", "fill_onehot_matrix",
               "hierarchical_kmeans_ids", "embed_corpus",
               "synth.fit_rq_codes", "synth.fill_sorted_matrix",
               "synth.rows_abs_max", "ceiling.candidate_stats",
               "ceiling.exact_mips_topk", "ceiling.ceiling_report",
               "device_prefetch", "generate", "trie_beam_search",
               "brute_force_topk", "TrainLoop", "make_mesh",
               "single_device_mesh", "sharded_fine_rerank"]


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_point_needs_cuda_by_default(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_point_runs_with_cpu(name, tmp_path):
    _entry_points(str(tmp_path))[name](device="cpu")


CLI_DEVICE_COMMANDS = {
    "gen-embeddings": ["--checkpoint", "x.pt", "--documents", "d",
                       "--output", "e.bin"],
    "eval": ["--nci_ckpt", "n", "--tower_ckpt", "t.pt", "--embeddings",
             "e.bin", "--codes", "c.npy", "--dev_tsv", "dev.tsv"],
    "train-joint": ["--queries", "q", "--train_tsv", "t.tsv",
                    "--documents", "d"],
    "doc2query": ["--checkpoint", "x.pt", "--corpus", "c.tsv",
                  "--output", "o.tsv"],
}


@pytest.mark.parametrize("cmd", sorted(CLI_DEVICE_COMMANDS))
def test_cli_device_commands_default_to_cuda(no_cuda, cmd, tmp_path,
                                            monkeypatch):
    """``--device`` defaults to cuda: without a card the command stops
    before it reads a file; with ``--device cpu`` it goes on to its
    inputs (missing here; the CPU runs are tests/test_torch_cli_*.py).
    No HF tokenizer files are fetched: ``from_pretrained`` fails at once."""
    from mevi_tpu_torch.cli.main import build_parser, main
    transformers = pytest.importorskip("transformers")

    def offline(*a, **k):
        raise OSError("no HF tokenizer files (offline test)")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        offline)
    argv = [cmd] + [str(tmp_path / a) if i % 2 else a for i, a in
                    enumerate(CLI_DEVICE_COMMANDS[cmd])]
    assert build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    with pytest.raises((FileNotFoundError, OSError)):
        main(argv + ["--device", "cpu", "--allow_hash_tokenizer"]
             if cmd in ("doc2query",) else argv + ["--device", "cpu"])
