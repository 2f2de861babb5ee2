"""The port's index build (``mevi_tpu_torch.index.build``,
``index.hierarchical``, ``decode.trie``, ``config``, ``train.checkpoints``,
``data.io`` memmaps and ``cli.main``) against the JAX package's, float32
on the CPU, on the same seeded numpy inputs.

Codes, CSR arrays, beam codes, trie tables, hierarchical-id tables and
``artifact_key`` are equal; float outputs are within rtol 1e-5 / atol
1e-5 (float32 sums in another order; 2e-5 where a T5 tower goes in
first, the port's T5 parity tolerance).  The JAX k-means++ draws cannot
be matched: the build parity tests replace the seeding on both sides by
the same rule (the first k rows) on data where no cluster empties; the
CLI, which draws its own seeds, is held to the JAX CLI by the output
files' names, shapes, dtypes and CSR invariants, and where no draw is
involved (``search``) by its results.
"""

import json
import os
import os.path as osp
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu import config as jcfg
from mevi_tpu.cli import main as jcli
from mevi_tpu.data import io as jio
from mevi_tpu.decode.trie import build_trie as j_build_trie
from mevi_tpu.index import build as jbuild
from mevi_tpu.index import hierarchical as jhier
from mevi_tpu.ops import kmeans as jk
from mevi_tpu.ops import rq as jrq
from mevi_tpu.train.checkpoints import ArtifactCache as JArtifactCache
from mevi_tpu_torch import config as tcfg
from mevi_tpu_torch.cli import main as tcli
from mevi_tpu_torch.data import io as tio
from mevi_tpu_torch.decode.trie import build_trie
from mevi_tpu_torch.eval.searcher import build_fine_index
from mevi_tpu_torch.index import build as tbuild
from mevi_tpu_torch.index import hierarchical as thier
from mevi_tpu_torch.index.csr import build_csr
from mevi_tpu_torch.ops import kmeans as tk
from mevi_tpu_torch.ops import rq as trq
from mevi_tpu_torch.train.checkpoints import ArtifactCache

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cfgs(mod, M=2, bits=2, d=16, center=False):
    cfg = mod.MEVIConfig(rq=mod.RQConfig(subvector_num=M,
                                         subvector_bits=bits, emb_size=d,
                                         center_levels=center),
                         encoder=mod.EncoderConfig(d_model=d))
    return cfg.finalize()


@pytest.fixture()
def first_rows_seeding(monkeypatch):
    """k-means++ replaced on both sides by the same rule: the first k
    rows (so both builds start from the same centroids)."""
    def first_rows(x, k, *a, **kw):
        return x[:k]
    monkeypatch.setattr(jk, "kmeans_plusplus_init", first_rows)
    monkeypatch.setattr(tk, "kmeans_plusplus_init", first_rows)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [(), ("rq_index", 300, 25, 42, ""),
                                   ("rq_index", 8841823, 25, 42, "hrq")])
@pytest.mark.parametrize("variant", ["default", "small", "center", "bert"])
def test_artifact_key_equal(parts, variant):
    def make(mod):
        if variant == "default":
            return mod.MEVIConfig().finalize()
        cfg = _cfgs(mod, center=variant == "center")
        if variant == "bert":
            cfg.encoder.family = "bert"
        return cfg
    assert make(tcfg).artifact_key(*parts) == make(jcfg).artifact_key(*parts)


@pytest.mark.parametrize("path", [ROOT / "configs" / "marco_rq4x5.json",
                                  ROOT / "configs" / "nqdpr_rq4x5.json",
                                  None])
def test_load_config_equal(path):
    t = tcli.load_config(str(path) if path else None)
    j = jcli.load_config(str(path) if path else None)
    assert t.to_json() == j.to_json()
    assert t.artifact_key("x") == j.artifact_key("x")
    if path and path.name == "marco_rq4x5.json":
        assert (t.rq.subvector_num, t.rq.kary, t.rq.dist_mode,
                t.rq.emb_size) == (4, 32, "l2", 768)


def test_config_json_roundtrip_equal():
    j = _cfgs(jcfg, M=3, center=True)
    j.infer.recall_num = (1, 10)
    t = tcfg.MEVIConfig.from_json(j.to_json()).finalize()
    assert t.to_json() == j.to_json()
    assert t.infer.recall_num == (1, 10)
    assert t.model.max_output_length == 5 and t.model.kary == 4


def test_config_validation_raises():
    with pytest.raises(ValueError):
        tcfg.RQConfig(dist_mode="cos").validate()
    cfg = tcfg.MEVIConfig(rq=tcfg.RQConfig(emb_size=16))
    with pytest.raises(ValueError):
        cfg.finalize()


# ---------------------------------------------------------------------------
# build_rq_index and the jobs on its artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("center", [False, True])
def test_build_rq_index_equal(first_rows_seeding, center):
    M = 3 if center else 2
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    stats = []
    t = tbuild.build_rq_index(_cfgs(tcfg, M=M, center=center), emb, iters=4,
                              level_stats=stats, device="cpu")
    j = jbuild.build_rq_index(_cfgs(jcfg, M=M, center=center), emb, iters=4)
    assert [s["restarts"] for s in stats] == [0] * M
    close(t.codebooks, j.codebooks)
    equal(t.codes, j.codes)
    assert t.codes.dtype == np.int32
    equal(t.fine.offsets, j.fine.offsets)
    equal(t.fine.doc_ids, j.fine.doc_ids)
    equal(t.fine.sorted_emb, np.asarray(j.fine.sorted_emb))
    assert (t.fine.levels, t.fine.kary) == (j.fine.levels, j.fine.kary)
    assert (t.prefix_shift is None) == (not center)
    if center:
        for a, b in zip(t.prefix_shift, j.prefix_shift):
            close(a, b)
        equal(tbuild.assign_with_codebooks(
            _cfgs(tcfg, M=M, center=True), emb, t.codebooks,
            prefix_shift=t.prefix_shift, batch=128, device="cpu"), t.codes)


def test_build_rq_index_serving_dtype_and_tensor_input(first_rows_seeding):
    """A tensor corpus builds the same index as its host copy; the
    serving matrix takes ``serving_dtype``."""
    emb = np.random.default_rng(8).normal(size=(200, 16)).astype(np.float32)
    cfg = _cfgs(tcfg)
    a = tbuild.build_rq_index(cfg, emb, iters=3, device="cpu")
    b = tbuild.build_rq_index(cfg, torch.from_numpy(emb), iters=3,
                              serving_dtype=torch.bfloat16, device="cpu")
    equal(a.codes, b.codes)
    assert b.fine.sorted_emb.dtype == torch.bfloat16
    equal(b.fine.sorted_emb.float(),
          torch.from_numpy(emb[a.fine.host_doc_ids]).to(torch.bfloat16)
          .float())


def test_build_rq_index_cache_shared_with_jax(tmp_path, monkeypatch):
    """An artifact cache written by the JAX build is found by the port's
    (same key), which then trains nothing."""
    emb = np.random.default_rng(9).normal(size=(200, 16)).astype(np.float32)
    j = jbuild.build_rq_index(_cfgs(jcfg), emb, iters=3,
                              cache=JArtifactCache(str(tmp_path)))

    def no_training(*a, **kw):
        raise AssertionError("trained despite a cached index")
    monkeypatch.setattr(trq, "rq_train", no_training)
    t = tbuild.build_rq_index(_cfgs(tcfg), emb, iters=3,
                              cache=ArtifactCache(str(tmp_path)),
                              device="cpu")
    equal(t.codebooks, j.codebooks)
    equal(t.codes, j.codes)
    equal(t.fine.doc_ids, j.fine.doc_ids)


def test_build_rq_index_cache_roundtrip_center(tmp_path):
    cfg = _cfgs(tcfg, M=3, center=True)
    emb = np.random.default_rng(10).normal(size=(300, 16)).astype(np.float32)
    cache = ArtifactCache(str(tmp_path))
    a = tbuild.build_rq_index(cfg, emb, iters=3, cache=cache, device="cpu")
    b = tbuild.build_rq_index(cfg, emb, iters=3, cache=cache, device="cpu")
    equal(a.codes, b.codes)
    for x, y in zip(a.prefix_shift, b.prefix_shift):
        equal(x, y)
    key = cfg.artifact_key("rq_index", 300, 3, 42, "hrq")
    assert cache.has(key, "prefix_shift_2.npy")
    cache.save_json(key, "meta.json", {"n": 300})
    assert cache.load_json(key, "meta.json") == {"n": 300}


@pytest.fixture(scope="module")
def fitted():
    """``tests/test_index_jobs.py``'s fixture: RQ 2 x 4 over 300 rows."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(300, 16)).astype(np.float32)
    cbs, _ = jrq.rq_train(jnp.asarray(emb), levels=2, kary=4, iters=6,
                          key=jax.random.PRNGKey(0))
    return emb, np.asarray(cbs)


def test_assign_with_codebooks_equal(fitted):
    emb, cbs = fitted
    got = tbuild.assign_with_codebooks(_cfgs(tcfg), emb, cbs, batch=128,
                                       device="cpu")
    equal(got, jbuild.assign_with_codebooks(_cfgs(jcfg), emb, cbs, batch=128))


def test_doc_topk_codes_equal(fitted):
    emb, cbs = fitted
    got = tbuild.doc_topk_codes(_cfgs(tcfg), emb, cbs, topk=3, batch=128,
                                device="cpu")
    assert got.shape == (300, 3, 2)
    equal(got, jbuild.doc_topk_codes(_cfgs(jcfg), emb, cbs, topk=3,
                                     batch=128))


def test_doc_topic_proba_equal(fitted):
    emb, cbs = fitted
    codes = jbuild.assign_with_codebooks(_cfgs(jcfg), emb, cbs)
    rand = np.random.default_rng(1).integers(0, 4, codes.shape).astype(
        codes.dtype)
    for c in (codes, rand):
        got = tbuild.doc_topic_proba(_cfgs(tcfg), emb, cbs, c, batch=128,
                                     device="cpu")
        close(got, jbuild.doc_topic_proba(_cfgs(jcfg), emb, cbs, c,
                                          batch=128))
        assert got.shape == (300,)


def test_topic_model_scores_equal():
    q, d, s = np.array([0.5, 0.2]), np.array([0.8, 0.1]), np.array([2.0, 3])
    close(tbuild.topic_model_scores(q, d, s, 0.25),
          jbuild.topic_model_scores(q, d, s, topic_score_ratio=0.25))


def test_reconstruct_leaf_centroids_equal(fitted):
    _, cbs = fitted
    idx = np.array([0, 5, 15])
    got = tbuild.reconstruct_leaf_centroids(_cfgs(tcfg), cbs, idx,
                                            device="cpu")
    close(got, jbuild.reconstruct_leaf_centroids(_cfgs(jcfg), cbs, idx))
    close(got[0], cbs[0, 0] + cbs[1, 0])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_build_fine_index_tensor_equals_host(dtype):
    """A tensor corpus is gathered on its own device into the same
    layout as the host path."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (50, 2)).astype(np.int32)
    emb = rng.normal(size=(50, 8)).astype(np.float32)
    a = build_fine_index(codes, emb, 4, dtype=dtype, device="cpu")
    b = build_fine_index(codes, torch.from_numpy(emb), 4, dtype=dtype,
                         device="cpu")
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    equal(b.host_offsets, a.host_offsets)


def test_embed_corpus_equal():
    """A T5 tower's first-token rep through ``embed_corpus`` (ragged
    tail padded) on both sides, same weights."""
    from mevi_tpu.models import t5 as jt5
    from mevi_tpu_torch.models import t5 as pt5
    from mevi_tpu_torch.weights import load_flax_params
    kw = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
              num_layers=1, num_decoder_layers=1)
    jm = jt5.T5Model(jt5.T5Dims(dropout_rate=0.0, **kw))
    rng = np.random.default_rng(12)
    tokens = rng.integers(2, 60, (10, 6)).astype(np.int64)
    masks = np.ones_like(tokens)
    masks[3, 4:] = 0
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]),
                     jnp.asarray(masks[:1]),
                     jnp.zeros((1, 1), jnp.int32))["params"]
    tm = pt5.T5Model(pt5.T5Dims(**kw), device="cpu")
    load_flax_params(tm, {k: np.asarray(v) for k, v in
                          traverse_util.flatten_dict(params, sep="/").items()})

    def jrep(ids, mask):
        return jm.apply({"params": params}, ids, mask,
                        method=jt5.T5Model.first_token_rep)
    seen = []
    got = tbuild.embed_corpus(tm.first_token_rep, tokens, masks,
                              batch_size=4, device="cpu",
                              progress=lambda d, n: seen.append((d, n)))
    want = jbuild.embed_corpus(jrep, tokens, masks, batch_size=4)
    assert got.shape == (10, 16) and got.dtype == np.float32
    close(got, want, atol=2e-5)
    assert seen == [(4, 10), (8, 10), (10, 10)]


def test_embedding_memmaps_interchange(tmp_path):
    emb = np.random.default_rng(13).normal(size=(7, 16)).astype(np.float32)
    tio.write_embedding_memmap(str(tmp_path / "t.bin"), emb)
    jio.write_embedding_memmap(str(tmp_path / "j.bin"), emb)
    equal(jio.open_embedding_memmap(str(tmp_path / "t.bin"), 16), emb)
    equal(tio.open_embedding_memmap(str(tmp_path / "j.bin"), 16), emb)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin"
                                                 ).read_bytes()


# ---------------------------------------------------------------------------
# hierarchical ids and the trie
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hier_ids():
    emb = np.random.default_rng(14).normal(size=(200, 8)).astype(np.float32)
    return emb, thier.hierarchical_kmeans_ids(emb, k=4, c=5, iters=4,
                                              device="cpu")


def test_hierarchical_ids_properties(hier_ids):
    """Unique per doc, every doc covered, codes below max(k, c), leaves
    of at most c docs, and the same ids for the same seed."""
    emb, ids = hier_ids
    assert len(ids) == 200 and all(len(s) >= 1 for s in ids)
    assert len({tuple(s) for s in ids}) == 200
    assert max(max(s) for s in ids) < 5
    leaves = {}
    for s in ids:
        leaves.setdefault(tuple(s[:-1]), []).append(s[-1])
    assert all(sorted(v) == list(range(len(v))) and len(v) <= 5
               for v in leaves.values())
    assert thier.hierarchical_kmeans_ids(emb, k=4, c=5, iters=4,
                                         device="cpu") == ids


def test_prefix_cluster_docs_equal(hier_ids):
    _, ids = hier_ids
    for layer in (1, 2, 3):
        assert thier.prefix_cluster_docs(ids, layer) == \
            jhier.prefix_cluster_docs(ids, layer)
    small = [[0, 1], [0, 2], [0, 1, 3], [1], [1, 0]]
    assert thier.prefix_cluster_docs(small, 2) == \
        jhier.prefix_cluster_docs(small, 2)


def test_ids_to_padded_and_trie_equal(hier_ids):
    _, ids = hier_ids
    for a, b in zip(thier.ids_to_padded(ids), jhier.ids_to_padded(ids)):
        equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(build_trie(ids, 5), j_build_trie(ids, 5)):
        equal(a, b)
        assert a.dtype == b.dtype


def test_save_hier_artifacts_equal(tmp_path, hier_ids):
    _, ids = hier_ids
    thier.save_hier_artifacts(str(tmp_path / "t"), ids, [1, 2], kary=5)
    jhier.save_hier_artifacts(str(tmp_path / "j"), ids, [1, 2], kary=5)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".pkl"):
            assert pickle.loads(a.read_bytes()) == pickle.loads(b.read_bytes())
        elif name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            for k in zb.files:
                equal(za[k], zb[k])
        else:
            equal(np.load(a), np.load(b))


# ---------------------------------------------------------------------------
# the command line, through ``python -m mevi_tpu_torch.cli.main``
# ---------------------------------------------------------------------------

def _port_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "mevi_tpu_torch.cli.main",
                        *args, "--device", "cpu"], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _write_cfg(path, M=2, center=False):
    with open(path, "w") as fw:
        fw.write(_cfgs(jcfg, M=M, center=center).to_json())
    return str(path)


@pytest.mark.parametrize("center", [False, True])
def test_cli_build_index_files(tmp_path, capsys, center):
    M = 3 if center else 2
    emb = np.random.default_rng(15).normal(size=(200, 16)).astype(np.float32)
    ep = str(tmp_path / "docemb.bin")
    jio.write_embedding_memmap(ep, emb)
    cfgp = _write_cfg(tmp_path / "cfg.json", M, center)
    out = _port_cli("build-index", "--config", cfgp, "--embeddings", ep,
                    "--output_dir", str(tmp_path / "t"), "--iters", "4")
    jcli.main(["build-index", "--config", cfgp, "--embeddings", ep,
               "--output_dir", str(tmp_path / "j"), "--iters", "4"])
    j_hist = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_hist = json.loads(out.strip().splitlines()[-1])
    assert t_hist.keys() == j_hist.keys()
    assert t_hist["num_clusters"] == j_hist["num_clusters"] == 4 ** M
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert ("rq_prefix_shift.npz" in names) == center
    for name in names:
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        if name.endswith(".npz"):
            assert a.files == b.files
            a, b = [a[k] for k in a.files], [b[k] for k in b.files]
        else:
            a, b = [a], [b]
        for x, y in zip(a, b):
            assert (x.shape, x.dtype) == (y.shape, y.dtype), name
    t = {n: np.load(tmp_path / "t" / n) for n in names if n.endswith(".npy")}
    off, ids = build_csr(t["rq_codes.npy"], 4)
    equal(t["csr_offsets.npy"], off)
    equal(t["csr_doc_ids.npy"], ids)
    assert off[-1] == 200
    equal(np.sort(t["csr_doc_ids.npy"]), np.arange(200))
    cfg = _cfgs(tcfg, M=M, center=center)
    shift = None
    if center:
        z = np.load(tmp_path / "t" / "rq_prefix_shift.npz")
        shift = [z[f"l{i}"] for i in range(1, M)]
    equal(tbuild.assign_with_codebooks(cfg, emb, t["rq_codebooks.npy"],
                                       prefix_shift=shift, device="cpu"),
          t["rq_codes.npy"])
    assert t_hist["nonempty"] == int((np.diff(off) > 0).sum())


def test_cli_build_hier_files(tmp_path):
    emb = np.random.default_rng(16).normal(size=(80, 16)).astype(np.float32)
    ep = str(tmp_path / "emb.bin")
    jio.write_embedding_memmap(ep, emb)
    cfgp = _write_cfg(tmp_path / "cfg.json")
    out = _port_cli("build-hier", "--config", cfgp, "--embeddings", ep,
                    "--output_dir", str(tmp_path / "t"), "--k", "3",
                    "--c", "4", "--layers", "1,2", "--iters", "3")
    summary = json.loads(out.strip().splitlines()[-1])
    codes = np.load(tmp_path / "t" / "hier_codes.npy")
    lens = np.load(tmp_path / "t" / "hier_lengths.npy")
    ids = [codes[i, :lens[i]].tolist() for i in range(80)]
    assert summary["n_docs"] == 80 and summary["max_len"] == lens.max()
    trie = np.load(tmp_path / "t" / "hier_trie.npz")
    for a, b in zip((trie["child"], trie["terminal"]), build_trie(ids, 4)):
        equal(a, b)
    with open(tmp_path / "t" / "doc_cluster_layer2.pkl", "rb") as fr:
        m = pickle.load(fr)
    assert m == {k: [str(d) for d in v] for k, v in
                 jhier.prefix_cluster_docs(ids, 2).items()}
    assert len({d for v in m.values() for d in v}) == 80


@pytest.mark.parametrize("mode", ["exact", "adc"])
def test_cli_search_equal(tmp_path, mode):
    rng = np.random.default_rng(17)
    docs = rng.normal(size=(80, 16)).astype(np.float32)
    dp, qp = str(tmp_path / "docemb.bin"), str(tmp_path / "qemb.bin")
    jio.write_embedding_memmap(dp, docs)
    jio.write_embedding_memmap(qp, docs[:5] + 0.1)
    cfgp = _write_cfg(tmp_path / "cfg.json")
    extra = []
    if mode == "adc":
        cbs, codes = jrq.rq_train(jnp.asarray(docs), 2, 4, iters=5,
                                  key=jax.random.PRNGKey(0))
        np.save(tmp_path / "codes.npy", np.asarray(codes))
        np.save(tmp_path / "cbs.npy", np.asarray(cbs))
        extra = ["--adc_codes", str(tmp_path / "codes.npy"),
                 "--adc_codebooks", str(tmp_path / "cbs.npy")]
    args = ["search", "--config", cfgp, "--doc_embeddings", dp,
            "--query_embeddings", qp, "--topk", "7", "--batch", "2", *extra]
    _port_cli(*args, "--output", str(tmp_path / "t.tsv"))
    jcli.main(args + ["--output", str(tmp_path / "j.tsv")])
    tmpl = {"query": 0, "pred": 2, "score": 3}
    tp, ts, _ = tio.parse_result_tsv(str(tmp_path / "t.tsv"), tmpl)
    jp, js, _ = jio.parse_result_tsv(str(tmp_path / "j.tsv"), tmpl)
    assert tp == jp and len(tp) == 5
    for q in jp:
        close(ts[q], js[q])
