"""``mevi_tpu_torch.scripts.nq_scale_demo`` against
``scripts/nq_scale_demo.py`` on the CPU, each stage at 4,000 rows and
d 64 (the JAX script's CPU branch), the JAX stage in this process (its 8
virtual CPU devices) with its outputs recorded where it calls the
package:

* mesh: the port's 8 gloo ranks on the JAX stage's host rows with the
  JAX stage's tiny-model parameters: the sharded MIPS ids equal (as sets
  a query), its scores within 1e-4; the server's beam codes and pool ids
  equal, pool scores within 1e-4; the pool equal to the plain v3's;
* stream: given the JAX fit's codebooks, the codes and the exact top-100
  doc ids equal, the codebook beam equal, the host-streamed fine pool's
  ids equal and scores within 1e-4 (the JAX reranker built with a pool
  of min(1000, 10 x 64), as the port's takes: at the CPU branch's cap
  of 64 the JAX one cannot hold 1000);
* adc: given the JAX fit's ANN codebooks, the top-1000 ids equal;
* every stage: each JAX key present, equal where it is not a time or a
  rate.
"""

import importlib.util
import os
import os.path as osp
from unittest import mock

import numpy as np
import pytest
from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
NQ_ENV = {"NQ_NDOC": "4000", "NQ_MESH_D": "64", "NQ_D": "64",
          "NQ_FORCE_CPU": "1"}
ATOL = 1e-4


def timing(key):
    return key.endswith(("_s", "_qps", "_per_s", "_s_128q"))


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_nq_scale_demo", osp.join(REPO, "scripts", "nq_scale_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorder(store, name, fn, index=0):
    """``fn`` that records its ``index``-th call's result under ``name``."""
    calls = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if len(calls) == index:
            store[name] = out
        calls.append(1)
        return out
    return wrapped


def flat(params):
    import torch
    from flax import traverse_util
    # CPU tensors: the port's ranks receive them through shared memory
    return {k: torch.from_numpy(np.array(v)) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    import mevi_tpu.eval.streaming as jstream
    import mevi_tpu.ops.adc as jadc
    import mevi_tpu.ops.mips as jmips
    import mevi_tpu.ops.rq as jrq
    import mevi_tpu.serve as jserve
    from mevi_tpu.data import synth as jsynth
    cache = str(tmp_path_factory.mktemp("jax_nq_cache"))
    rec = {}
    fit, cache_dir = jsynth.fit_rq_codes, jsynth.SynthSpec.cache_dir

    def fit_here(*a, cache_base=None, **k):
        return fit(*a, cache_base=cache, **k)

    make_server = jserve.make_sharded_server

    def server(*a, **k):
        serve = make_server(*a, **k)

        def call(q_p, nci_p, *rest):
            rec["mesh_params"] = (flat(nci_p), flat(q_p))
            rec["mesh_server"] = serve(q_p, nci_p, *rest)
            return rec["mesh_server"]
        return call

    class Reranker(jstream.HostStreamFineReranker):
        # the JAX stage's CPU branch asks for a pool of 1000 from 10 x 64
        # slots, which its reranker cannot hold: built here with the
        # min(pool, nb * cap) = 640 the port's reranker takes
        def __init__(self, emb, offsets, doc_ids, kary, cap, pool, **k):
            super().__init__(emb, offsets, doc_ids, kary, cap,
                             min(pool, 10 * cap), **k)

        def __call__(self, *a, **k):
            rec["stream_fine"] = super().__call__(*a, **k)
            return rec["stream_fine"]

    mod = jax_script()
    outs = {}
    with mock.patch.dict(os.environ, NQ_ENV), \
            mock.patch.object(jsynth, "fit_rq_codes",
                              recorder(rec, "stream_fit", fit_here)), \
            mock.patch.object(jsynth.SynthSpec, "cache_dir",
                              lambda self, b=None: cache_dir(self, cache)), \
            mock.patch.object(jmips, "sharded_mips_topk",
                              recorder(rec, "mesh_mips",
                                       jmips.sharded_mips_topk)), \
            mock.patch.object(jserve, "make_sharded_server", server), \
            mock.patch.object(jstream, "streaming_mips_topk",
                              recorder(rec, "stream_exact",
                                       jstream.streaming_mips_topk)), \
            mock.patch.object(jstream, "HostStreamFineReranker", Reranker), \
            mock.patch.object(jrq, "beam_search",
                              recorder(rec, "stream_beam", jrq.beam_search)), \
            mock.patch.object(jrq, "rq_train",
                              # the second fit: the first is the stream
                              # stage's RQ 4 x 32
                              recorder(rec, "adc_fit", jrq.rq_train, 1)), \
            mock.patch.object(jadc, "adc_search",
                              recorder(rec, "adc_ids", jadc.adc_search)):
        for name in ("mesh", "stream", "adc"):
            outs[name] = {}
            getattr(mod, f"stage_{name}")(outs[name])
    return outs, rec


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    from mevi_tpu_torch.scripts import nq_scale_demo as nq
    _, rec = jax_runs
    outs, res = {}, {}
    with mock.patch.dict(os.environ, dict(
            NQ_ENV, NQ_TMP=str(tmp_path_factory.mktemp("nq_tmp")))):
        outs["mesh"] = {}
        res["mesh"] = nq.stage_mesh(outs["mesh"], "cpu",
                                    params=rec["mesh_params"])
        outs["stream"] = {}
        res["stream"] = nq.stage_stream(
            outs["stream"], "cpu", codebooks=np.asarray(rec["stream_fit"][0]))
        outs["adc"] = {}
        res["adc"] = nq.stage_adc(outs["adc"], "cpu",
                                  codebooks=np.asarray(rec["adc_fit"][0],
                                                       np.float32))
    return outs, res


# the JAX adc stage's exact oracle pads its last scan chunk with copies
# of document 0's row (ids past the corpus, masked to -1 after top-k), so
# a query near document 0 loses the rest of its list to the copies: at
# 4,000 rows the pad is 520,288 copies.  The port scans the rows alone;
# these keys are held against an exact numpy oracle instead
# (test_adc_against_exact_oracle)
JAX_PADDED_ORACLE = ("adc_recall@100_vs_exact", "adc_exact100_in_top1000",
                     "adc_rerank_recall@100_vs_exact")


@pytest.mark.parametrize("stage", ["mesh", "stream", "adc"])
def test_stage_keys_match_jax(jax_runs, port_runs, stage):
    want, got = jax_runs[0][stage], port_runs[0][stage]
    assert set(want) <= set(got)
    for k, v in want.items():
        if timing(k) or k in JAX_PADDED_ORACLE:
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=ATOL), k
        else:
            assert got[k] == v, k


def test_mesh_mips_matches_jax(jax_runs, port_runs):
    s_j, i_j = (np.asarray(x) for x in jax_runs[1]["mesh_mips"])
    s_p, i_p = port_runs[1]["mesh"]["mips"]
    np.testing.assert_array_equal(np.sort(i_p, 1), np.sort(i_j, 1))
    np.testing.assert_allclose(s_p, s_j, rtol=ATOL, atol=ATOL)


def test_mesh_server_matches_jax(jax_runs, port_runs):
    ts_j, ti_j, tc_j, _ = (np.asarray(x) for x in
                           jax_runs[1]["mesh_server"])
    ts, ti, tc = port_runs[1]["mesh"]["server"]
    np.testing.assert_array_equal(tc, tc_j)
    np.testing.assert_array_equal(ti, ti_j)
    valid = ti >= 0
    np.testing.assert_allclose(ts[valid], ts_j[valid], rtol=ATOL, atol=ATOL)
    ps, pi = port_runs[1]["mesh"]["plain"]
    np.testing.assert_array_equal(pi, ti)


def test_stream_matches_jax(jax_runs, port_runs):
    rec = jax_runs[1]
    got = port_runs[1]["stream"]
    np.testing.assert_array_equal(got["codes"], rec["stream_fit"][1])
    from mevi_tpu.utils.native import build_csr
    _, doc_ids = build_csr(rec["stream_fit"][1], 32)
    _, i_ex = rec["stream_exact"]
    want = np.asarray(doc_ids)[np.clip(np.asarray(i_ex), 0, len(doc_ids) - 1)]
    np.testing.assert_array_equal(np.sort(got["exact_ids"], 1),
                                  np.sort(want, 1))
    np.testing.assert_array_equal(got["beam_codes"],
                                  np.asarray(rec["stream_beam"][0]))
    fs_j, fi_j, nd_j = rec["stream_fine"]
    fs, fi, nd = got["fine"]
    np.testing.assert_array_equal(fi, fi_j)
    np.testing.assert_array_equal(nd, nd_j)
    valid = fi >= 0
    np.testing.assert_allclose(fs[valid], np.asarray(fs_j)[valid],
                               rtol=ATOL, atol=ATOL)


def test_adc_ids_match_jax(jax_runs, port_runs):
    i_j = np.asarray(jax_runs[1]["adc_ids"][1])
    i_j = np.where(i_j < 4000, i_j, -1)
    np.testing.assert_array_equal(port_runs[1]["adc"]["adc_ids"], i_j)


def test_hash_rows_any_rank_any_rows():
    """A shard made alone equals the same rows of the whole matrix, the
    values in [-100, 100) and not a short period."""
    import torch
    from mevi_tpu_torch.scripts.nq_scale_demo import hash_rows
    full = hash_rows(0, 5000, 48, 0, "cpu", chunk=777)
    part = hash_rows(1234, 4321, 48, 0, "cpu", chunk=1000)
    assert torch.equal(part, full[1234:4321])
    assert int(full.min()) >= -100 and int(full.max()) < 100
    assert len(torch.unique(full, dim=0)) == len(full)
    assert not torch.equal(hash_rows(0, 10, 48, 1, "cpu"), full[:10])


def test_mesh_stage_with_rows_made_in_the_ranks():
    """The card's layout on the CPU: each rank makes its shard from the
    seed (3,001 rows: the last shard is short); the MIPS and the pool
    hold against one process over the whole matrix (the stage's own
    checks)."""
    from mevi_tpu_torch.scripts import nq_scale_demo as nq
    out = {}
    with mock.patch.dict(os.environ, {"NQ_NDOC": "3001", "NQ_MESH_D": "32"}):
        nq.stage_mesh(out, "cpu", host_rows=False)
    assert out["mesh_mips_rows"] == 3001 and out["mesh_d"] == 32
    assert out["mesh_mips_agree_q0"] == 1.0
    assert out["mesh_pool_max_abs_err_vs_plain"] <= nq.MESH_PLAIN_ATOL
    assert out["mesh_pool_ids_equal"] == 1.0


def test_run_stages_merges_sidecars(tmp_path, capsys):
    from mevi_tpu_torch.scripts import nq_scale_demo as nq
    side = tmp_path / "side"
    side.mkdir()
    (side / "mesh.json").write_text('{"mesh_d": 64, "old": 1}\n')

    def fake(out, device):
        out["mesh_d"] = 768
    with mock.patch.object(nq, "stage_mesh", fake):
        out = nq.run_stages(["mesh"], "cpu", str(side),
                            str(tmp_path / "nq.json"))
    assert out["mesh_d"] == 768 and out["old"] == 1
    assert out["ndoc_true"] == 21_015_324
    assert nq.BUILD_DIR == osp.join(REPO, "build")


def overlap100(a, b, k=100):
    """Mean share of each exact top-100 in the first ``k`` of ``a``."""
    return round(float(np.mean([len(set(x[:k].tolist()) & set(y.tolist()))
                                / 100.0 for x, y in zip(a, b)])), 4)


def test_adc_against_exact_oracle(port_runs):
    """The exact top-100 equals a float64 numpy scan of the generated rows
    (as sets), and the recall keys are the port's ids' against it."""
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.scripts.nq_scale_demo import perturbed_queries
    out, res = port_runs[0]["adc"], port_runs[1]["adc"]
    spec = synth.SynthSpec(ndoc=4000, d=64, kary=32, levels=4, seed=9)
    ctrs, pool = (t.astype(np.float64) for t in synth.make_tables(spec))
    dr = synth.make_draws(spec)
    rows = ctrs[0][dr[:, 0]] + ctrs[1][dr[:, 1]] + ctrs[2][dr[:, 2]] + \
        pool[dr[:, 3]]
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    _, q = perturbed_queries(spec, synth.make_tables(spec), dr,
                             np.random.default_rng(1), 128,
                             np.random.default_rng(1))
    want = np.argsort(-(q.astype(np.float64) @ rows.T), 1,
                      kind="stable")[:, :100]
    np.testing.assert_array_equal(np.sort(res["ids_exact"], 1),
                                  np.sort(want, 1))
    assert out["adc_recall@100_vs_exact"] == overlap100(res["adc_ids"], want)
    assert out["adc_exact100_in_top1000"] == overlap100(res["adc_ids"], want,
                                                        1000)
    assert out["adc_rerank_recall@100_vs_exact"] == overlap100(
        res["rerank_ids"], want)
