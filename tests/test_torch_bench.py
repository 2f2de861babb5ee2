"""Port parity: ``mevi_tpu_torch.bench`` against the JAX ``bench.run`` on
the CPU (the JAX script's CPU branch: d 64, batch 4, cap 64, pool 100),
and ``mevi_tpu_torch.scripts.int8_tax`` at tiny size.

* trained pipeline over the JAX tiny bundle converted to a port bundle,
  at the bundle's corpus and at a larger one (the re-assign branch):
  ``cluster_sizes``, ``recall100_*``, ``oracle_cluster_coverage``, every
  ``trained_*`` key and ``ndoc_per_query`` equal;
* random-weight pipeline with the JAX fit's codebooks passed in: the
  keys that the host draws and the codebooks determine equal (the
  weights are each package's own seeded init);
* int8_tax: both recall sets and their deltas, the coarse keys equal
  between the dtypes.

Both ``bench.run``s run in this process (one JAX start-up for all),
with both packages' synth caches in a directory of the module's own
(``private_synth_caches``, imported so that it applies here too)."""

import json
import os
import os.path as osp
import sys
from unittest import mock

import pytest
import torch

from test_torch_quality_full import (jax_bundle, port_bundle,  # noqa: F401
                                     private_synth_caches)
from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "ndoc", "batch", "cap",
             "pipeline", "corpus_dtype", "rpc_floor_ms", "cluster_sizes",
             "recall100_beam_coarse", "recall100_oracle_coarse",
             "oracle_cluster_coverage", "cold_start_s", "ndoc_per_query",
             "sequential_qps", "baseline_qps_measured", "baseline_def",
             "latency_b8_ms", "stages")
TRAINED_KEYS = ("trained_coarse_hit@1", "trained_coarse_hit@10",
                "trained_fine_recall@100", "trained_fine_mrr@10",
                "trained_fine_recall@100_beam_major",
                "trained_fine_mrr@10_beam_major", "trained_ndoc_per_query")
# the keys the host draws and the codebooks determine
HOST_KEYS = ("ndoc", "batch", "cap", "pipeline", "corpus_dtype",
             "cluster_sizes", "recall100_beam_coarse",
             "recall100_oracle_coarse", "oracle_cluster_coverage",
             "ndoc_per_query")


def jax_bench(tmp_path_factory):
    env = {"JAX_COMPILATION_CACHE_DIR": str(
        tmp_path_factory.mktemp("jax_cache")), "BENCH_FORCE_CPU": "1"}
    with mock.patch.dict(os.environ, env):
        sys.path.insert(0, REPO)
        import bench
    return bench, env


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    jax_dir = jax_bundle(tmp_path_factory, "all")
    return jax_dir, port_bundle(
        jax_dir, str(tmp_path_factory.mktemp("port_bundle") / "b"))


@pytest.fixture(scope="module", params=[400, 1000],
                ids=["bundle_corpus", "larger_corpus"])
def trained_runs(request, bundles, tmp_path_factory):
    from mevi_tpu_torch import bench as tbench
    jax_dir, port_dir = bundles
    jbench, env = jax_bench(tmp_path_factory)
    ref = {}
    with mock.patch.dict(os.environ, dict(env, BENCH_CKPT=jax_dir)):
        jbench.run(request.param, ref)
    out = {}
    tbench.run(request.param, out, device="cpu", ckpt=port_dir)
    return ref, out


@pytest.mark.parametrize("key", HOST_KEYS + TRAINED_KEYS)
def test_trained_pipeline_matches_jax(trained_runs, key):
    ref, out = trained_runs
    assert out[key] == ref[key], (key, ref[key], out[key])


def test_trained_line_has_every_key(trained_runs):
    from mevi_tpu_torch.bench import result_line
    ref, out = trained_runs
    line = result_line(100.0, 10.0, out)
    assert set(LINE_KEYS + TRAINED_KEYS) <= set(line)
    assert set(out["stages"]) == set(ref["stages"])
    assert out["bucket_launches"] == {"v3": 0, "fused": 0}  # CPU: plain


@pytest.fixture(scope="module")
def random_runs(tmp_path_factory):
    import jax.numpy as jnp
    from mevi_tpu.data import synth as jsynth
    from mevi_tpu_torch import bench as tbench
    jbench, env = jax_bench(tmp_path_factory)
    ndoc = 2000
    ref = {}
    with mock.patch.dict(os.environ, dict(env, BENCH_CKPT="")):
        jbench.run(ndoc, ref)
    # the fit the JAX run cached in this module's cache: its codebooks
    spec = jsynth.SynthSpec(ndoc=ndoc, d=64, kary=32, levels=4, seed=0,
                            qlen=32)
    tab = jsynth.make_tables(spec)
    cbs, _ = jsynth.fit_rq_codes(spec, (jnp.asarray(tab[0]),
                                        jnp.asarray(tab[1])),
                                 jsynth.make_draws(spec))
    out = {}
    tbench.run(ndoc, out, device="cpu", codebooks=cbs)
    return ref, out


@pytest.mark.parametrize("key", HOST_KEYS)
def test_random_pipeline_host_keys_match_jax(random_runs, key):
    ref, out = random_runs
    assert out[key] == ref[key], (key, ref[key], out[key])


def test_random_pipeline_line(random_runs):
    ref, out = random_runs
    assert set(LINE_KEYS) - {"metric", "value", "unit", "vs_baseline"} \
        <= set(out)
    assert not set(TRAINED_KEYS) & set(out)
    for k in ("baseline_qps_measured", "sequential_qps", "latency_b8_ms"):
        assert out[k] > 0, k
    assert out["recall100_beam_coarse"] <= out["oracle_cluster_coverage"]
    assert out["recall100_oracle_coarse"] <= out["oracle_cluster_coverage"]


def test_bench_main_prints_one_line(capsys):
    from mevi_tpu_torch import bench as tbench
    line = tbench.main(["--device", "cpu", "--ndoc", "1500", "--dtype",
                        "int8", "--nbatch", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert set(LINE_KEYS) <= set(line)
    assert line["corpus_dtype"] == "int8" and line["int8_scale"] > 0
    assert line["vs_baseline"] > 0 and line["baseline_qps_measured"] > 0


@pytest.mark.parametrize("entry", ["bench", "scripts.quality_full",
                                   "scripts.int8_tax"])
def test_entry_point_needs_the_card_by_default(entry, tmp_path, monkeypatch):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    monkeypatch.setenv("QF_WORKDIR", str(tmp_path))
    mod = importlib.import_module(f"mevi_tpu_torch.{entry}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--out", str(tmp_path / "o.json")]
                 if entry.endswith("int8_tax") else [])
    assert not os.listdir(tmp_path)


def test_int8_tax_tiny(bundles, tmp_path):
    from mevi_tpu_torch.scripts import int8_tax
    _, port_dir = bundles
    out_p = str(tmp_path / "tax.json")
    art = int8_tax.main(["--device", "cpu", "--ndoc", "400", "--ckpt",
                         port_dir, "--out", out_p, "--nbatch", "2"])
    with open(out_p) as fr:
        assert json.load(fr) == art
    assert art["metric"] == "int8_quality_tax" and art["ndoc"] == 400
    for dt in ("bf16", "int8"):
        assert set(int8_tax.RECALL_KEYS) - {"int8_scale"} <= set(art[dt])
    assert "int8_scale" in art["int8"] and "int8_scale" not in art["bf16"]
    for k in int8_tax.RECALL_KEYS:
        if "recall" in k or "hit" in k:
            assert art[f"delta_{k}"] == round(art["int8"][k]
                                              - art["bf16"][k], 4)
    # the corpus dtype does not enter the coarse stage
    for k in ("trained_coarse_hit@1", "trained_coarse_hit@10"):
        assert art["bf16"][k] == art["int8"][k], k
        assert art[f"delta_{k}"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["v3", "fused"])
def test_bench_on_the_card(kernel):
    """The card-only parts: the served kernel against its plain version,
    the traced stage split, the launches of the served kernel alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mevi_tpu_torch import bench as tbench
    extras = {}
    qps, base = tbench.run(100_000, extras, device="cuda", batch=64,
                           nbatch=2, bucket_kernel=kernel)
    assert qps > 0 and base > 0
    assert extras["kernel_matches_oracle"] is True
    assert {"qenc_device_ms", "beam_device_ms", "qenc_mfu_pct",
            "beam_mfu_pct"} <= set(extras["stages"])
    other = "fused" if kernel == "v3" else "v3"
    assert extras["bucket_launches"][kernel] > 0
    assert extras["bucket_launches"][other] == 0
    assert extras["recall100_beam_coarse"] <= \
        extras["oracle_cluster_coverage"]
