"""Port parity on one JAX tiny bundle (``QF_TINY``, 400 documents): the
``sharded`` stage of ``mevi_tpu_torch.scripts.quality_full`` against the
JAX ``stage_sharded``, and ``mevi_tpu_torch.scripts.data_ceiling``
against ``scripts/data_ceiling.py``, both on the CPU.

* sharded: the port's ranks over gloo (a data 2 x corpus 4 mesh of
  spawned processes), the JAX stage on its 8 virtual CPU devices, both
  in float32 over the JAX bundle (its NCI converted through the weight
  bridge).  Beam codes equal the JAX beam's, the canonical top-100 ids
  equal the JAX stage's (exact), and ``SHARDED_PARITY.json`` holds every
  JAX key with equal values but the seconds;
* data_ceiling: every key of the JAX line equal (floats to 1e-4, the
  rounding of the 4-decimal keys) but ``workdir`` and ``secs``.
"""

import importlib.util
import json
import os
import os.path as osp
import sys
from unittest import mock

import numpy as np
import pytest

from test_torch_quality_full import TINY_ENV, jax_bundle, port_bundle
from torch_synth_cache_jax import jax_synth_cache
from torch_one_thread import one_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SHARD_ENV = dict(TINY_ENV, QF_SHARD_DUMP="1", QF_SHARD_B="32")
# host-clock keys, and the port's own key (the ranks' v3 launches)
TIMING_KEYS = ("sharded_serve_s", "secs", "workdir")
FLOAT_TOL = 1e-4


def jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def private_synth_caches(tmp_path_factory):
    from mevi_tpu_torch.data import synth
    base = tmp_path_factory.mktemp("synth_cache")
    with jax_synth_cache(str(base / "jax")), \
            mock.patch.object(synth, "default_cache_base",
                              lambda: str(base / "port")):
        yield base


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    jax_dir = jax_bundle(tmp_path_factory, "all")
    port_dir = port_bundle(jax_dir, str(tmp_path_factory.mktemp("port")
                                        / "bundle"))
    return jax_dir, port_dir


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_runs(bundles):
    from mevi_tpu.data.synth import load_spec as jload_spec
    from mevi_tpu_torch.data.synth import load_spec
    from mevi_tpu_torch.scripts import quality_full as qf
    jax_dir, port_dir = bundles
    with mock.patch.dict(os.environ, SHARD_ENV):
        jq = jax_module("quality_full")
        jspec = jload_spec(osp.join(jax_dir, "spec.json"))
        jq.stage_sharded(jspec, jax_dir, jq.model_cfg(jspec, jax_dir),
                         osp.join(jax_dir, "QUALITY.json"))
        spec = load_spec(osp.join(port_dir, "spec.json"))
        out = qf.stage_sharded(spec, port_dir, qf.model_cfg(spec, port_dir),
                               "cpu")
    return jax_dir, port_dir, out


def jax_beam_codes(jax_dir, n):
    """The JAX beam of the stage's first ``n`` dev queries (float32, the
    stage's call)."""
    import dataclasses
    import jax.numpy as jnp
    from mevi_tpu.cli.main import _nci_dims
    from mevi_tpu.data.synth import load_spec
    from mevi_tpu.decode.beam import nci_beam_search_incremental
    from mevi_tpu.models.nci import NCIT5
    jq = jax_module("quality_full")
    with mock.patch.dict(os.environ, TINY_ENV):
        spec = load_spec(osp.join(jax_dir, "spec.json"))
        cfg = jq.model_cfg(spec, jax_dir)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
        params = jq._load_nci_params(jax_dir, cfg)
    ids = jnp.asarray(np.load(osp.join(jax_dir, "dev_tokens.npy"))[:n]
                      .astype(np.int32))
    codes, _, _ = nci_beam_search_incremental(
        NCIT5(_nci_dims(cfg, dropout=0.0)), params, ids, jnp.ones_like(ids),
        10)
    return np.asarray(codes)


def test_sharded_beam_codes_equal_jax(sharded_runs):
    jax_dir, port_dir, _ = sharded_runs
    with np.load(osp.join(port_dir, "sharded_debug.npz")) as z:
        codes = z["codes"]
    np.testing.assert_array_equal(codes, jax_beam_codes(jax_dir,
                                                        len(codes)))


@pytest.mark.parametrize("name", ["c_i_sh", "c_i_1", "dev_docs"])
def test_sharded_canonical_ids_equal_jax(sharded_runs, name):
    jax_dir, port_dir, _ = sharded_runs
    with np.load(osp.join(jax_dir, "sharded_debug.npz")) as a, \
            np.load(osp.join(port_dir, "sharded_debug.npz")) as b:
        np.testing.assert_array_equal(b[name], a[name])


def test_sharded_parity_json_matches_jax(sharded_runs):
    jax_dir, port_dir, out = sharded_runs
    with open(osp.join(jax_dir, "SHARDED_PARITY.json")) as fr:
        want = json.load(fr)
    with open(osp.join(port_dir, "SHARDED_PARITY.json")) as fr:
        got = json.load(fr)
    assert got == out
    assert set(want) <= set(got)
    for k in want:
        if k not in TIMING_KEYS:
            assert got[k] == want[k], k
    assert got["mesh"] == {"data": 2, "corpus": 4}
    # on the CPU the fine stage runs the plain version: no launches
    assert got["bucket_launches"] == 0


def test_sharded_divergence_raises(bundles, tmp_path):
    """A single path that disagrees with the ranks stops the stage."""
    import shutil
    from mevi_tpu_torch.data.synth import load_spec
    from mevi_tpu_torch.scripts import quality_full as qf
    _, port_dir = bundles
    work = str(tmp_path / "bundle")
    shutil.copytree(port_dir, work)
    spec = load_spec(osp.join(work, "spec.json"))
    from mevi_tpu_torch.decode.beam import nci_beam_search_incremental

    def shifted(*a, **k):
        codes, s, e = nci_beam_search_incremental(*a, **k)
        return (codes + 1) % spec.kary, s, e
    with mock.patch.dict(os.environ, SHARD_ENV), \
            mock.patch("mevi_tpu_torch.decode.beam."
                       "nci_beam_search_incremental", shifted):
        with pytest.raises(AssertionError, match="beam codes diverged"):
            qf.stage_sharded(spec, work, qf.model_cfg(spec, work), "cpu")


# ---------------------------------------------------------------------------
# data_ceiling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ceiling_lines(bundles, tmp_path_factory):
    from mevi_tpu_torch.scripts import data_ceiling
    jax_dir, port_dir = bundles
    out = tmp_path_factory.mktemp("ceil")
    env = {"CEIL_WORKDIR": jax_dir, "CEIL_N": "48", "CEIL_FORCE_CPU": "1"}
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(sys, "argv", ["data_ceiling.py",
                                            str(out / "jax.json")]):
        jax_module("data_ceiling").main()
    with mock.patch.dict(os.environ, dict(env, CEIL_WORKDIR=port_dir)):
        data_ceiling.main([str(out / "port.json"), "--device", "cpu"])
    with open(out / "jax.json") as a, open(out / "port.json") as b:
        return json.load(a), json.load(b)


def test_data_ceiling_line_matches_jax(ceiling_lines):
    want, got = ceiling_lines
    assert set(got) == set(want)
    for k, v in want.items():
        if k in TIMING_KEYS:
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=FLOAT_TOL), k
        else:
            assert got[k] == v, k
    assert got["n_dev"] == 48


def test_data_ceiling_default_output(bundles, tmp_path, capsys):
    """Without an output path the line lands in the workdir."""
    import shutil
    from mevi_tpu_torch.scripts import data_ceiling
    work = str(tmp_path / "w")
    shutil.copytree(bundles[1], work)
    with mock.patch.dict(os.environ, {"CEIL_WORKDIR": work, "CEIL_N": "8"}):
        rep = data_ceiling.main(["--device", "cpu"])
    with open(osp.join(work, "CEILING.json")) as fr:
        assert json.load(fr) == rep
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
