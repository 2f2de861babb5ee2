"""Port parity: ``mevi_tpu_torch.scripts.quality_full`` against the JAX
``scripts/quality_full.py`` on the CPU, at the JAX script's tiny
geometry (``QF_TINY``, 400 documents).

* data stage, given the JAX fit's codebooks and ``prefix_shift``: every
  file byte-equal (the npz by its arrays: a zip member carries its write
  time), but for the last RQ level of documents alone in their prefix:
  their centred residual before the spherical last level is rounding
  noise (norm ~1e-8), so that code is set by float32 rounding and
  differs between JAX's own jitted and eager assignment too; the codes
  are equal everywhere else;
* tower stage: from the same initial parameters (flax params through
  ``weights.load_flax_params``) and the same host draws, 4 float32 steps
  give parameters within relative L2 1e-4 of optax's, and equal probe
  metrics;
* eval stage over the JAX bundle converted to a port bundle (the NCI
  carried from the orbax checkpoint through the weight bridge, here in
  the test): discrete QUALITY keys equal, float keys within 1e-4, the
  served arrays equal;
* the bundle check: the tiny bundle is complete, an incomplete one
  raises.

Both packages' synth caches live in a directory of the module's own
(``private_synth_caches``), the JAX script's included."""

import importlib.util
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from torch_synth_cache_jax import jax_synth_cache

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_ENV = {
    "QF_TINY": "1", "QF_NDOC": "400", "QF_UTT": "2", "QF_EPOCHS": "2",
    "QF_BATCH": "16", "QF_TOWER_STEPS": "16", "QF_TOWER_BATCH": "32",
    "QF_TOWER_SCAN": "4", "QF_NDEV": "64", "QF_EVAL_BATCH": "32",
    "QF_CAP": "64", "QF_POOL": "50",
}
DATA_FILES = ("spec.json", "codebooks.npy", "trainq_tokens.bin",
              "trainq_masks.bin", "train_order.npy", "dev_docs.npy",
              "dev_tokens.npy")
# a centred residual this small is rounding noise (the others are > 0.05)
ROUNDING_RESIDUAL = 1e-6
# host-clock seconds: not a quality key
TIMING_KEYS = ("serve_s_for_n_dev",)


@pytest.fixture(scope="module", autouse=True)
def private_synth_caches(tmp_path_factory):
    """Both packages' synth caches under a directory of the module's own:
    the JAX default is one fixed directory that every checkout on the
    host shares, written by non-atomic saves."""
    from mevi_tpu_torch.data import synth
    base = tmp_path_factory.mktemp("synth_cache")
    with jax_synth_cache(str(base / "jax")), \
            mock.patch.object(synth, "default_cache_base",
                              lambda: str(base / "port")):
        yield base


def _session_dir(tmp_path_factory):
    """A directory every worker of this pytest session shares (the
    workers' base under ``pytest -n``, else this process's)."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def jax_bundle(tmp_path_factory, stages):
    """The JAX script's tiny run (the stages given), in a process of its
    own with its synth cache in a directory of its own; returns a private
    copy of its workdir.  The run is made once a session for every
    module that asks for the same stages (under a file lock: the modules
    of ``pytest -n`` run in several workers); each caller gets its own
    copy, so none sees another's writes."""
    from filelock import FileLock
    root = _session_dir(tmp_path_factory) / "jax_qf_shared"
    root.mkdir(exist_ok=True)
    key = stages.replace(",", "_")
    built = root / key
    with FileLock(str(root / f"{key}.lock")):
        if not (root / f"{key}.done").exists():
            shutil.rmtree(built, ignore_errors=True)
            built.mkdir()
            workdir = str(built)
            env = dict(os.environ, **TINY_ENV)
            env.update({"QF_FORCE_CPU": "1", "QF_STAGE": stages,
                        "QF_WORKDIR": workdir, "QF_SCAN": "4",
                        "QF_OUT": osp.join(workdir, "QUALITY.json"),
                        "JAX_PLATFORMS": "cpu",
                        "JAX_COMPILATION_CACHE_DIR": str(root / "jax_cache")})
            env.pop("XLA_FLAGS", None)
            proc = subprocess.run(
                [sys.executable,
                 osp.join(REPO, "tests", "torch_synth_cache_jax.py"),
                 str(root / f"{key}_synth"),
                 osp.join(REPO, "scripts", "quality_full.py")],
                env=env, cwd=REPO, capture_output=True, text=True,
                timeout=900)
            assert proc.returncode == 0, proc.stderr[-4000:]
            (root / f"{key}.done").touch()
    copy = str(tmp_path_factory.mktemp("jax_qf") / "w")
    shutil.copytree(built, copy)
    return copy


def port_bundle(jax_dir, out_dir):
    """A copy of a JAX bundle whose NCI checkpoints are the port's: each
    orbax tag's params through the weight bridge into a
    ``CheckpointManager`` state file; boards, tower npz and data files
    kept as they are."""
    from flax import traverse_util
    from mevi_tpu.train.checkpoints import restore_tree_host as jrestore
    from mevi_tpu_torch.weights import flax_to_state_dict
    shutil.copytree(jax_dir, out_dir)
    board_dir = osp.join(out_dir, "ckpts", "nci")
    with open(osp.join(board_dir, "leaderboard.json")) as fr:
        tags = list(json.load(fr))
    for tag in tags:
        params = jrestore(osp.abspath(osp.join(jax_dir, "ckpts", "nci",
                                               tag)))["params"]
        flat = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(params, sep="/").items()}
        shutil.rmtree(osp.join(board_dir, tag))
        os.makedirs(osp.join(board_dir, tag))
        torch.save({"model": flax_to_state_dict(flat)},
                   osp.join(board_dir, tag, "state.pt"))
    return out_dir


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_full", osp.join(REPO, "scripts", "quality_full.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return jax_bundle(tmp_path_factory, "all")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_data(jax_run, tmp_path_factory):
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.scripts import quality_full as qf
    workdir = str(tmp_path_factory.mktemp("port_data"))
    with mock.patch.dict(os.environ, TINY_ENV):
        qf.stage_data(qf.make_spec(), workdir, "cpu",
                      codebooks=np.load(osp.join(jax_run, "codebooks.npy")),
                      prefix_shift=synth.load_prefix_shift(
                          osp.join(jax_run, "prefix_shift.npz")))
    return workdir


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_stage_file_bytes_equal(jax_run, port_data, name):
    with open(osp.join(jax_run, name), "rb") as a, \
            open(osp.join(port_data, name), "rb") as b:
        assert a.read() == b.read(), name


def test_data_stage_prefix_shift_equal(jax_run, port_data):
    with np.load(osp.join(jax_run, "prefix_shift.npz")) as a, \
            np.load(osp.join(port_data, "prefix_shift.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def centred_residual_norms(workdir):
    """Each document's float64 residual norm before the spherical last
    level, from the bundle's tables, codes and prefix tables."""
    from mevi_tpu_torch.data import synth
    spec = synth.load_spec(osp.join(workdir, "spec.json"))
    cbs = np.load(osp.join(workdir, "codebooks.npy")).astype(np.float64)
    shift = synth.load_prefix_shift(osp.join(workdir, "prefix_shift.npz"))
    codes = np.load(osp.join(workdir, "codes.npy")).astype(np.int64)
    ctrs, pool = (t.astype(np.float64) for t in synth.make_tables(spec))
    dr = synth.make_draws(spec)
    x = ctrs[0][dr[:, 0]] + ctrs[1][dr[:, 1]] + ctrs[2][dr[:, 2]] + \
        pool[dr[:, 3]]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    pref = None
    for lvl in range(spec.levels - 1):
        if lvl:
            x = x - shift[lvl - 1][pref]
        x = x - cbs[lvl][codes[:, lvl]]
        pref = codes[:, lvl] if pref is None else \
            pref * spec.kary + codes[:, lvl]
    return np.linalg.norm(x - shift[-1][pref], axis=1)


def test_data_stage_codes_equal_but_rounding_noise(jax_run, port_data):
    jc = np.load(osp.join(jax_run, "codes.npy"))
    tc = np.load(osp.join(port_data, "codes.npy"))
    assert jc.dtype == tc.dtype and jc.shape == tc.shape
    noise = centred_residual_norms(jax_run) < ROUNDING_RESIDUAL
    assert noise.mean() < 0.05, noise.sum()
    np.testing.assert_array_equal(tc[~noise], jc[~noise])
    np.testing.assert_array_equal(tc[:, :-1], jc[:, :-1])


@pytest.mark.parametrize("name,index", [("codes_rows.npy", "train_order.npy"),
                                        ("dev_codes.npy", "dev_docs.npy")])
def test_data_stage_row_codes(jax_run, port_data, name, index):
    """Row-aligned codes are the port's codes of the (byte-equal) rows,
    the JAX file's bytes where no rounding-noise document is involved."""
    tc = np.load(osp.join(port_data, "codes.npy"))
    rows = np.load(osp.join(port_data, index))
    got = np.load(osp.join(port_data, name))
    np.testing.assert_array_equal(got, tc[rows])
    ok = ~(centred_residual_norms(jax_run) < ROUNDING_RESIDUAL)[rows]
    np.testing.assert_array_equal(
        got[ok], np.load(osp.join(jax_run, name))[ok])


def test_data_stage_own_fit(tmp_path):
    """Without given codebooks the port fits its own (centred) RQ and
    writes its own prefix tables; the codes are those tables' assignment."""
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.ops import rq
    from mevi_tpu_torch.scripts import quality_full as qf
    env = dict(TINY_ENV, QF_NDOC="300", QF_NDEV="16")
    with mock.patch.dict(os.environ, env):
        spec = qf.make_spec()
        qf.stage_data(spec, str(tmp_path), "cpu")
    cbs = np.load(tmp_path / "codebooks.npy")
    shift = synth.load_prefix_shift(str(tmp_path / "prefix_shift.npz"))
    assert len(shift) == spec.levels - 1
    rows = synth.gen_rows(synth.tables_to(synth.make_tables(spec), "cpu"),
                          synth.make_draws(spec))
    codes = rq.assign(rows, torch.from_numpy(cbs), "rq", "l2",
                      prefix_shift=[torch.from_numpy(t) for t in shift])
    np.testing.assert_array_equal(np.load(tmp_path / "codes.npy"),
                                  codes.numpy())


# ---------------------------------------------------------------------------
# tower
# ---------------------------------------------------------------------------

TOWER_ENV = dict(TINY_ENV, QF_TOWER_STEPS="4", QF_TOWER_SCAN="4",
                 QF_TOWER_PROBE="0")


@pytest.fixture(scope="module")
def tower_runs(jax_run, tmp_path_factory):
    """4 float32 steps of each package's tower stage from the JAX
    initial parameters; probing only at the end, so the shipped
    parameters are the last ones."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from mevi_tpu.data.synth import load_spec as jload_spec
    from mevi_tpu.models.twin_tower import tower_from_config
    from mevi_tpu_torch.data.synth import load_spec
    from mevi_tpu_torch.scripts import quality_full as qf
    dirs = {}
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(f"tower_{side}"))
        for name in ("dev_docs.npy", "dev_tokens.npy"):
            shutil.copy(osp.join(jax_run, name), d)
        dirs[side] = d
    spec_p = osp.join(jax_run, "spec.json")
    env = dict(TOWER_ENV, JAX_COMPILATION_CACHE_DIR=str(
        tmp_path_factory.mktemp("jax_cache")))
    with mock.patch.dict(os.environ, env):
        jqf = jax_script()
        jspec = jload_spec(spec_p)
        jcfg = jqf.model_cfg(jspec, dirs["jax"])
        jqf.stage_tower(jspec, dirs["jax"], jcfg)
        params = tower_from_config(jcfg.encoder).module.init(
            jax.random.PRNGKey(1), jnp.zeros((1, jspec.qlen), jnp.int32),
            jnp.ones((1, jspec.qlen), jnp.int32),
            jnp.zeros((1, 1), jnp.int32))["params"]
        init = {k: np.asarray(v) for k, v in
                traverse_util.flatten_dict(params, sep="/").items()}
        spec = load_spec(spec_p)
        qf.stage_tower(spec, dirs["port"], qf.model_cfg(spec, dirs["port"]),
                       "cpu", init_params=init)
    return dirs, init


def test_tower_steps_match_optax(tower_runs):
    dirs, init = tower_runs
    with np.load(osp.join(dirs["jax"], "tower_params.npz")) as a, \
            np.load(osp.join(dirs["port"], "tower_params.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(init)
        num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in a.files)
        den = sum(float(np.sum(a[k].astype(np.float64) ** 2))
                  for k in a.files)
        moved = sum(float(np.sum((a[k] - init[k]) ** 2)) for k in a.files)
    assert moved > 0, "the optax steps left the parameters unchanged"
    assert np.sqrt(num / den) <= 1e-4, np.sqrt(num / den)


@pytest.mark.parametrize("name", ["tower_probe.jsonl", "tower_meta.json"])
def test_tower_probe_files_equal(tower_runs, name):
    dirs, _ = tower_runs
    with open(osp.join(dirs["jax"], name)) as a, \
            open(osp.join(dirs["port"], name)) as b:
        assert [json.loads(x) for x in a] == [json.loads(x) for x in b]


def test_tower_schedule_matches_optax():
    import optax
    from mevi_tpu_torch.scripts.quality_full import warmup_cosine
    for warm, total in ((1, 4), (5, 100), (50, 1000)):
        ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warm, total, 1e-5)
        ours = warmup_cosine(0.0, 3e-4, warm, total, 1e-5)
        for c in sorted({0, 1, warm - 1, warm, warm + 1, total // 2,
                         total - 1, total, total + 5}):
            assert abs(ours(c) - float(ref(c))) <= 1e-9, (warm, total, c)


def test_tower_adamw_matches_optax():
    """Clip over the global norm, then decay on every parameter: a tree
    whose norm is above the clip and one below it."""
    import jax.numpy as jnp
    import optax
    from mevi_tpu_torch.scripts.quality_full import TowerAdamW
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(3,)).astype(np.float32)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 6, 1e-5)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(sched, weight_decay=0.01))
    jp = [jnp.asarray(x) for x in p0]
    state = opt.init(jp)
    tp = [torch.tensor(x, requires_grad=True) for x in p0]
    topt = TowerAdamW(tp, lambda c: float(sched(c)))
    for step in range(6):
        g = [rng.normal(size=x.shape).astype(np.float32)
             * (5.0 if step % 2 else 0.1) for x in p0]
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_eval(jax_run, tmp_path_factory):
    from mevi_tpu_torch.data.synth import load_spec
    from mevi_tpu_torch.scripts import quality_full as qf
    workdir = port_bundle(jax_run, str(tmp_path_factory.mktemp("pe") / "w"))
    out_p = osp.join(workdir, "QUALITY_port.json")
    with mock.patch.dict(os.environ, TINY_ENV):
        spec = load_spec(osp.join(workdir, "spec.json"))
        out = qf.stage_eval(spec, workdir, qf.model_cfg(spec, workdir),
                            out_p, "cpu")
    with open(out_p) as fr:
        assert json.load(fr) == out
    with open(osp.join(jax_run, "QUALITY.json")) as fr:
        ref = json.load(fr)
    return ref, out, workdir


def _quality_keys():
    return ("config", "ndoc", "n_dev", "coarse_hit@1", "coarse_hit@10",
            "fine_recall@1", "fine_recall@10", "fine_recall@100",
            "fine_mrr@10", "tower_exact_mips_recall@100",
            "ensemble_recall@10", "ensemble_recall@100", "ensemble_mrr@10",
            "ensemble_best_weights", "ensemble_best_recall@10",
            "ensemble_best_recall@100", "ensemble_best_mrr@10",
            "ensemble_mrr_best_weights", "ensemble_mrr_best_recall@100",
            "ensemble_mrr_best_mrr@10", "beam_major_fine_recall@1",
            "beam_major_fine_recall@10", "beam_major_fine_recall@100",
            "beam_major_fine_mrr@10", "ann_recall@100", "ann_mrr@10",
            "overlap_ann_fine@100", "ensemble_rrf_recall@100",
            "ensemble_rrf_mrr@10", "oracle_tower_served_fine",
            "ndoc_per_query", "beams", "cap", "pool", "top_beam_level_acc",
            "top_beam_prefix_acc", "bayes_recall@1", "bayes_recall@10",
            "bayes_recall@100", "bayes_mrr@10", "bayes_coarse_hit@10",
            "mean_candidates", "median_candidates", "p_all_observed",
            "oracle_tower_recall@1", "oracle_tower_recall@10",
            "oracle_tower_recall@100", "oracle_tower_mrr@10",
            "fine_recall@100_vs_oracle_tower", "coarse_hit@10_vs_bayes",
            "nci_ckpt", "tower_ckpt")


def test_eval_quality_has_every_jax_key(port_eval):
    ref, out, _ = port_eval
    assert set(out) == set(ref)
    assert set(ref) == set(_quality_keys()) | set(TIMING_KEYS)


def _close(a, b, tol=1e-4):
    """Discrete leaves (ints, strings, bools, lists of them) equal; float
    leaves within ``tol``."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol)
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y, tol)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol
    return a == b


@pytest.mark.parametrize("key", _quality_keys())
def test_eval_quality_key_matches_jax(port_eval, key):
    ref, out, _ = port_eval
    assert _close(ref[key], out[key]), (key, ref[key], out[key])


def test_eval_served_arrays_match_jax(port_eval, jax_run):
    _, _, workdir = port_eval
    with np.load(osp.join(jax_run, "served_eval.npz")) as a, \
            np.load(osp.join(workdir, "served_eval.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("fine_ids", "beam_codes", "ndoc", "dev_docs"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("fine_scores", "beam_scores"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_bundle_complete_and_incomplete_raises(port_eval, tmp_path):
    from mevi_tpu_torch import bench
    _, _, workdir = port_eval
    assert bench.bundle_complete(workdir)
    cut = str(tmp_path / "cut")
    shutil.copytree(workdir, cut)
    os.remove(osp.join(cut, "tower_params.npz"))
    assert not bench.bundle_complete(cut)
    with pytest.raises(FileNotFoundError, match="incomplete bundle"):
        bench.run(400, {}, device="cpu", ckpt=cut)
