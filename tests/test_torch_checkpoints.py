"""Checkpoints of the port: ``CheckpointManager`` (the JAX package's three
behaviours, ``tests/test_datasets_ckpt.py``), a bitwise save/restore of
model and optimizer, the flax-path npz of either package loading into
the other's model with equal logits, and the weight bridge's exact round
trip in both directions."""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mevi_tpu.models import nci as jnci
from mevi_tpu.models import t5 as jt5
from mevi_tpu.train import checkpoints as jck
from mevi_tpu_torch.config import TrainConfig
from mevi_tpu_torch.models import bert as pbert
from mevi_tpu_torch.models import nci as pnci
from mevi_tpu_torch.models import t5 as pt5
from mevi_tpu_torch.models.twin_tower import Tower
from mevi_tpu_torch.train import trainer as PT
from mevi_tpu_torch.train.checkpoints import (CheckpointManager,
                                              load_params_npz,
                                              restore_tree_host,
                                              save_params_npz)
from mevi_tpu_torch.train.joint import JointModel
from mevi_tpu_torch.weights import (flax_to_state_dict, init_random_,
                                    load_flax_params, state_dict_to_flax)

B, LQ, M, KARY = 3, 6, 2, 4
T5KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
            num_layers=2, num_decoder_layers=2)
NCIKW = dict(kary=KARY, max_output_length=M + 2, adaptor_layer_num=2,
             adaptor_num_heads=4, adaptor_d_ff=64)


def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2,
                            monitor="recall", mode="max")
    state = {"w": torch.ones(2, 2)}
    assert mgr.save("e1", state, metric=0.5) is not None
    assert mgr.save("e2", state, metric=0.7) is not None
    assert mgr.save("e3", state, metric=0.2) is None     # below top-2
    assert mgr.save("e4", state, metric=0.9) is not None  # evicts e1
    assert mgr.best_tag() == "e4"
    torch.testing.assert_close(mgr.restore("e4")["w"], torch.ones(2, 2))
    assert not osp.exists(str(tmp_path / "ck" / "e1"))


def test_checkpoint_manager_from_dir_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2,
                            monitor="dev_hit10", mode="max")
    state = {"w": torch.ones(2)}
    mgr.save("e0", state, metric=0.3)
    mgr.save("e1", state, metric=0.8)
    re = CheckpointManager.from_dir(str(tmp_path / "ck"))
    assert (re.monitor, re.mode) == ("dev_hit10", "max")
    assert re.best_tag() == "e1"
    # boards without meta fall back to loss/min
    os.remove(str(tmp_path / "ck" / "leaderboard.meta.json"))
    legacy = CheckpointManager.from_dir(str(tmp_path / "ck"))
    assert (legacy.monitor, legacy.mode) == ("loss", "min")
    assert legacy.best_tag() == "e0"


def test_checkpoint_manager_monitor_change_demotes_stale(tmp_path):
    d = str(tmp_path / "ck")
    old = CheckpointManager(d, keep=2, monitor="loss", mode="min")
    state = {"w": torch.ones(2)}
    old.save("s100", state, metric=2.31)
    old.save("s200", state, metric=1.97)
    new = CheckpointManager(d, keep=2, monitor="dev_hit10", mode="max")
    assert new.best_tag() in ("s100", "s200")
    assert new.save("s300", state, metric=0.41) is not None
    assert new.save("s400", state, metric=0.55) is not None
    assert new.best_tag() == "s400"
    assert set(new._board) == {"s300", "s400"}
    assert osp.exists(osp.join(d, "leaderboard.prev.json"))
    again = CheckpointManager(d, keep=2, monitor="dev_hit10", mode="max")
    assert again.best_tag() == "s400"
    assert again._board["s400"] == 0.55


def _port_nci(seed=0):
    dims = pnci.NCIDims(t5=pt5.T5Dims(dropout_rate=0.0, **T5KW), **NCIKW)
    return init_random_(pnci.NCIT5(dims, device="cpu"), seed)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"query_ids": rng.integers(2, 60, (B, LQ)).astype(np.int32),
             "query_mask": np.ones((B, LQ), np.int32),
             "codes": rng.integers(0, KARY, (B, M)).astype(np.int32)}
            for _ in range(n)]


def _trainer(model, accumulation):
    cfg = TrainConfig(learning_rate=1e-3, decoder_learning_rate=5e-4,
                      weight_decay=0.1, gradient_accumulation=accumulation)
    opt = PT.make_optimizer(cfg, model, total_steps=8)
    return PT.init_state(model, opt), PT.make_nci_train_step(model)


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b.cpu())
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("accumulation", [1, 2])
def test_save_restore_bitwise(tmp_path, accumulation):
    """Parameters and optimizer state restore bit for bit (mid-way
    through an accumulation window too), and training goes on from the
    restored state exactly as from the live one."""
    batches = _batches(4)
    model = _port_nci()
    state, step = _trainer(model, accumulation)
    gen = torch.Generator().manual_seed(0)
    for b in batches[:3]:
        state, _ = step(state, b, gen)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, monitor="loss",
                            mode="min")
    live = {"model": model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step,
            "epoch": 0}
    mgr.save("epoch0", live, metric=1.0)
    restored = mgr.restore(mgr.best_tag())
    _equal_trees(live, restored)
    _equal_trees(restore_tree_host(str(tmp_path / "ck" / "epoch0")),
                 restored)

    model2 = _port_nci(seed=9)
    state2, step2 = _trainer(model2, accumulation)
    model2.load_state_dict(restored["model"])
    state2.optimizer.load_state_dict(restored["optimizer"])
    state2.step = restored["step"]
    gen2 = torch.Generator().manual_seed(7)
    gen.manual_seed(7)
    state, _ = step(state, batches[3], gen)
    state2, _ = step2(state2, batches[3], gen2)
    _equal_trees(model.state_dict(), model2.state_dict())
    _equal_trees(state.optimizer.state_dict(), state2.optimizer.state_dict())


@pytest.fixture(scope="module")
def jax_nci():
    jmodel = jnci.NCIT5(jnci.NCIDims(t5=jt5.T5Dims(dropout_rate=0.0,
                                                   **T5KW), **NCIKW))
    b = _batches(1)[0]
    _, dec_in = jnci.make_labels(jnp.asarray(b["codes"]), KARY, M + 2)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(b["query_ids"]),
                                  jnp.asarray(b["query_mask"]), dec_in
                                  )["params"]
    return jmodel, params, b, np.array(dec_in)


def _logits_close(jmodel, params, model, b, dec_in):
    ref = jax.jit(jmodel.apply)({"params": params},
                                jnp.asarray(b["query_ids"]),
                                jnp.asarray(b["query_mask"]),
                                jnp.asarray(dec_in))[0]
    with torch.no_grad():
        got = model(torch.from_numpy(b["query_ids"]),
                    torch.from_numpy(b["query_mask"]),
                    torch.from_numpy(dec_in))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)


def test_jax_npz_loads_into_the_port(tmp_path, jax_nci):
    jmodel, params, b, dec_in = jax_nci
    path = str(tmp_path / "nci.npz")
    jck.save_params_npz(path, params)
    model = load_flax_params(_port_nci(seed=3), load_params_npz(path))
    _logits_close(jmodel, params, model, b, dec_in)


def test_port_npz_loads_into_jax(tmp_path, jax_nci):
    jmodel, _, b, dec_in = jax_nci
    model = _port_nci(seed=4)
    path = str(tmp_path / "nci.npz")
    save_params_npz(path, model)
    params = jax.tree.map(jnp.asarray, jck.load_params_npz(path))
    _logits_close(jmodel, params, model, b, dec_in)


def _models():
    t5 = pt5.T5Dims(**T5KW)
    bert = pbert.BertEncoderModel(pbert.BertDims(
        vocab_size=64, d_model=32, num_layers=2, num_heads=4, d_ff=64,
        max_position_embeddings=16), device="cpu")
    return {
        "nci": _port_nci(),
        "nci_untied": init_random_(pnci.NCIT5(pnci.NCIDims(
            t5=t5, tie_decode_embedding=False, **NCIKW), device="cpu"), 5),
        "t5_model": init_random_(pt5.T5Model(t5, device="cpu"), 5),
        "t5_encoder": init_random_(pt5.T5EncoderModel(t5, device="cpu"), 5),
        "bert": init_random_(bert, 5),
        "joint": JointModel(_port_nci(), Tower("bert", bert),
                            torch.randn(M, KARY, 32)),
    }


@pytest.mark.parametrize("name", ["nci", "nci_untied", "t5_model",
                                  "t5_encoder", "bert", "joint"])
def test_weight_bridge_round_trip(name):
    model = _models()[name]
    flat = state_dict_to_flax(model)
    sd = flax_to_state_dict(flat)
    _equal_trees(dict(model.state_dict()), sd)
    again = state_dict_to_flax(load_flax_params(model, flat))
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])
