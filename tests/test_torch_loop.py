"""The port's ``TrainLoop`` (``mevi_tpu_torch.train.loop``), on the CPU at
a tiny config: the alternating schedule equals the JAX package's; the
refit's codes are ``assign`` under the Hungarian-aligned books;
``validate`` is the port's ``Evaluator`` on the same inputs; a resumed
run restores the state bit for bit and, continuing at the next epoch,
ends bit-equal to the uninterrupted run.

The RQ refit draws from a torch generator, so its codebooks are not the
JAX package's; the loop is held on its own terms there."""

import numpy as np
import pytest
import torch

from mevi_tpu_torch.config import (EncoderConfig, InferConfig, MEVIConfig,
                                   RQConfig, TrainConfig)
from mevi_tpu_torch.eval.run_eval import Evaluator
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5Model
from mevi_tpu_torch.ops import rq as rq_ops
from mevi_tpu_torch.train import trainer as T
from mevi_tpu_torch.train.loop import LoopConfig, TrainLoop
from mevi_tpu_torch.weights import init_random_

KARY, M, N = 4, 2, 40


@pytest.fixture()
def world(tmp_path):
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=M, subvector_bits=2, emb_size=16),
        encoder=EncoderConfig(d_model=16),
        train=TrainConfig(train_batch_size=8, eval_batch_size=8,
                          encode_batch_size=16, learning_rate=5e-3,
                          decoder_learning_rate=5e-3, warmup_steps=0),
        infer=InferConfig(num_return_sequences=3, recall_num=(1, 5),
                          max_cluster_docs=32))
    cfg.finalize()
    t5 = T5Dims(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_heads=4,
                num_layers=1, num_decoder_layers=1, dropout_rate=0.0)
    tower = init_random_(T5Model(t5, device="cpu"), 1)
    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(2, 60, (N, 8)).astype(np.int32)
    doc_masks = np.ones_like(doc_tokens)

    def tower_rep(ids, mask):
        with torch.inference_mode():
            return tower.first_token_rep(ids, mask)

    def make_state(seed=0):
        nci = init_random_(NCIT5(NCIDims(
            t5=t5, kary=KARY, max_output_length=M + 2, adaptor_layer_num=1,
            adaptor_num_heads=4, adaptor_d_ff=32), device="cpu"), seed)
        opt = T.make_optimizer(cfg.train, nci, total_steps=100)
        return nci, T.init_state(nci, opt), T.make_nci_train_step(nci)
    return dict(cfg=cfg, tower_rep=tower_rep, doc_tokens=doc_tokens,
                doc_masks=doc_masks, make_state=make_state, tmp=tmp_path)


def make_loop(w, tag, loop, nci=None, steps=None, state=None,
              dataset_fn=None, **kw):
    return TrainLoop(w["cfg"], loop, nci, steps or {}, state, dataset_fn,
                     tower_rep=w["tower_rep"], doc_tokens=w["doc_tokens"],
                     doc_masks=w["doc_masks"],
                     ckpt_dir=str(w["tmp"] / f"ck_{tag}"),
                     log_dir=str(w["tmp"] / f"log_{tag}"), device="cpu",
                     **kw)


def test_alt_stage_schedule_equals_jax(world):
    from mevi_tpu.train.loop import LoopConfig as JLoop
    from mevi_tpu.train.loop import TrainLoop as JTrainLoop
    for alt in ((2, 3), (1, 2), None):
        tl = make_loop(world, "s", LoopConfig(alt_epochs=alt),
                       steps={"nci": None, "twin": None})
        jl = JTrainLoop(world["cfg"], JLoop(alt_epochs=alt), None,
                        steps={"nci": None, "twin": None}, state=None,
                        dataset_fn=None,
                        ckpt_dir=str(world["tmp"] / "jck"),
                        log_dir=str(world["tmp"] / "jlog"))
        assert [tl.stage_for_epoch(e) for e in range(7)] == \
            [jl.stage_for_epoch(e) for e in range(7)]
    tl = make_loop(world, "s2", LoopConfig(alt_epochs=(2, 3)),
                   steps={"nci": None, "twin": None})
    assert [tl.stage_for_epoch(e) for e in range(6)] == [
        "nci", "nci", "twin", "nci", "nci", "twin"]


def test_regenerate_index_aligned_codes(world):
    """First refit: the fit's own codes.  Second refit (another seed):
    the books are a per-level permutation of the new fit aligned to the
    first, the codes are ``assign`` under them, and most labels stay."""
    w = world
    tl = make_loop(w, "r", LoopConfig(rq_iters=6))
    tl.regenerate_index()
    assert tl.doc_codes.shape == (N, M)
    assert tl.fine_index is not None
    assert set(tl.refit_stats) == {"embed_s", "refit_s", "csr_s"}
    codes1 = tl.doc_codes.copy()
    tl.loop = LoopConfig(rq_iters=6, seed=7)
    tl.regenerate_index()
    emb = torch.cat([w["tower_rep"](torch.from_numpy(w["doc_tokens"][s:s + 16]),
                                    torch.from_numpy(w["doc_masks"][s:s + 16]))
                     for s in range(0, N, 16)])
    want = rq_ops.assign(emb, torch.from_numpy(tl.codebooks).float(),
                         "rq", w["cfg"].rq.dist_mode).numpy()
    np.testing.assert_array_equal(tl.doc_codes, want)
    assert {"align_s", "unchanged_aligned",
            "unchanged_unaligned"} <= set(tl.refit_stats)
    assert tl.refit_stats["unchanged_aligned"] == (codes1 == want).all(1).mean()
    assert tl.refit_stats["unchanged_aligned_by_level"] == [
        float(x) for x in (codes1 == want).mean(0)]
    assert (codes1 == tl.doc_codes).mean() > 0.5
    # the CSR of the fine index lays out the aligned codes
    off = tl.fine_index.host_offsets
    ids = tl.fine_index.host_doc_ids
    packed = tl.doc_codes[:, 0] * KARY + tl.doc_codes[:, 1]
    for c in range(KARY ** M):
        assert (packed[ids[off[c]:off[c + 1]]] == c).all()


def test_validate_is_the_evaluator(world):
    w = world
    nci, _, _ = w["make_state"]()
    tl = make_loop(w, "v", LoopConfig(rq_iters=4), nci=nci)
    assert tl.validate() == {}                 # no eval set yet
    tl.regenerate_index()
    ev_in = dict(queries=[f"q{i}" for i in range(12)],
                 query_ids=w["doc_tokens"][:12],
                 query_mask=w["doc_masks"][:12],
                 gt_docids=[[i] for i in range(12)])
    tl.eval_inputs = ev_in
    val = tl.validate(w["tower_rep"])
    out = Evaluator(nci, w["cfg"].infer, fine_index=tl.fine_index,
                    query_rep_fn=w["tower_rep"], doc_codes=tl.doc_codes,
                    device="cpu").evaluate(
        ev_in["queries"], ev_in["query_ids"], ev_in["query_mask"],
        ev_in["gt_docids"], batch_size=w["cfg"].train.eval_batch_size)
    want = {f"coarse_recall{k}": v for k, v in out.coarse["recall"].items()}
    want.update({f"recall{k}": v for k, v in out.fine["recall"].items()})
    want.update({f"mrr{k}": v for k, v in out.fine["mrr"].items()})
    want["ndoc"] = out.ndoc_per_query
    assert val == want


def _dataset(tl, w):
    def dataset_fn(epoch):
        codes = tl.doc_codes.astype(np.int32)
        order = np.random.default_rng(epoch).permutation(N)
        for s in range(0, N, 8):
            i = order[s:s + 8]
            yield {"query_ids": w["doc_tokens"][i],
                   "query_mask": w["doc_masks"][i], "codes": codes[i]}
    return dataset_fn


def _run(w, tag, epochs):
    nci, state, step = w["make_state"]()
    tl = make_loop(w, tag, LoopConfig(num_epochs=epochs, val_every=1,
                                      rq_iters=4, monitor="recall5"),
                   nci=nci, steps={"nci": step}, state=state)
    tl.regenerate_index()
    tl.dataset_fn = _dataset(tl, w)
    tl.eval_inputs = dict(
        queries=[f"q{i}" for i in range(16)],
        query_ids=w["doc_tokens"][:16], query_mask=w["doc_masks"][:16],
        gt_docids=[[i] for i in range(16)])
    return tl, tl.run(query_rep_fn=w["tower_rep"])


def test_loop_trains_checkpoints_and_resumes_bit_for_bit(world):
    w = world
    tl, state = _run(w, "a", 3)
    assert state.step == 3 * (N // 8)
    assert tl.ckpts.best_tag() is not None
    assert tl.last_validation["recall5"] > 0.5, tl.last_validation
    # a resumed run: the epoch-1 checkpoint restored exactly, epoch 2 run
    # from there, the end state bit-equal to the uninterrupted run's
    import shutil
    shutil.copytree(str(w["tmp"] / "ck_a"), str(w["tmp"] / "ck_b"))
    nci, st, step = w["make_state"](seed=9)     # other initial weights
    tl_b = make_loop(w, "b", LoopConfig(num_epochs=3, rq_iters=4,
                                        monitor="recall5"),
                     nci=nci, steps={"nci": step}, state=st)
    saved = tl_b.ckpts.restore("epoch1")
    assert tl_b.resume("epoch1")
    assert tl_b.start_epoch == 2 and tl_b.state.step == 2 * (N // 8)
    for k, v in saved["model"].items():
        assert torch.equal(nci.state_dict()[k], v), k
    tl_b.regenerate_index()
    np.testing.assert_array_equal(tl_b.doc_codes, tl.doc_codes)
    tl_b.dataset_fn = _dataset(tl_b, w)
    tl_b.eval_inputs = tl.eval_inputs
    end = tl_b.run(query_rep_fn=w["tower_rep"])
    assert end.step == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(end.model.state_dict()[k], v), k
    a_opt, b_opt = state.optimizer.state_dict(), end.optimizer.state_dict()
    assert a_opt["count"] == b_opt["count"]
    for sid, s in a_opt["adamw"]["state"].items():
        for name, t in s.items():
            assert torch.equal(b_opt["adamw"]["state"][sid][name], t)


def test_no_eval_set_ranks_by_loss(world):
    w = world
    nci, state, step = w["make_state"]()
    tl = make_loop(w, "l", LoopConfig(num_epochs=2, rq_iters=4), nci=nci,
                   steps={"nci": step}, state=state)
    tl.regenerate_index()
    tl.dataset_fn = _dataset(tl, w)
    tl.run()
    board = tl.ckpts._board
    assert set(board) == {"epoch0", "epoch1"}
    assert all(v <= 0 for v in board.values())      # -loss, mode max
