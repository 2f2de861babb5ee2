"""Full-configuration retrieval-quality run (port of
``scripts/quality_full.py``): the whole pipeline over the synthetic
corpus of :mod:`mevi_tpu_torch.data.synth`, at the reference's model
size by default (T5-base NCI 12 + 6, d 768, PAWA 4 layers; a t5-base
tower 12 + 12; RQ 4 x 32; bf16 compute), trained by the port and
evaluated through ``BucketServer`` (the v3 bucket kernel, ``align=8``).

    python -m mevi_tpu_torch.scripts.quality_full [--device cuda|cpu]

Stages (``QF_STAGE=data|train|tower|eval|sharded|all``, comma-separated;
``all`` is the first four, as in the JAX script):
  data   the corpus spec, the RQ fit and codes, ``prefix_shift.npz``, the
         train utterance token memmaps with their row-aligned codes, and a
         dev utterance set;
  train  ``mevi_tpu_torch.cli.main train`` in this process (the JAX
         flags less ``--scan_steps``, plus ``--device``), checkpoints
         through ``CheckpointManager`` under ``<workdir>/ckpts/nci``;
  tower  the query tower trained contrastively against the fixed
         document rows (in-batch plus per-anchor hard negatives), with a
         dev exact-MIPS probe that keeps the best parameters;
  eval   dev queries served through ``BucketServer`` with the trained
         tower and NCI: coarse hits, fine recalls, MRR, the ANN /
         ensemble / RRF legs, beam-major order, the oracle tower and the
         Bayes bounds, written as a QUALITY json (the JAX json's keys);
  sharded  the trained bundle in float32 served through
         ``ShardedBucketServer`` in spawned ranks (``parallel.mesh.
         launch_local``, gloo; on the card every rank shares it) on a
         data 2 x corpus 4 mesh, and through the single-device path
         (``nci_beam_search_incremental``, ``first_token_rep``,
         ``eval.searcher.fine_rerank``): beam codes equal, the canonical
         (-score, id) metrics equal and the top-100 overlap above 0.99,
         written as ``SHARDED_PARITY.json`` (the JAX keys, and the
         ranks' v3 launches as ``bucket_launches``).  The JAX
         stage's XLA flags for its virtual CPU mesh have no counterpart.

Host draws come from numpy generators with the JAX script's seeds,
consumed in its order, so the same spec gives the same files.

Environment knobs read (the JAX script's names and defaults):
``QF_WORKDIR`` (default ``<tempdir>/mevi_tpu_torch_quality``, outside
the repository), ``QF_OUT``, ``QF_TINY`` (CPU geometry), ``QF_NDOC``,
``QF_NOISE``, ``QF_RQ_CENTER``, ``QF_UTT``, ``QF_NDEV``, ``QF_BATCH``,
``QF_EPOCHS``, ``QF_RESUME``, ``QF_TOWER_BATCH``, ``QF_TOWER_SCAN``
(steps a host draw), ``QF_TOWER_HN``, ``QF_TOWER_STEPS``,
``QF_TOWER_LR``, ``QF_TOWER_ALIGN``, ``QF_TOWER_NORM_W``,
``QF_TOWER_NPROBE``, ``QF_TOWER_PROBE``, ``QF_TOWER_SAVE_EVERY``,
``QF_TOWER_RESUME``, ``QF_CAP``, ``QF_BEAMS``, ``QF_POOL``,
``QF_EVAL_BATCH``, ``QF_SHARD_B``, ``QF_SHARD_DUMP``.  Not read: ``QF_SCAN`` (a TPU dispatch knob) and ``QF_FORCE_CPU``
(``--device cpu`` instead).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import os.path as osp
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def env_int(name, default):
    return int(os.environ.get(name, default))


def tiny() -> bool:
    return bool(os.environ.get("QF_TINY"))


def default_workdir() -> str:
    return osp.join(tempfile.gettempdir(), "mevi_tpu_torch_quality")


def make_spec():
    from ..data.synth import SynthSpec
    # info_dropout makes queries ambiguous, so the beam ranks under
    # uncertainty (a clean language is a lookup learnt to ~0 loss)
    noise = float(os.environ.get("QF_NOISE", 0.15))
    if tiny():
        return SynthSpec(ndoc=env_int("QF_NDOC", 3000), d=32, kary=8,
                         levels=3, pool_n=64, scales=(1.0, 0.4, 0.2),
                         zipf=(1.0, 0.6, 0.3), eps=0.05, seed=5,
                         qlen=16, n_filler_vocab=32, info_dropout=noise)
    return SynthSpec(ndoc=env_int("QF_NDOC", 1_000_000), seed=5,
                     info_dropout=noise)


def model_cfg(spec, workdir):
    """MEVIConfig at the reference's full size (T5-base NCI + PAWA-4,
    ``MEVI/main.py:755-761``), bf16 compute; the tiny variant for the
    CPU."""
    from ..config import (EncoderConfig, MEVIConfig, ModelConfig, RQConfig,
                          TrainConfig)
    if tiny():
        m = ModelConfig(num_layers=2, num_decoder_layers=2, d_model=32,
                        d_kv=8, d_ff=64, num_heads=4, adaptor_layer_num=1,
                        adaptor_num_heads=4, dropout_rate=0.0,
                        vocab_size=spec.vocab_size, kary=spec.kary,
                        max_output_length=spec.levels + 2)
        enc = EncoderConfig(family="t5", d_model=32, num_layers=2,
                            num_heads=4, d_ff=64,
                            t5_vocab_size=spec.vocab_size)
    else:
        m = ModelConfig(num_layers=12, num_decoder_layers=6, d_model=768,
                        d_kv=64, d_ff=3072, num_heads=12,
                        adaptor_layer_num=4, adaptor_num_heads=12,
                        dropout_rate=0.0, vocab_size=spec.vocab_size,
                        kary=spec.kary, max_output_length=spec.levels + 2,
                        dtype="bfloat16")
        enc = EncoderConfig(family="t5", d_model=768, num_layers=12,
                            num_heads=12, d_ff=3072,
                            t5_vocab_size=spec.vocab_size, dtype="bfloat16")
    cfg = MEVIConfig(
        rq=RQConfig(subvector_num=spec.levels,
                    subvector_bits=int(np.log2(spec.kary)),
                    emb_size=spec.d),
        model=m, encoder=enc,
        train=TrainConfig(
            train_batch_size=env_int("QF_BATCH", 16 if tiny() else 512),
            num_train_epochs=env_int("QF_EPOCHS", 2 if tiny() else 8),
            learning_rate=2e-4, decoder_learning_rate=1e-4,
            warmup_steps=4 if tiny() else 1000),
        ckpt_dir=osp.join(workdir, "ckpts"))
    return cfg.finalize()


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def stage_data(spec, workdir, device="cuda", codebooks=None,
               prefix_shift=None):
    """Corpus spec, RQ codes and utterance files under ``workdir``.

    ``codebooks`` (and, with ``QF_RQ_CENTER``, ``prefix_shift``, the
    per-level conditioning tables) stand in for the RQ fit: the codes are
    assigned with them.  The port's fit draws from a torch generator, so
    only given the JAX fit's tables are the files the JAX script's; even
    then the last code of a document alone in its prefix can differ (its
    centred residual is rounding noise, ``ops.rq.assign``)."""
    from ..data import synth
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    synth.save_spec(spec, osp.join(workdir, "spec.json"))
    tab = synth.make_tables(spec)
    draws = synth.make_draws(spec)
    t0 = time.time()
    # centred levels (the JAX default since its round 5) keep the last
    # level from collapsing onto one leaf per prefix (ops.rq.rq_train)
    center = os.environ.get("QF_RQ_CENTER", "1") == "1"
    if codebooks is None:
        cbs, codes = synth.fit_rq_codes(spec, tab, draws,
                                        center_levels=center, device=dev)
        if center:
            prefix_shift = synth.load_prefix_shift(osp.join(
                spec.cache_dir() + "_hrq", "prefix_shift.npz"))
    else:
        if center and prefix_shift is None:
            raise ValueError("centred codebooks need their prefix_shift")
        cbs, codes = synth.fit_rq_codes(
            spec, tab, draws, codebooks=codebooks,
            prefix_shift=prefix_shift if center else None, device=dev)
    log(f"RQ fit+assign: {time.time() - t0:.1f}s")
    leaves = len(np.unique(
        (codes.astype(np.int64)
         * (spec.kary ** np.arange(spec.levels - 1, -1, -1))).sum(1)))
    log(f"distinct leaf codes: {leaves}")
    np.save(osp.join(workdir, "codebooks.npy"), cbs)
    np.save(osp.join(workdir, "codes.npy"), codes)
    if center:
        # part of the quantizer: bench's bigger-corpus re-assign needs it
        np.savez(osp.join(workdir, "prefix_shift.npz"),
                 **{f"l{i + 1}": np.asarray(t, np.float32)
                    for i, t in enumerate(prefix_shift)})

    U = env_int("QF_UTT", 4)
    n_rows = spec.ndoc * U
    host = np.random.default_rng(spec.seed + 21)
    order = host.permutation(
        np.repeat(np.arange(spec.ndoc, dtype=np.int64), U))
    t0 = time.time()
    # int64 (n, L) tokens + masks (prepare_passage_tokenized.py:83-88)
    ids_mm = np.memmap(osp.join(workdir, "trainq_tokens.bin"), np.int64,
                       "w+", shape=(n_rows, spec.qlen))
    mask_mm = np.memmap(osp.join(workdir, "trainq_masks.bin"), np.int64,
                        "w+", shape=(n_rows, spec.qlen))
    CH = 1 << 19
    for s in range(0, n_rows, CH):
        e = min(n_rows, s + CH)
        ids_mm[s:e] = synth.query_tokens(spec, draws[order[s:e]], host)
        mask_mm[s:e] = 1
    ids_mm.flush()
    mask_mm.flush()
    del ids_mm, mask_mm
    np.save(osp.join(workdir, "codes_rows.npy"), codes[order])
    np.save(osp.join(workdir, "train_order.npy"), order)
    log(f"train utterances {n_rows}: {time.time() - t0:.1f}s")

    n_dev = env_int("QF_NDEV", 2048)
    dev_docs = host.integers(0, spec.ndoc, n_dev)
    dev_tok = synth.query_tokens(spec, draws[dev_docs],
                                 np.random.default_rng(spec.seed + 99))
    np.save(osp.join(workdir, "dev_docs.npy"), dev_docs)
    np.save(osp.join(workdir, "dev_tokens.npy"), dev_tok)
    # gt codes of the between-epoch dev probe (checkpoints rank on
    # coarse hit@10, not on the train loss)
    np.save(osp.join(workdir, "dev_codes.npy"), codes[dev_docs])
    log("data stage done")


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def stage_train(spec, workdir, cfg, device="cuda"):
    """The NCI through the port's ``train`` command, in this process."""
    from ..cli.main import main as cli_main
    cfgp = osp.join(workdir, "cfg.json")
    with open(cfgp, "w") as fw:
        fw.write(cfg.to_json())
    argv = ["train", "--config", cfgp,
            "--queries", osp.join(workdir, "trainq"),
            "--query_length", str(spec.qlen),
            "--codes", osp.join(workdir, "codes_rows.npy"),
            "--log_every", "512", "--log_dir", workdir,
            "--device", str(device)]
    dev_codes = osp.join(workdir, "dev_codes.npy")
    if osp.exists(dev_codes):
        argv += ["--dev_queries", osp.join(workdir, "dev_tokens.npy"),
                 "--dev_codes", dev_codes]
    if os.environ.get("QF_RESUME"):
        argv += ["--resume", "best"]
    log("train:", " ".join(argv))
    cli_main(argv)


# --------------------------------------------------------------------------
# tower
# --------------------------------------------------------------------------

def _hard_negative_draws(spec, anchor_draws, host, hn):
    """(B, 4) anchor draws -> (B, hn, 4) hard negatives: the same
    hierarchy prefix with a fresh pool row (within-leaf distractors),
    and with probability 1/4 the last hierarchy level resampled too
    (cross-sibling distractors); the reference mines in-cluster hard
    negatives for its co-loss (``main_models.py:1813-1950``)."""
    B = len(anchor_draws)
    neg = np.repeat(anchor_draws[:, None, :], hn, axis=1).copy()
    neg[:, :, 3] = host.integers(0, spec.pool_n, (B, hn))
    flip = host.random((B, hn)) < 0.25
    neg[:, :, 2] = np.where(flip, host.integers(0, spec.kary, (B, hn)),
                            neg[:, :, 2])
    return neg


def warmup_cosine(init_value, peak_value, warmup_steps, decay_steps,
                  end_value):
    """``optax.warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} <= warmup_steps "
                         f"{warmup_steps}")

    def schedule(count):
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)
    return schedule


class TowerAdamW:
    """The tower's optimizer, ``optax.chain(clip_by_global_norm(max_norm),
    adamw(schedule, weight_decay))``: one clip over the global norm of
    every gradient, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias
    corrected) plus decoupled weight decay on every parameter (optax's
    ``mask=None``: biases and norm scales decay too), scaled by the
    schedule at the step count before the update."""

    def __init__(self, params, schedule, max_norm=1.0, weight_decay=0.01,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params = [p for p in params]
        self.schedule = schedule
        self.max_norm, self.wd = max_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        """One update, in multi-tensor (``_foreach``) ops: a few kernels
        a step for every parameter, where a loop launches a dozen a
        parameter."""
        grads = [p.grad for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # optax: where(g_norm < max_norm, g, g / g_norm * max_norm)
        scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                            self.max_norm / g_norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        g = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        # p - lr * (upd + wd * p)
        torch._foreach_add_(upd, self.params, alpha=self.wd)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(self.params, upd)


def stage_tower(spec, workdir, cfg, device="cuda", init_params=None):
    """Query tower: tokens -> embedding, trained contrastively against
    the fixed document rows.  In-batch negatives plus ``QF_TOWER_HN``
    hard negatives an anchor (one cross entropy over the grouped layout
    ``[q0_pos, q0_negs..., q1_pos, ...]``), an alignment term and a
    norm pull; a dev exact-MIPS probe every ``QF_TOWER_PROBE`` steps
    keeps the best parameters by (recall@100, mrr@10), the
    recall-monitored checkpoint of ``MEVI/main.py:89-170``.

    ``init_params``: flattened flax parameters to start from (the JAX
    script initializes from ``PRNGKey(1)``; without them the port's
    seeded init with seed 1).  Host draws (``default_rng(seed + 31)``)
    are consumed as the JAX script consumes them: ``QF_TOWER_SCAN``
    steps of tokens and negatives drawn at a time."""
    from ..data import synth
    from ..eval.ceiling import exact_mips_topk
    from ..models.twin_tower import contrastive_loss, tower_from_config
    from ..train.checkpoints import load_params_npz, save_params_npz
    from ..train.trainer import compute_autocast
    from ..weights import init_random_, load_flax_params

    dev = resolve_device(device)
    tab = synth.make_tables(spec)
    tables = synth.tables_to(tab, dev)
    draws = synth.make_draws(spec)
    tower = tower_from_config(cfg.encoder, device=dev).module
    if init_params is not None:
        load_flax_params(tower, init_params)
    else:
        init_random_(tower, 1)
    cdt = tower.dims.dtype
    B = env_int("QF_TOWER_BATCH", 256)
    K = env_int("QF_TOWER_SCAN", 8)
    HN = env_int("QF_TOWER_HN", 7)      # co_neg_num=7, main.py:537
    steps = env_int("QF_TOWER_STEPS", 40 if tiny() else 24000)
    part = osp.join(workdir, "tower_params.partial.npz")
    start = 0
    if os.environ.get("QF_TOWER_RESUME") and osp.exists(part):
        # parameters only (a fresh optimizer), loaded before the
        # schedule so that it spans only the steps this run takes
        meta = (np.load(part + ".step.npy") if osp.exists(part + ".step.npy")
                else np.asarray(0))
        load_flax_params(tower, load_params_npz(part))
        start = int(meta)
        log(f"tower resumed from step {start}")
    tower.requires_grad_(True)
    tower.train()
    run_steps = max(steps - start, 1)
    peak_lr = float(os.environ.get("QF_TOWER_LR",
                                   3e-4 if start == 0 else 1e-4))
    opt = TowerAdamW(tower.parameters(), warmup_cosine(
        0.0, peak_lr, max(run_steps // 20, 1), run_steps, 1e-5))
    align_w = float(os.environ.get("QF_TOWER_ALIGN", 4.0))
    norm_w = float(os.environ.get("QF_TOWER_NORM_W", 0.01))

    def loss_fn(tok, pdr):
        p_rep = synth.gen_rows(tables, pdr)       # (B*(1+HN), d) grouped
        with compute_autocast(dev, cdt):
            q = tower.first_token_rep(tok, torch.ones_like(tok))
        qf = q.float()
        # q normalized inside the loss only: MIPS ranking ignores ||q||,
        # and a fixed temperature on cos keeps the softmax scale stable
        qn = qf / (torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
                   + 1e-6)
        pf = p_rep.float()
        loss, _ = contrastive_loss(qn * 20.0, pf)
        # alignment to the (unit-norm) positive: under info dropout its
        # minimizer is the posterior mean, eval/ceiling's oracle tower
        pos = pf[::(1 + HN)]
        align = torch.mean(1.0 - torch.sum(qn * pos, -1))
        # a gentle ||q|| ~ 1 pull: the ensemble adds absolute bonuses to
        # raw scores (ensemble_marco.py:235-238)
        norms = torch.linalg.vector_norm(qf, dim=-1)
        norm_pen = torch.mean((norms - 1.0) ** 2)
        return loss + align_w * align + norm_w * norm_pen

    n_probe = env_int("QF_TOWER_NPROBE", 64 if tiny() else 512)
    dev_docs = np.load(osp.join(workdir, "dev_docs.npy"))[:n_probe]
    dev_tok = np.load(osp.join(workdir, "dev_tokens.npy"))[:n_probe]
    dev_ids = torch.from_numpy(dev_tok.astype(np.int32)).to(dev)

    def probe():
        tower.eval()
        with torch.inference_mode(), compute_autocast(dev, cdt):
            q = tower.first_token_rep(dev_ids, torch.ones_like(dev_ids))
        tower.train()
        _, ids = exact_mips_topk(q.float().cpu().numpy(), spec, tab, draws,
                                 k=100, device=dev)
        ids = ids.cpu().numpy()
        found = ids == dev_docs[:, None]
        pos = np.argmax(found, 1)
        hit = found.any(1)
        mrr = float(np.where(hit & (pos < 10), 1.0 / (pos + 1), 0.0).mean())
        return float(hit.mean()), mrr

    host = np.random.default_rng(spec.seed + 31)
    t0 = time.time()
    loss = None
    save_every = env_int("QF_TOWER_SAVE_EVERY", 4000)
    probe_every = env_int("QF_TOWER_PROBE", 16 if tiny() else 2000)
    best = (-1.0, -1.0)
    best_step = None
    meta_p = osp.join(workdir, "tower_meta.json")
    if os.environ.get("QF_TOWER_RESUME") and osp.exists(meta_p):
        # a resumed run's first (often worse) probe must not overwrite a
        # better tower_params.npz already shipped
        with open(meta_p) as fr:
            m = json.load(fr)
        best = (m.get("recall@100", -1.0), m.get("mrr@10", -1.0))
        best_step = m.get("best_step")

    def write_meta(partial):
        with open(meta_p, "w") as fw:
            json.dump({"monitor": "dev_exact_mips_recall@100",
                       "best_step": best_step,
                       "recall@100": best[0], "mrr@10": best[1],
                       "steps": steps, "hard_negatives": HN,
                       "align_w": align_w, "partial": partial}, fw)

    with open(osp.join(workdir, "tower_probe.jsonl"), "a") as probe_log:
        def run_probe(it):
            nonlocal best, best_step
            r100, mrr = probe()
            probe_log.write(json.dumps(
                {"step": it, "recall@100": round(r100, 4),
                 "mrr@10": round(mrr, 4)}) + "\n")
            probe_log.flush()
            log(f"tower probe @{it}: exact-MIPS recall@100 {r100:.4f} "
                f"mrr@10 {mrr:.4f}")
            if (r100, mrr) > best:
                best = (r100, mrr)
                best_step = it
                save_params_npz(osp.join(workdir, "tower_params.best.npz"),
                                tower)
                # shipped at once: a run cut mid-way still leaves a
                # complete bundle (bench._bundle_complete)
                save_params_npz(osp.join(workdir, "tower_params.npz"), tower)
                write_meta(True)

        for it in range(start, steps, K):
            docs = host.integers(0, spec.ndoc, (K, B))
            toks = np.stack([synth.query_tokens(spec, draws[d], host)
                             for d in docs])
            adr = draws[docs]                              # (K, B, 4)
            neg = np.stack([_hard_negative_draws(spec, adr[k], host, HN)
                            for k in range(K)])            # (K, B, HN, 4)
            grouped = np.concatenate([adr[:, :, None, :], neg], axis=2) \
                .reshape(K, B * (1 + HN), 4)
            toks_d = torch.from_numpy(toks).to(dev)
            grouped_d = torch.from_numpy(grouped).to(dev)
            for k in range(K):
                for p in opt.params:
                    p.grad = None
                loss = loss_fn(toks_d[k], grouped_d[k])
                loss.backward()
                opt.step()
                loss = loss.detach()
            if (it // K) % 20 == 0:
                rate = (it + K - start) * B / max(time.time() - t0, 1e-9)
                log(f"tower step {it + K}/{steps} loss {float(loss):.4f} "
                    f"({rate:.0f} ex/s)")
            if probe_every and (it + K - start) % \
                    max(probe_every // K * K, K) == 0:
                run_probe(it + K)
            if save_every and (it // K) % max(save_every // K, 1) == 0 \
                    and it > start:
                save_params_npz(part, tower)
                np.save(part + ".step.npy", np.asarray(it + K))
        run_probe(steps)
    log(f"tower trained: {time.time() - t0:.1f}s loss {float(loss):.4f} "
        f"best probe {best} @ step {best_step}")
    # ship the probe-best parameters (the last ones when probing never
    # ran)
    best_p = osp.join(workdir, "tower_params.best.npz")
    if osp.exists(best_p) and best[0] >= 0:
        shutil.copyfile(best_p, osp.join(workdir, "tower_params.npz"))
        write_meta(False)
    else:
        save_params_npz(osp.join(workdir, "tower_params.npz"), tower)


# --------------------------------------------------------------------------
# eval
# --------------------------------------------------------------------------

def load_nci(cfg, device, dtype=None):
    """The best-ranked NCI of ``<cfg.ckpt_dir>/nci`` (a
    ``CheckpointManager`` board of the port), in eval mode."""
    from ..cli.main import _nci_dims
    from ..models.nci import NCIT5
    from ..train.checkpoints import CheckpointManager, restore_tree_host
    mgr = CheckpointManager.from_dir(osp.join(cfg.ckpt_dir, "nci"))
    tag = mgr.best_tag()
    if tag is None:
        raise FileNotFoundError(f"no NCI checkpoint under {cfg.ckpt_dir}")
    nci = NCIT5(_nci_dims(cfg), device=device)
    nci.load_state_dict(restore_tree_host(
        osp.join(cfg.ckpt_dir, "nci", tag))["model"])
    log(f"loaded NCI checkpoint {tag}")
    return nci if dtype is None else nci.to(dtype)


def load_tower(cfg, path, device, dtype=None):
    """The query tower of ``cfg.encoder`` with the parameters of a
    ``save_params_npz`` file (either package's)."""
    from ..models.twin_tower import tower_from_config
    from ..train.checkpoints import load_params_npz
    from ..weights import load_flax_params
    tower = tower_from_config(cfg.encoder, device=device).module
    load_flax_params(tower, load_params_npz(path))
    return tower if dtype is None else tower.to(dtype)


def _rank_metrics(found):
    """(n, k) hits -> (first position, any hit)."""
    return np.argmax(found, 1), found.any(1)


def stage_eval(spec, workdir, cfg, out_path, device="cuda"):
    """Serve the dev queries with the trained tower and NCI; returns and
    writes the QUALITY dict, and ``served_eval.npz``."""
    from ..data import synth
    from ..eval.ceiling import (ceiling_report, observed_info,
                                oracle_tower_embeddings)
    from ..eval.ensemble import rrf_fuse, run_ensemble
    from ..eval.metrics import evaluate_scores
    from ..eval.searcher import FineIndex, fine_rerank
    from ..ops.mips import mips_topk
    from ..serve import BucketServer
    from ..utils.native import build_csr

    dev = resolve_device(device)
    # the card serves bf16 (the JAX script casts to bf16 on its chip)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    nci = load_nci(cfg, dev, dt)
    tower = load_tower(cfg, osp.join(workdir, "tower_params.npz"), dev, dt)

    tab = synth.make_tables(spec)
    draws = synth.make_draws(spec)
    codes = np.load(osp.join(workdir, "codes.npy"))
    offsets, doc_ids = build_csr(codes, spec.kary)
    CAP = env_int("QF_CAP", 512)
    t0 = time.time()
    semb = synth.fill_sorted_matrix(spec, tab, draws, doc_ids,
                                    n_pad_rows=CAP + 8, dtype=dt, device=dev)
    index = FineIndex(torch.from_numpy(offsets).to(dev),
                      torch.from_numpy(doc_ids).to(dev), semb, spec.levels,
                      spec.kary, host_offsets=offsets, host_doc_ids=doc_ids)
    log(f"fine index on the device: {time.time() - t0:.1f}s")
    NBEAM = env_int("QF_BEAMS", 10)
    POOL = env_int("QF_POOL", 1000)
    server = BucketServer(tower, nci, index, num_beams=NBEAM, cap=CAP,
                          pool=POOL, device=dev)

    dev_docs = np.load(osp.join(workdir, "dev_docs.npy"))
    dev_tok = np.load(osp.join(workdir, "dev_tokens.npy"))
    n_dev = len(dev_docs)
    B = min(env_int("QF_EVAL_BATCH", 256), n_dev)
    n_use = (n_dev // B) * B
    gt_docs = dev_docs[:n_use]
    t0 = time.time()
    handles = []
    for s in range(0, n_use, B):
        ids = torch.from_numpy(dev_tok[s:s + B].astype(np.int32)).to(dev)
        handles.append(server.query_device(ids, torch.ones_like(ids)))
    outs = [server.finalize(h) for h in handles]
    dt_serve = time.time() - t0
    fs_full, fine_ids, beam_codes, bs_full, ndoc = (
        np.concatenate(x) for x in zip(*outs))
    gt = codes[gt_docs]
    eq = (beam_codes == gt[:, None, :]).all(-1)                # (n, nb)
    hit1 = float(eq[:, 0].mean())
    hit10 = float(eq.any(1).mean())
    # per-level diagnosis of the top beam: prefix_acc[l] = P(levels
    # 0..l all correct in beam 0)
    lvl_eq = beam_codes[:, 0, :] == gt
    prefix = np.cumprod(lvl_eq, axis=1)
    level_acc = [round(float(lvl_eq[:, l].mean()), 4)
                 for l in range(gt.shape[1])]
    prefix_acc = [round(float(prefix[:, l].mean()), 4)
                  for l in range(gt.shape[1])]
    pos, found = _rank_metrics(fine_ids == gt_docs[:, None])
    rec = {k: float(((pos < k) & found).mean()) for k in (1, 10, 100)}
    mrr10 = float(np.where(found & (pos < 10), 1.0 / (pos + 1), 0.0).mean())

    # beam-major order of the same pool: buckets by beam rank, docs
    # within a bucket by tower score (eval.searcher.merge_pool)
    cand_codes = codes[np.clip(fine_ids, 0, None)]            # (n, pool, M)
    match = (cand_codes[:, :, None, :]
             == beam_codes[:, None, :, :]).all(-1)            # (n, pool, nb)
    crank = np.where(match.any(-1), match.argmax(-1), NBEAM)
    crank = np.where(fine_ids >= 0, crank, NBEAM + 1)
    fsf = np.where(fine_ids >= 0, fs_full, 0.0)
    span = float(fsf.max() - fsf.min()) + 1.0
    bm_order = np.argsort(crank.astype(np.float64) * span - fsf, axis=1,
                          kind="stable")
    ids_bm = np.take_along_axis(fine_ids, bm_order, 1)
    bm_pos, bm_hit = _rank_metrics(ids_bm == gt_docs[:, None])
    bm_rec = {k: float(((bm_pos < k) & bm_hit).mean()) for k in (1, 10, 100)}
    bm_mrr10 = float(np.where(bm_hit & (bm_pos < 10), 1.0 / (bm_pos + 1),
                              0.0).mean())

    # the served arrays: later re-ranking / fusion runs are host jobs
    np.savez_compressed(
        osp.join(workdir, "served_eval.npz"), fine_ids=fine_ids,
        fine_scores=fs_full, beam_codes=beam_codes, beam_scores=bs_full,
        ndoc=ndoc, dev_docs=gt_docs)

    # the tower's exact-MIPS list (the ANN leg, faiss_search.py:13-21),
    # for the ceiling and the ensemble
    n_ceil = min(1024, n_use)
    ceil_ids = torch.from_numpy(dev_tok[:n_ceil].astype(np.int32)).to(dev)
    with torch.inference_mode():
        q_rep = tower.first_token_rep(ceil_ids, torch.ones_like(ceil_ids))
    ann_s, rows = mips_topk(q_rep.to(dt), semb, k=100)
    ids_exact = doc_ids[np.clip(rows.cpu().numpy(), 0, len(doc_ids) - 1)]
    ann_s = ann_s.cpu().numpy().astype(np.float32)
    gt_ceil = dev_docs[:n_ceil]
    ann_pos, ann_hit = _rank_metrics(ids_exact == gt_ceil[:, None])
    ceil100 = float(ann_hit.mean())
    ann_mrr10 = float(np.where(ann_hit & (ann_pos < 10), 1.0 / (ann_pos + 1),
                               0.0).mean())
    # leg diversity: fusion helps only where the ANN and fine lists differ
    overlap100 = float(np.mean([
        len(set(ids_exact[i].tolist())
            & set(fine_ids[i][fine_ids[i] >= 0][:100].tolist())) / 100.0
        for i in range(n_ceil)]))

    # ensemble fusion (ensemble_marco.py:221-240) of the ANN list with the
    # coarse / fine lists, on a grid of weights (ensemble_marco.py:249-260)
    qnames = [f"q{i}" for i in range(n_ceil)]
    gts = {q: [int(gt_ceil[i])] for i, q in enumerate(qnames)}
    ance_preds = {q: ids_exact[i].tolist() for i, q in enumerate(qnames)}
    ance_scores = {q: ann_s[i].tolist() for i, q in enumerate(qnames)}
    coarse_clusters = {q: [tuple(c) for c in beam_codes[i]]
                       for i, q in enumerate(qnames)}
    fine_preds, fine_scores_m = {}, {}
    for i, q in enumerate(qnames):
        keep = fine_ids[i] >= 0
        fine_preds[q] = fine_ids[i][keep][:100].tolist()
        fine_scores_m[q] = fs_full[i][keep][:100].tolist()
    mapping = {int(d): tuple(codes[int(d)])
               for i in range(n_ceil)
               for d in list(ids_exact[i]) + fine_preds[qnames[i]]}
    # large-alpha / beta 1 points make the fused order lexicographic
    # (cluster rank, then score): beam-major inside the reference's formula
    ens = run_ensemble(gts, ance_preds, ance_scores, coarse_clusters,
                       mapping, fine_preds, fine_scores_m,
                       alphas=(0.3, 0.6, 0.9, 1.5, 3.0, 10.0, 50.0),
                       betas=(0.0, 0.01, 0.03, 0.1, 1.0),
                       gammas=(0.0, 0.02, 0.05, 0.1), recall_ks=(10, 100))
    ens_m = ens[(0.6, 0.03, 0.02)]
    best_w = max(ens, key=lambda w: (ens[w]["recall"][100],
                                     ens[w]["mrr"][10]))
    ens_b = ens[best_w]
    best_wm = max(ens, key=lambda w: (ens[w]["mrr"][10],
                                      ens[w]["recall"][100]))
    ens_bm = ens[best_wm]
    rrf = evaluate_scores(gts, rrf_fuse([ance_preds, fine_preds]),
                          recall_ks=(10, 100))

    # data ceiling (Bayes bounds + posterior-mean oracle tower) on the
    # same dev slice
    ceil = ceiling_report(spec, tab, draws, codes, dev_tok[:n_ceil],
                          gt_ceil, device=dev)

    # the oracle tower's embeddings through the trained beam's clusters:
    # the beam's share of the result apart from the tower's
    q_orc = oracle_tower_embeddings(spec, tab,
                                    observed_info(spec, dev_tok[:n_ceil]))
    orc_ids = np.concatenate([fine_rerank(
        torch.from_numpy(q_orc[s:s + B]).to(dev).to(dt),
        torch.from_numpy(beam_codes[s:s + B]).to(dev), index.offsets,
        index.doc_ids, semb, spec.kary, CAP, 100)[1].cpu().numpy()
        for s in range(0, n_ceil, B)])
    orc_pos, orc_hit = _rank_metrics(orc_ids == gt_ceil[:, None])
    oracle_fine = {
        "recall@100": round(float(orc_hit.mean()), 4),
        "mrr@10": round(float(np.where(orc_hit & (orc_pos < 10),
                                       1.0 / (orc_pos + 1), 0.0).mean()), 4)}

    # which monitor ranked the served NCI checkpoint, and its board
    ckpt_meta = {}
    board_dir = osp.join(cfg.ckpt_dir, "nci")
    meta_p = osp.join(board_dir, "leaderboard.meta.json")
    if osp.exists(meta_p):
        with open(meta_p) as fr:
            ckpt_meta = json.load(fr)
    with open(osp.join(board_dir, "leaderboard.json")) as fr:
        ckpt_meta["board"] = json.load(fr)
    tower_meta = {}
    if osp.exists(osp.join(workdir, "tower_meta.json")):
        with open(osp.join(workdir, "tower_meta.json")) as fr:
            tower_meta = json.load(fr)

    out = {
        "config": ("tiny smoke" if tiny() else
                   "T5-base NCI (12+6, d=768, PAWA-4) + t5-base tower, "
                   "RQ 4x32"),
        "ndoc": spec.ndoc, "n_dev": n_use,
        "coarse_hit@1": round(hit1, 4), "coarse_hit@10": round(hit10, 4),
        "fine_recall@1": round(rec[1], 4),
        "fine_recall@10": round(rec[10], 4),
        "fine_recall@100": round(rec[100], 4),
        "fine_mrr@10": round(mrr10, 4),
        "tower_exact_mips_recall@100": round(ceil100, 4),
        "ensemble_recall@10": round(ens_m["recall"][10], 4),
        "ensemble_recall@100": round(ens_m["recall"][100], 4),
        "ensemble_mrr@10": round(ens_m["mrr"][10], 4),
        "ensemble_best_weights": list(best_w),
        "ensemble_best_recall@10": round(ens_b["recall"][10], 4),
        "ensemble_best_recall@100": round(ens_b["recall"][100], 4),
        "ensemble_best_mrr@10": round(ens_b["mrr"][10], 4),
        "ensemble_mrr_best_weights": list(best_wm),
        "ensemble_mrr_best_recall@100": round(ens_bm["recall"][100], 4),
        "ensemble_mrr_best_mrr@10": round(ens_bm["mrr"][10], 4),
        "beam_major_fine_recall@1": round(bm_rec[1], 4),
        "beam_major_fine_recall@10": round(bm_rec[10], 4),
        "beam_major_fine_recall@100": round(bm_rec[100], 4),
        "beam_major_fine_mrr@10": round(bm_mrr10, 4),
        "ann_recall@100": round(ceil100, 4),
        "ann_mrr@10": round(ann_mrr10, 4),
        "overlap_ann_fine@100": round(overlap100, 4),
        "ensemble_rrf_recall@100": round(rrf["recall"][100], 4),
        "ensemble_rrf_mrr@10": round(rrf["mrr"][10], 4),
        "oracle_tower_served_fine": oracle_fine,
        "ndoc_per_query": round(float(ndoc.mean()), 1),
        "serve_s_for_n_dev": round(dt_serve, 2),
        "beams": NBEAM, "cap": CAP, "pool": POOL,
        "top_beam_level_acc": level_acc,
        "top_beam_prefix_acc": prefix_acc,
        **ceil,
        "fine_recall@100_vs_oracle_tower": round(
            rec[100] / max(ceil["oracle_tower_recall@100"], 1e-9), 4),
        "coarse_hit@10_vs_bayes": round(
            hit10 / max(ceil["bayes_coarse_hit@10"], 1e-9), 4),
        "nci_ckpt": ckpt_meta,
        "tower_ckpt": tower_meta,
    }
    with open(out_path, "w") as fw:
        fw.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------------------
# sharded
# --------------------------------------------------------------------------

SHARD_MESH = (2, 4)              # data x corpus, the JAX stage's mesh


def float32_cfg(cfg):
    """``cfg`` with float32 compute in the NCI and the tower: bf16
    forwards at different batch shapes round apart, and the stage
    compares the paths, not the rounding."""
    import dataclasses as dc
    return dc.replace(cfg, model=dc.replace(cfg.model, dtype="float32"),
                      encoder=dc.replace(cfg.encoder, dtype="float32"))


def sharded_rank(dev, semb, workdir, cfg, offsets, doc_ids, levels, kary,
                 ids_h, mesh_shape, num_beams, cap, pool):
    """One rank of the ``sharded`` stage: the bundle's models, this
    rank's shard of ``semb``, ``ShardedBucketServer`` over its data slice
    of ``ids_h``, the whole batch gathered.  Every rank returns its v3
    launches; rank 0 also (scores, doc ids, codes) and the serve
    seconds."""
    from ..eval.searcher import FineIndex
    from ..ops import bucket as B
    from ..parallel import mesh as PM
    from ..serve import ShardedBucketServer, gather_batch
    from .. import synchronize
    entered = time.time()
    mesh = PM.make_mesh(*mesh_shape, device=dev)
    launches0 = B.launch_counts()["v3"]
    nci = load_nci(cfg, dev)
    tower = load_tower(cfg, osp.join(workdir, "tower_params.npz"), dev)
    index = FineIndex(offsets.to(dev), doc_ids.to(dev),
                      PM.shard_rows(semb, mesh), levels, kary)
    server = ShardedBucketServer(tower, nci, mesh, index,
                                 num_beams=num_beams, cap=cap, pool=pool)
    ids = PM.data_slice(ids_h, mesh).to(dev)
    synchronize(dev)
    setup_s = time.time() - entered
    t0 = time.perf_counter()
    scores, dids, codes, _ = gather_batch(
        server(ids, torch.ones_like(ids)), mesh)
    out = tuple(t.cpu().numpy() for t in (scores, dids, codes))
    seconds = time.perf_counter() - t0
    launches = B.launch_counts()["v3"] - launches0
    if mesh.rank:
        return {"launches": launches}
    return {"launches": launches, "out": out, "seconds": seconds,
            "entered": entered, "setup_s": setup_s}


def canonical_top100(ids, scores):
    """(B, k) ids ordered by (-score, id), the first 100, -1 padded: the
    two paths give equal (score, id) multisets but may order ties
    apart."""
    B = len(ids)
    out = np.full((B, 100), -1, ids.dtype)
    for i in range(B):
        keep = ids[i] >= 0
        order = np.lexsort((ids[i][keep], -scores[i][keep]))
        out[i, :min(100, keep.sum())] = ids[i][keep][order][:100]
    return out


def stage_sharded(spec, workdir, cfg, device="cuda"):
    """Sharded serving of the trained bundle against the single-device
    path (reference: ``mp.spawn`` NCCL inference, ``MEVI/main.py:
    289-337``).  The ranks share ``device`` (its first card on CUDA) over
    gloo; the fine stage runs the v3 kernel over a float32 corpus at
    ``align=1``.  Writes and returns the ``SHARDED_PARITY.json`` dict;
    raises if a parity check fails."""
    from ..data import synth
    from ..decode.beam import nci_beam_search_incremental
    from ..eval.searcher import fine_rerank
    from ..parallel.mesh import launch_local
    from ..utils.native import build_csr

    dev = resolve_device(device)
    cfg = float32_cfg(cfg)
    tab = synth.make_tables(spec)
    draws = synth.make_draws(spec)
    codes = np.load(osp.join(workdir, "codes.npy"))
    offsets, doc_ids = build_csr(codes, spec.kary)
    CAP = env_int("QF_CAP", 512)
    POOL = env_int("QF_POOL", 1000)
    NBEAM = env_int("QF_BEAMS", 10)
    t0 = time.time()
    semb = synth.fill_sorted_matrix(spec, tab, draws, doc_ids,
                                    n_pad_rows=CAP + 8, dtype=torch.float32,
                                    device=dev)
    log(f"sorted matrix: {time.time() - t0:.1f}s "
        f"({semb.numel() * 4 / 2 ** 30:.2f} GiB f32)")
    B = env_int("QF_SHARD_B", 32)
    dev_docs = np.load(osp.join(workdir, "dev_docs.npy"))[:B]
    ids_h = np.load(osp.join(workdir, "dev_tokens.npy"))[:B].astype(np.int32)
    mesh_shape = SHARD_MESH

    # --- sharded path (corpus rows over the corpus axis, queries over data)
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    backend = "gloo"
    t_launch = time.time()
    ranks = launch_local(
        sharded_rank, mesh_shape[0] * mesh_shape[1], backend, rank_dev,
        semb, workdir, cfg, torch.from_numpy(offsets),
        torch.from_numpy(doc_ids), spec.levels, spec.kary,
        torch.from_numpy(ids_h), mesh_shape, NBEAM, CAP, POOL)
    s_sh, i_sh, c_sh = ranks[0]["out"]
    dt_sh = ranks[0]["seconds"]
    launch_s = time.time() - t_launch
    log(f"sharded serve {B} queries: {dt_sh:.1f}s (launch {launch_s:.1f}s)")

    # --- single-device path (the same beam function, the same fine math)
    # in the ranks' row layout (a data slice at a time): the card's
    # float32 products round apart at other batch sizes (phase 9 of
    # chip_smoke.py measured it for 64 and 128 rows), which can swap two
    # nearly tied beams
    nci = load_nci(cfg, dev)
    tower = load_tower(cfg, osp.join(workdir, "tower_params.npz"), dev)
    parts = []
    with torch.inference_mode():
        for ids_s in np.split(ids_h, mesh_shape[0]):
            ids_q = torch.from_numpy(ids_s).to(dev)
            mask_q = torch.ones_like(ids_q)
            parts.append((nci_beam_search_incremental(nci, ids_q, mask_q,
                                                      NBEAM)[0],
                          tower.first_token_rep(ids_q, mask_q)))
        codes_1, qemb_1 = (torch.cat(t) for t in zip(*parts))
        fs_1, fids_1, _ = fine_rerank(
            qemb_1, codes_1, torch.from_numpy(offsets).to(dev),
            torch.from_numpy(doc_ids).to(dev), semb, spec.kary, CAP, POOL)
    fids_1 = fids_1.cpu().numpy()
    fs_1 = fs_1.float().cpu().numpy()
    codes_1 = codes_1.cpu().numpy()
    s_sh = np.asarray(s_sh, np.float32)

    # --- parity ----------------------------------------------------------
    if not np.array_equal(codes_1, c_sh):
        raise AssertionError("beam codes diverged across paths")

    def metrics(fids):
        found = fids[:, :100] == dev_docs[:, None]
        hit = found.any(1)
        pos = np.argmax(found, 1)
        return {"recall@100": round(float(hit.mean()), 4),
                "mrr@10": round(float(np.where(
                    hit & (pos < 10), 1.0 / (pos + 1), 0.0).mean()), 4)}

    c_i_sh = canonical_top100(i_sh, s_sh)
    c_i_1 = canonical_top100(fids_1, fs_1)
    m_sh, m_1 = metrics(c_i_sh), metrics(c_i_1)
    if m_sh != m_1 or os.environ.get("QF_SHARD_DUMP"):
        np.savez(osp.join(workdir, "sharded_debug.npz"),
                 i_sh=i_sh, s_sh=s_sh, fids_1=fids_1, fs_1=fs_1,
                 dev_docs=dev_docs, c_i_sh=c_i_sh, c_i_1=c_i_1,
                 codes=c_sh)
    overlap = np.mean([
        len(set(c_i_sh[i][c_i_sh[i] >= 0].tolist())
            & set(c_i_1[i][c_i_1[i] >= 0].tolist()))
        / max(len(set(c_i_1[i][c_i_1[i] >= 0].tolist())), 1)
        for i in range(B)])
    if m_sh != m_1:
        raise AssertionError(f"sharded {m_sh} != single {m_1}")
    if not overlap > 0.99:
        raise AssertionError(f"top-100 id overlap {overlap:.4f}")
    out = {"metric": "sharded_trained_parity", "n_queries": B,
           "mesh": {"data": mesh_shape[0], "corpus": mesh_shape[1]},
           "ndoc": spec.ndoc, "sharded": m_sh, "single": m_1,
           "top100_overlap": round(float(overlap), 4),
           "beam_codes_equal": True,
           "sharded_serve_s": round(dt_sh, 1),
           # the port's additions: v3 launches summed over the ranks; the
           # launch's seconds, until rank 0 ran its body, and its models,
           # mesh and shard
           "bucket_launches": int(sum(r["launches"] for r in ranks)),
           "launch_s": round(launch_s, 1),
           "rank0_entered_s": round(ranks[0]["entered"] - t_launch, 1),
           "rank0_setup_s": round(ranks[0]["setup_s"], 1)}
    with open(osp.join(workdir, "SHARDED_PARITY.json"), "w") as fw:
        fw.write(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return out


# --------------------------------------------------------------------------

STAGES = ("data", "train", "tower", "eval")


def main(argv=None):
    """Runs the stages ``QF_STAGE`` selects; returns the QUALITY dict
    when ``eval`` ran, else the SHARDED_PARITY dict when ``sharded`` ran,
    else None."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    stages = set(os.environ.get("QF_STAGE", "all").split(","))
    if "all" in stages:
        stages = set(STAGES)
    unknown = stages - set(STAGES) - {"sharded"}
    if unknown:
        raise ValueError(f"unknown QF_STAGE {sorted(unknown)} "
                         f"(known: {', '.join(STAGES)}, sharded, all)")
    workdir = osp.abspath(os.environ.get("QF_WORKDIR", default_workdir()))
    spec_p = osp.join(workdir, "spec.json")
    if "data" not in stages and osp.exists(spec_p):
        # later stages run against the staged spec: a changed environment
        # must not change the corpus mid-pipeline
        from ..data.synth import load_spec
        spec = load_spec(spec_p)
    else:
        spec = make_spec()
    cfg = model_cfg(spec, workdir)
    out_path = os.environ.get("QF_OUT", osp.join(workdir, "QUALITY.json"))
    if "data" in stages:
        stage_data(spec, workdir, dev)
    if "train" in stages:
        stage_train(spec, workdir, cfg, dev)
    if "tower" in stages:
        stage_tower(spec, workdir, cfg, dev)
    out = None
    if "eval" in stages:
        out = stage_eval(spec, workdir, cfg, out_path, dev)
    if "sharded" in stages:
        parity = stage_sharded(spec, workdir, cfg, dev)
        out = out if out is not None else parity
    return out


if __name__ == "__main__":
    main()
