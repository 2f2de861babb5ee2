"""Command line of the port: the twelve subcommands of
``mevi_tpu.cli.main`` over one JSON config:

  prepare        build train/dev/doc-aug tsvs           (prepare_origin.py)
  tokenize       corpus/query -> memmaps      (prepare_passage_tokenized)
  gen-embeddings corpus embedding job                    (generate.py, C13)
  build-index    RQ codebooks + CSR fine index  (marco_generate_*_rq.sh)
  build-hier     hierarchical k-means ids, prefix clusters, trie tables
  search         exact MIPS top-k over embeddings, or an ADC scan over
                 RQ codes                              (faiss_search.py)
  evaluate       Recall/MRR of a ranks tsv against a gt tsv (evaluate.py)
  ensemble       ANCE + MEVI coarse/fine fusion grid  (ensemble_marco.py)
  doc2query      sampled pseudo-queries per passage, --repair loop
                                                   (doc2query.py, QG)
  train          NCI seq2seq training              (marco_train_nci_rq.sh)
  train-joint    joint NCI + codebook + twin training with RQ-refit
                 validation                     (main.py --codebook 1)
  eval           coarse/fine evaluation             (marco_eval_nci_rq.sh)

Every command takes the JAX package's flags and writes its output
files and lines.  The device commands also take ``--config
config.json`` (defaults when absent; not ``doc2query``, whose widths are
flags) and ``--device`` (default ``cuda``); ``prepare``, ``tokenize``,
``evaluate`` and ``ensemble`` run on the host.  Checkpoints of the
port's own runs are ``CheckpointManager`` tag directories; HF and
reference torch checkpoints go through ``models.convert``.  Run
``python -m mevi_tpu_torch.cli.main <cmd> --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

from ..config import MEVIConfig


def load_config(path) -> MEVIConfig:
    if path and osp.exists(path):
        with open(path) as fr:
            cfg = MEVIConfig.from_json(fr.read())
    else:
        cfg = MEVIConfig()
    return cfg.finalize()


# --------------------------------------------------------------------------
# commands
# --------------------------------------------------------------------------

def _corpus_rows(path):
    """(did, title, content) rows of a corpus tsv."""
    with open(path, encoding="utf-8") as fr:
        for line in fr:
            did, title, content = (line.rstrip("\n").split("\t")
                                   + ["", ""])[:3]
            yield did, title, content


def cmd_prepare(args):
    """MS MARCO raw files -> train_mevi.tsv / dev_mevi_dedup.tsv (and
    doc_aug.tsv with ``--doc_aug``), host only."""
    import csv
    from ..data import io, prepare as P
    os.makedirs(args.origin_dir, exist_ok=True)
    queries = P.read_id_text_tsv(osp.join(args.raw_dir, "train.query.txt"))
    with open(osp.join(args.raw_dir, "qrels.train.tsv")) as fr:
        rows = list(csv.reader(fr, delimiter="\t"))
    pairs = P.build_train_pairs(queries, rows)
    io.write_query_docids_tsv(osp.join(args.origin_dir, "train_mevi.tsv"),
                              [(q, [d]) for q, d in pairs])
    dev_queries = P.read_id_text_tsv(osp.join(args.raw_dir, "dev.query.txt"))
    with open(osp.join(args.raw_dir, "qrels.dev.tsv")) as fr:
        rows = list(csv.reader(fr, delimiter="\t"))
    io.write_query_docids_tsv(
        osp.join(args.origin_dir, "dev_mevi_dedup.tsv"),
        P.build_dev_dedup(dev_queries, rows))
    print("wrote train_mevi.tsv / dev_mevi_dedup.tsv")
    if args.doc_aug:
        spans = P.doc_aug_spans(
            [(int(d), t, c) for d, t, c in
             _corpus_rows(osp.join(args.raw_dir, "corpus.tsv"))])
        io.write_query_docids_tsv(osp.join(args.origin_dir, "doc_aug.tsv"),
                                  [(q, [d]) for q, d in spans])
        print("wrote doc_aug.tsv")


def cmd_tokenize(args):
    """Corpus tsv or query tsv -> token + mask memmaps, host only."""
    from ..data import io as dio
    from ..data.tokenize import (get_tokenizer, tokenize_passages,
                                 tokenize_queries)
    tok = get_tokenizer(args.style,
                        allow_hash_fallback=args.allow_hash_tokenizer)
    if args.kind == "corpus":
        rows = [(t, c) for _, t, c in _corpus_rows(args.input)]
        tokens, masks = tokenize_passages(rows, tok, args.style,
                                          args.length)
        dio.write_token_memmaps(args.output, tokens, masks)
    else:
        rows = dio.read_query_docids_tsv(args.input)
        ids, mask = tokenize_queries([q for q, _ in rows], tok, args.length)
        dio.write_token_memmaps(args.output, ids.astype(np.int64),
                                mask.astype(np.int64))
    print(f"tokenized {args.kind}: {args.output}")


def _time_ms(fn, dev, reps: int = 5) -> float:
    """Mean ms of ``reps`` calls after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    import torch
    fn()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _load_tower(cfg, path, side, dev):
    """The twin tower of ``cfg.encoder`` with a torch checkpoint's weights
    (an AR2 / DPR dict gives its ``side``: 'passage' or 'query'), and its
    representation function under the tower's compute dtype."""
    import torch
    from ..models import convert
    from ..models.twin_tower import tower_from_config
    from ..train.trainer import compute_autocast
    sd = convert.load_torch_state_dict(path)
    if any(k.startswith(("ctx_model.", "question_model.")) for k in sd):
        sd = convert.split_ar2_checkpoint(sd)[side]
    tower = tower_from_config(cfg.encoder, device=dev)
    tower.module.load_state_dict(convert.convert_tower(
        sd, cfg.encoder.family, cfg.encoder.num_layers))
    dtype = tower.module.dims.dtype

    def rep_fn(ids, mask):
        with torch.inference_mode(), compute_autocast(dev, dtype):
            return tower.rep(ids, mask).float()
    return tower, rep_fn


def cmd_gen_embeddings(args):
    """Corpus token memmaps -> the float32 embedding memmap, through the
    T5 or BERT tower of a torch checkpoint (the ctx side of an AR2 one).
    ``--profile``: the tower's latency at batch 1-256 instead."""
    import torch
    from .. import resolve_device
    from ..data import io as dio
    from ..index.build import embed_corpus
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    _, rep_fn = _load_tower(cfg, args.checkpoint, "passage", dev)
    tokens, masks = dio.open_token_memmaps(args.documents, args.doc_length)
    if args.profile:
        # encoder latency across batch sizes (profile_generate_query,
        # MEVI/generate.py:247-280)
        for bs in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            i = torch.from_numpy(np.asarray(tokens[:1], np.int32)
                                 .repeat(bs, 0)).to(dev)
            m = torch.from_numpy(np.asarray(masks[:1], np.int32)
                                 .repeat(bs, 0)).to(dev)
            ms = _time_ms(lambda: rep_fn(i, m), dev)
            print(f"bs={bs}: {ms:.2f} ms/batch {bs / (ms * 1e-3):.1f} "
                  "emb/s", file=sys.stderr)
        return
    emb = embed_corpus(rep_fn, tokens, masks,
                       batch_size=cfg.train.encode_batch_size,
                       progress=lambda d, n: print(f"\r{d}/{n}", end="",
                                                   file=sys.stderr),
                       device=dev)
    dio.write_embedding_memmap(args.output, emb)
    print(f"\nwrote {args.output}: {emb.shape}")


def cmd_build_index(args):
    from ..data import io as dio
    from ..index.build import build_rq_index
    from ..index.csr import size_histogram
    from ..train.checkpoints import ArtifactCache
    cfg = load_config(args.config)
    emb = dio.open_embedding_memmap(args.embeddings, cfg.rq.emb_size)
    cache = ArtifactCache(args.cache_dir) if args.cache_dir else None
    arts = build_rq_index(cfg, emb, seed=args.seed, iters=args.iters,
                          cache=cache, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    np.save(osp.join(args.output_dir, "rq_codebooks.npy"), arts.codebooks)
    np.save(osp.join(args.output_dir, "rq_codes.npy"), arts.codes)
    if arts.prefix_shift is not None:
        # the conditioning tables are part of the quantizer: consumers
        # re-assigning new docs must load them (ops/rq.assign)
        np.savez(osp.join(args.output_dir, "rq_prefix_shift.npz"),
                 **{f"l{i + 1}": t
                    for i, t in enumerate(arts.prefix_shift)})
    np.save(osp.join(args.output_dir, "csr_offsets.npy"),
            arts.fine.host_offsets)
    np.save(osp.join(args.output_dir, "csr_doc_ids.npy"),
            arts.fine.host_doc_ids)
    print(json.dumps(size_histogram(arts.fine.host_offsets)))


def cmd_build_hier(args):
    """Hierarchical k-means ids + prefix-cluster pickles + trie tables
    (``prepare_clus``, ``prepare_origin.py:12-28``)."""
    from ..data import io as dio
    from ..index.hierarchical import (hierarchical_kmeans_ids,
                                      save_hier_artifacts)
    cfg = load_config(args.config)
    emb = dio.open_embedding_memmap(args.embeddings, cfg.rq.emb_size)
    ids = hierarchical_kmeans_ids(emb, k=args.k, c=args.c, seed=args.seed,
                                  iters=args.iters, device=args.device)
    layers = [int(x) for x in args.layers.split(",")]
    save_hier_artifacts(args.output_dir, ids, layers,
                        kary=max(args.k, args.c))
    lens = [len(s) for s in ids]
    print(json.dumps({"n_docs": len(ids), "max_len": max(lens),
                      "mean_len": round(sum(lens) / len(lens), 2)}))


def _write_results(path, ids, scores, names=None):
    """faiss_search.to_file contract: query \\t\\t preds \\t scores."""
    with open(path, "w") as fw:
        for i in range(len(ids)):
            fw.write("\t".join([
                names[i] if names else str(i), "", str(ids[i].tolist()),
                str([float(x) for x in scores[i]])]) + "\n")


def cmd_search(args):
    import torch
    from .. import resolve_device, synchronize
    from ..data import io as dio
    from ..ops.mips import mips_topk
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    docs = dio.open_embedding_memmap(args.doc_embeddings, cfg.rq.emb_size)
    queries = np.array(dio.open_embedding_memmap(args.query_embeddings,
                                                 cfg.rq.emb_size))
    if args.adc_codes:
        # ADC scan over RQ codes (ops/adc.py) instead of full embeddings
        from ..ops.adc import adc_search, build_adc_codes
        codes = np.load(args.adc_codes)
        cbs = torch.from_numpy(np.load(args.adc_codebooks)).to(dev)
        oh = torch.from_numpy(build_adc_codes(codes, cfg.rq.kary)).to(dev)
        out_scores, out_ids = [], []
        t0 = time.time()
        for s in range(0, len(queries), args.batch):
            sc, ids = adc_search(torch.from_numpy(queries[s:s + args.batch]),
                                 cbs, oh, k=args.topk, device=dev)
            out_scores.append(sc.cpu().numpy())
            out_ids.append(ids.cpu().numpy())
        print(f"ADC: {len(queries)} queries in {time.time() - t0:.2f}s",
              file=sys.stderr)
        if args.output:
            _write_results(args.output, np.concatenate(out_ids),
                           np.concatenate(out_scores))
        return
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    docs_d = torch.from_numpy(np.array(docs)).to(dev, dtype)

    def q_batch(s, bs):
        return torch.from_numpy(queries[s:s + bs]).to(dev, dtype)
    if args.profile:
        # latency profile across batch sizes (faiss_search.py:32-68)
        for bs in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            q = q_batch(0, bs)
            if q.shape[0] < bs:
                q = q.repeat(-(-bs // max(q.shape[0], 1)), 1)[:bs]
            mips_topk(q, docs_d, k=args.topk)
            synchronize(dev)
            t0 = time.time()
            for _ in range(5):
                mips_topk(q, docs_d, k=args.topk)
            synchronize(dev)
            dt = (time.time() - t0) / 5
            print(f"bs={bs}: {dt * 1e3:.2f} ms/batch "
                  f"{bs / dt:.1f} q/s", file=sys.stderr)
        return
    out_scores, out_ids = [], []
    t0 = time.time()
    for s in range(0, len(queries), args.batch):
        sc, ids = mips_topk(q_batch(s, args.batch), docs_d, k=args.topk)
        out_scores.append(sc.cpu().numpy())
        out_ids.append(ids.cpu().numpy())
    dt = time.time() - t0
    print(f"{len(queries)} queries in {dt:.2f}s "
          f"({len(queries) / dt:.1f} q/s)", file=sys.stderr)
    if args.output:
        names = None
        if args.queries_tsv:
            names = [q for q, _ in dio.read_query_docids_tsv(
                args.queries_tsv)]
        _write_results(args.output, np.concatenate(out_ids),
                       np.concatenate(out_scores), names)


def _nci_dims(cfg):
    """ModelConfig -> NCIDims honoring the reference's architecture flags
    (adaptor_decode -> PAWA on/off, feed_forward_proj,
    tie_decode_embedding; ``MEVI/main.py:755-779``)."""
    import torch
    from ..models.nci import NCIDims
    from ..models.t5 import T5Dims
    m = cfg.model
    return NCIDims(
        t5=T5Dims(vocab_size=m.vocab_size, d_model=m.d_model,
                  d_kv=m.d_kv, d_ff=m.d_ff, num_heads=m.num_heads,
                  num_layers=m.num_layers,
                  num_decoder_layers=m.num_decoder_layers,
                  dropout_rate=m.dropout_rate,
                  gated_act=(m.feed_forward_proj == "gated-gelu"),
                  dtype=(torch.bfloat16 if m.dtype == "bfloat16"
                         else torch.float32)),
        kary=m.kary, max_output_length=m.max_output_length,
        adaptor_layer_num=m.adaptor_layer_num,
        adaptor_num_heads=m.adaptor_num_heads,
        use_pawa=m.adaptor_decode,
        tie_decode_embedding=m.tie_decode_embedding)


def _dev_probe(args, model):
    """The between-epoch dev coarse-hit@10 probe (``--dev_queries`` /
    ``--dev_codes``), or None: checkpoints rank on retrieval, not on the
    training loss (the reference's recall-monitored ModelCheckpoint,
    ``main.py:89-170``)."""
    import torch
    if not (args.dev_queries and args.dev_codes):
        return None
    from ..decode.beam import nci_beam_search
    from ..train.trainer import compute_autocast
    dev = next(model.parameters()).device
    dev_tok = np.load(args.dev_queries).astype(np.int32)
    dev_gt = np.load(args.dev_codes).astype(np.int32)
    pb = min(int(args.dev_batch), len(dev_tok))
    n_probe = (len(dev_tok) // pb) * pb
    probe_k = 10

    def probe():
        model.eval()
        hits = 0
        for s in range(0, n_probe, pb):
            ids = torch.from_numpy(dev_tok[s:s + pb]).to(dev)
            with compute_autocast(dev, model.dims.t5.dtype):
                bc, _, _, _ = nci_beam_search(model, ids,
                                              torch.ones_like(ids), probe_k)
            eq = (bc.cpu().numpy() == dev_gt[s:s + pb, None, :]).all(-1)
            hits += int(eq.any(1).sum())
        return hits / max(n_probe, 1)
    return probe


def cmd_train(args):
    """NCI training (``marco_train_nci_rq.sh``): seeded init, AdamW label
    groups, per-epoch checkpoints ranked by the dev probe (or the loss),
    ``--resume``.  Returns the final ``TrainState``."""
    import torch
    from .. import resolve_device
    from ..data import io as dio
    from ..data.datasets import NCIDataset, host_prefetch
    from ..models.nci import NCIT5
    from ..train import trainer as T
    from ..train.checkpoints import CheckpointManager
    from ..utils.logging import MetricsLogger, run_name
    from ..weights import init_random_

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    m = cfg.model
    model = init_random_(NCIT5(_nci_dims(cfg), device=dev), cfg.train.seed)

    qids, qmask = dio.open_token_memmaps(args.queries, args.query_length)
    codes = np.load(args.codes)
    if args.train_tsv:
        pairs = dio.read_query_docids_tsv(args.train_tsv)
        codes = codes[np.array([ids[0] for _, ids in pairs])]
    ds = NCIDataset(np.asarray(qids, np.int32)[:len(codes)],
                    np.asarray(qmask, np.int32)[:len(codes)],
                    codes.astype(np.int32))

    rng = np.random.default_rng(cfg.train.seed)
    bs = cfg.train.train_batch_size
    total = max(len(ds) // bs, 1) * cfg.train.num_train_epochs
    opt = T.make_optimizer(cfg.train, model, total_steps=total)
    state = T.init_state(model, opt)
    step = T.make_nci_train_step(
        model, T.NCIStepConfig(rdrop=m.rdrop, rdrop_loss=m.rdrop_loss))
    logger = MetricsLogger(args.log_dir or cfg.ckpt_dir,
                           run_name("nci", cfg))
    dev_probe = _dev_probe(args, model)
    ckpts = CheckpointManager(
        osp.join(cfg.ckpt_dir, "nci"), keep=2,
        monitor="dev_hit10" if dev_probe else "loss",
        mode="max" if dev_probe else "min")
    gen = torch.Generator().manual_seed(cfg.train.seed)
    start_epoch = 0
    if args.resume:
        tag = (ckpts.best_tag()
               if args.resume in ("1", "best", "auto") else args.resume)
        if tag is not None:
            restored = ckpts.restore(tag)
            model.load_state_dict(restored["model"])
            opt.load_state_dict(restored["optimizer"])
            state.step = int(restored["step"])
            start_epoch = int(restored["epoch"]) + 1
            print(f"resumed from epoch {start_epoch}")
    use_rng = m.dropout_rate > 0 or m.rdrop > 0
    metrics = None
    for epoch in range(start_epoch, cfg.train.num_train_epochs):
        for batch in host_prefetch(ds.batches(bs, rng)):
            state, metrics = step(state, batch, gen if use_rng else None)
            if state.step % args.log_every == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           state.step)
        loss = float(metrics["loss"])
        metric = loss
        if dev_probe is not None:
            hit10 = dev_probe()
            metric = hit10
            print(f"epoch {epoch}: loss {loss:.4f} "
                  f"dev coarse hit@10 {hit10:.4f}")
            logger.log({"dev_hit10": hit10}, state.step)
        else:
            print(f"epoch {epoch}: loss {loss:.4f}")
        ckpts.save(f"epoch{epoch}",
                   {"model": model.state_dict(),
                    "optimizer": opt.state_dict(), "step": state.step,
                    "epoch": epoch}, metric=metric)
        if args.max_epochs and epoch + 1 >= args.max_epochs:
            break
    logger.close()
    return state


def _dev_inputs(dev_tsv, cfg, query_length, allow_hash):
    """Dev tsv -> (queries, token ids, mask, gt doc ids) tokenized for the
    config's tower family."""
    from ..data import io as dio
    from ..data.tokenize import get_tokenizer, tokenize_queries
    rows = dio.read_query_docids_tsv(dev_tsv)
    tok = get_tokenizer("ance" if cfg.encoder.family == "t5" else "ar2",
                        allow_hash_fallback=bool(allow_hash))
    ids, mask = tokenize_queries([q for q, _ in rows], tok, query_length)
    return [q for q, _ in rows], ids, mask, [ids_ for _, ids_ in rows]


def cmd_train_joint(args):
    """Joint NCI + codebook + twin training (the reference's
    ``--codebook 1`` mode, ``main.py:36-174`` + ``main_models.py:
    2838-2867``): runtime RQ labels from the live tower, PQ distillation,
    in-cluster-negative co-loss, optional EMA codebook updates,
    alternating NCI/twin stages, validation-driven RQ refit with
    Hungarian alignment, gradient accumulation and ``--resume``.  The
    first refit aligns to ``--codebooks`` / ``--codes`` when given.
    Returns the ``TrainLoop``."""
    import torch
    import dataclasses
    from .. import resolve_device
    from ..data import io as dio
    from ..data.datasets import (ClusterNegativeSampler, JointDataset,
                                 host_prefetch)
    from ..models.nci import NCIT5
    from ..models.twin_tower import tower_from_config
    from ..ops import rq as rq_ops
    from ..train import joint as J
    from ..train import trainer as T
    from ..train.loop import LoopConfig, TrainLoop
    from ..weights import flax_names, init_random_

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    m, tcfg = cfg.model, cfg.train

    # ---- data -----------------------------------------------------------
    qids, qmask = dio.open_token_memmaps(args.queries, args.query_length)
    dtok, dmask = dio.open_token_memmaps(args.documents, args.doc_length)
    rows = dio.read_query_docids_tsv(args.train_tsv)
    pos_doc = np.array([ids[0] for _, ids in rows], np.int64)
    n = min(len(pos_doc), len(qids))
    qids = np.asarray(qids, np.int32)[:n]
    qmask = np.asarray(qmask, np.int32)[:n]
    pos_doc = pos_doc[:n]
    dtok = np.asarray(dtok, np.int32)
    dmask = np.asarray(dmask, np.int32)
    codes0 = np.load(args.codes) if args.codes else None
    sampler = None
    if codes0 is not None and tcfg.co_neg_num > 0 and not tcfg.no_twin_loss:
        sampler = ClusterNegativeSampler(codes0, m.kary)
    ds = JointDataset(
        qids, qmask, pos_doc, dtok, dmask, sampler,
        n_neg=tcfg.co_neg_num if sampler else 0,
        doc_codes=(codes0 if codes0 is not None
                   and not tcfg.pq_runtime_label else None))

    # ---- parameters -----------------------------------------------------
    dims = _nci_dims(cfg)
    if args.remat:
        dims = dataclasses.replace(
            dims, t5=dataclasses.replace(dims.t5, remat=True))
    nci = init_random_(NCIT5(dims, device=dev), tcfg.seed)
    tower = tower_from_config(cfg.encoder, device=dev, remat=args.remat)
    init_random_(tower.module, tcfg.seed + 1)
    if args.tower_ckpt:
        from ..models import convert
        tsd = convert.load_torch_state_dict(args.tower_ckpt)
        if any(k.startswith("ctx_model.") for k in tsd):
            # AR2 untied: train the document (ctx) side
            tsd = convert.split_ar2_checkpoint(tsd)["passage"]
        tower.module.load_state_dict(convert.convert_tower(
            tsd, cfg.encoder.family, cfg.encoder.num_layers))
    if args.codebooks:
        codebooks = torch.from_numpy(np.load(args.codebooks)).float()
    else:
        codebooks = torch.randn(
            (cfg.rq.subvector_num, cfg.rq.kary, cfg.rq.last_dim),
            generator=torch.Generator().manual_seed(tcfg.seed + 2)) * 0.02
    model = J.JointModel(nci, tower, codebooks.to(dev))

    # ---- optimizer: fix* -> frozen label; MultiSteps accumulation ------
    bs = tcfg.train_batch_size
    total = max(len(ds) // bs, 1) * tcfg.num_train_epochs
    labels = J.joint_param_labels(
        flax_names(model).values(), fixnci=tcfg.fixnci,
        fixpq=tcfg.fixpq or args.pq_update == "ema",
        fixdocenc=tcfg.fixdocenc)
    opt = T.make_optimizer(tcfg, model, total_steps=total, labels=labels)
    state = T.init_state(model, opt)
    scfg = J.JointStepConfig(
        pq_loss=tcfg.pq_loss, pq_softmax_tau=tcfg.pq_softmax_tau,
        pq_negative=tcfg.pq_negative,
        centroid_update_loss=tcfg.centroid_update_loss,
        centroid_loss_scale=tcfg.centroid_loss_scale,
        no_nci_loss=tcfg.no_nci_loss, no_twin_loss=tcfg.no_twin_loss,
        dist_mode=cfg.rq.dist_mode, rdrop=m.rdrop,
        runtime_label=tcfg.pq_runtime_label)
    if args.pq_update == "ema":
        ema_box = [rq_ops.ema_init(model.codebooks.detach())]
        ema_step = J.make_joint_train_step_ema(model, scfg)

        def joint_step(state, batch, rng):
            state, ema_box[0], metrics = ema_step(state, ema_box[0], batch,
                                                  rng)
            return state, metrics
    else:
        joint_step = J.make_joint_train_step(model, scfg)
    # alternating stages re-use the joint step with one side's loss off
    steps = {"nci": joint_step}
    alt = None
    if args.alt_epochs:
        alt = tuple(int(x) for x in args.alt_epochs.split(","))
        steps = {"nci": J.make_joint_train_step(
                     model, dataclasses.replace(scfg, no_twin_loss=True)),
                 "twin": J.make_joint_train_step(
                     model, dataclasses.replace(scfg, no_nci_loss=True))}
        if args.pq_update == "ema":
            steps["nci"] = joint_step   # EMA rides the nci stage

    rng = np.random.default_rng(tcfg.seed)

    def dataset_fn(epoch):
        # batch assembly (negative sampling) overlaps the device step
        return host_prefetch(ds.batches(bs, rng))

    eval_inputs = None
    if args.dev_tsv:
        q, i, mk, g = _dev_inputs(args.dev_tsv, cfg, args.query_length,
                                   args.allow_hash_tokenizer)
        eval_inputs = {"queries": q, "query_ids": i, "query_mask": mk,
                       "gt_docids": g}

    def tower_rep(ids, mask):
        # the live tower at call time, in its compute dtype
        with torch.inference_mode(), T.compute_autocast(
                dev, tower.module.dims.dtype):
            return model.tower_rep(ids, mask).float()

    loop_cfg = LoopConfig(
        num_epochs=args.max_epochs or tcfg.num_train_epochs,
        val_every=args.val_every, refit_rq=bool(args.dev_tsv),
        rq_iters=args.rq_iters, alt_epochs=alt, monitor=args.monitor,
        seed=tcfg.seed)
    tl = TrainLoop(cfg, loop_cfg, nci, steps, state, dataset_fn,
                   tower_rep=tower_rep, doc_tokens=dtok, doc_masks=dmask,
                   eval_inputs=eval_inputs,
                   ckpt_dir=osp.join(cfg.ckpt_dir, "joint"),
                   log_dir=args.log_dir or cfg.ckpt_dir, device=dev)
    if args.codebooks:
        tl.codebooks = codebooks.numpy()
    tl.doc_codes = codes0
    if args.resume:
        tag = None if args.resume in ("1", "best", "auto") else args.resume
        if tl.resume(tag):
            print(f"resumed from epoch {tl.start_epoch}")
    state = tl.run(query_rep_fn=tower_rep if args.dev_tsv else None)
    print(f"done: step {state.step}")
    return tl


def _load_nci(path, cfg, dev):
    """The eval NCI: a ``CheckpointManager`` tag directory of the port
    (``train``'s NCI or ``train-joint``'s ``nci.`` part; ``<dir>/best``
    names the best tag of ``<dir>``, as ``--resume best`` does) or a
    reference Lightning checkpoint file (converted)."""
    from ..models import convert
    from ..models.nci import NCIT5
    from ..train.checkpoints import CheckpointManager, restore_tree_host
    m = cfg.model
    if osp.basename(path) == "best" and not osp.exists(path):
        ck = CheckpointManager.from_dir(osp.dirname(path) or ".")
        if ck.best_tag() is None:
            raise FileNotFoundError(f"{path}: no checkpoint to call best")
        path = osp.join(ck.directory, ck.best_tag())
    if osp.isdir(path):
        sd = restore_tree_host(osp.abspath(path))["model"]
        if any(k.startswith("nci.") for k in sd):
            sd = {k[4:]: v for k, v in sd.items() if k.startswith("nci.")}
    else:
        sd = convert.load_torch_state_dict(path)
        sd = {k[len("model."):] if k.startswith("model.") else k: v
              for k, v in sd.items()}
        sd = convert.convert_nci_checkpoint(
            sd, m.num_layers, m.num_decoder_layers, m.adaptor_layer_num)
    model = NCIT5(_nci_dims(cfg), device=dev)
    model.load_state_dict(sd)
    return model


def cmd_eval(args):
    """Coarse/fine evaluation (the ``marco_eval_nci_rq.sh`` stage).
    Prints the JSON report; returns {report, evaluator, outputs,
    query_ids, query_mask, gts}."""
    import torch
    from .. import resolve_device
    from ..config import InferConfig
    from ..data import io as dio
    from ..eval.run_eval import Evaluator, write_result_files
    from ..eval.searcher import FineIndex, build_fine_index
    from ..train.trainer import compute_autocast
    from ..utils.timers import profiler_trace

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    model = _load_nci(args.nci_ckpt, cfg, dev)

    # fine index from embeddings + codes
    emb = np.asarray(dio.open_embedding_memmap(args.embeddings,
                                               cfg.rq.emb_size))
    codes = np.load(args.codes)
    if args.corpus_int8:
        # symmetric global-scale int8: per-query ranking is
        # scale-invariant, so metrics move by the ~1/127 rounding only
        from ..index.build import quantize_int8
        emb, _ = quantize_int8(emb)
    if args.host_stream:
        # the corpus stays in host memory; the fine stage streams bucket
        # panels to the card (any corpus size: the NQ 21M regime)
        from ..utils.native import build_csr
        offsets, doc_ids = build_csr(codes, cfg.rq.kary)
        rows = torch.from_numpy(np.ascontiguousarray(emb[doc_ids]))
        if args.bf16 and not args.corpus_int8:
            rows = rows.to(torch.bfloat16)
        fine = FineIndex(torch.from_numpy(offsets), torch.from_numpy(doc_ids),
                         rows, codes.shape[-1], cfg.rq.kary,
                         host_offsets=offsets, host_doc_ids=doc_ids)
    else:
        fine = build_fine_index(
            codes, emb, cfg.rq.kary,
            dtype=(torch.bfloat16 if args.bf16 and not args.corpus_int8
                   else None), device=dev)
    _, rep_fn = _load_tower(cfg, args.tower_ckpt, "query", dev)
    queries, qids, qmask, gts = _dev_inputs(
        args.dev_tsv, cfg, args.query_length, args.allow_hash_tokenizer)
    icfg = InferConfig(
        num_return_sequences=args.num_return_sequences,
        recall_level=args.recall_level,
        recall_num=tuple(int(x) for x in args.recall_num.split(",")),
        max_cluster_docs=args.max_cluster_docs,
        eval_all_documents=bool(args.eval_all_documents),
        rank_mode=args.rank_mode)
    ev = Evaluator(model, icfg, fine_index=fine, query_rep_fn=rep_fn,
                   doc_codes=codes, host_stream=bool(args.host_stream),
                   device=dev)
    with profiler_trace(args.profile_dir), \
            compute_autocast(dev, model.dims.t5.dtype):
        if args.nq_answer_offsets:
            # NQ answer-set mode (nqdpr_eval_nci_rq.sh): hits through the
            # inverse doc -> answering-query arrays, not gt doc ids
            from ..eval.ensemble import AnswerIndex
            aidx = AnswerIndex.from_files(args.nq_answer_offsets,
                                          args.nq_answer_array)
            out = ev.evaluate_nq(queries, qids, qmask,
                                 query_indices=list(range(len(queries))),
                                 answer_index=aidx,
                                 batch_size=args.batch_size,
                                 keep_results=bool(args.save_path))
        else:
            out = ev.evaluate(queries, qids, qmask, gts,
                              batch_size=args.batch_size,
                              keep_results=bool(args.save_path))
    report = {"ndoc_per_query": out.ndoc_per_query}
    if out.coarse:
        report["coarse"] = out.coarse
    if out.fine:
        report["fine"] = out.fine
    print(json.dumps(report, indent=1, default=float))
    # the bucket kernel's launches in this process so far (the plain
    # version on the CPU launches none), for a caller in another process
    from ..ops.bucket import launch_counts
    print(json.dumps({"bucket_launches": {"v3": launch_counts()["v3"]}}),
          file=sys.stderr)
    if args.save_path:
        base = args.save_path.rsplit(".", 1)[0]
        write_result_files(out, gts, coarse_path=base + "_coarse.tsv",
                           fine_path=base + "_fine.tsv",
                           hardneg_path=base + "_hn.tsv",
                           hard_neg_k=cfg.infer.save_hard_neg)
    return dict(report=report, evaluator=ev, outputs=out, query_ids=qids,
                query_mask=qmask, gts=gts)


def cmd_doc2query(args):
    """Generate pseudo-queries per passage (docT5query QG,
    ``dataprocess/msmarco_passage/doc2query.py``).  With ``--repair``,
    run the regeneration loop instead (``complement_qg10.py``): detect
    empty / duplicate queries in an existing qg tsv and regenerate for
    the affected docs until every doc has ``n_gen_query`` usable queries
    (or ``--repair_rounds`` is spent).  Sampling draws from a
    ``torch.Generator`` seeded with ``--seed``."""
    import torch
    from .. import resolve_device
    from ..data.tokenize import get_tokenizer
    from ..decode.generate import generate
    from ..models import convert
    from ..models.t5 import T5Dims, T5Model

    dev = resolve_device(args.device)
    tok = get_tokenizer("ance",  # the t5 tokenizer
                        allow_hash_fallback=args.allow_hash_tokenizer)
    sd = convert.convert_t5_model(
        convert.load_torch_state_dict(args.checkpoint), args.num_layers,
        args.num_layers)
    model = T5Model(T5Dims(num_layers=args.num_layers,
                           num_decoder_layers=args.num_layers,
                           d_model=args.d_model, d_kv=args.d_kv,
                           d_ff=args.d_ff, num_heads=args.num_heads,
                           dropout_rate=0.0), device=dev)
    model.load_state_dict(sd)
    gen = torch.Generator().manual_seed(args.seed)
    bs = args.batch

    def gen_rows(texts, dids):
        """n_gen_query queries per (text, did), batches padded to bs."""
        rows = []
        for s in range(0, len(texts), bs):
            bt, bd = list(texts[s:s + bs]), list(dids[s:s + bs])
            bt += [""] * (bs - len(bt))
            bd += [None] * (bs - len(bd))
            enc = tok(bt, max_length=args.doc_max_len, truncation=True,
                      padding="max_length", return_tensors="np")
            out = generate(model, np.asarray(enc["input_ids"], np.int32),
                           np.asarray(enc["attention_mask"], np.int32), gen,
                           max_length=args.query_max_len,
                           num_return_sequences=args.n_gen_query,
                           do_sample=True, device=dev)
            dec = tok.batch_decode(out.cpu().numpy(),
                                   skip_special_tokens=True)
            for i, text in enumerate(dec):
                did = bd[i // args.n_gen_query]
                if did is not None:
                    rows.append((text, did))
        return rows

    def corpus_texts(wanted=None):
        """(did, content) rows, restricted to ``wanted`` doc ids."""
        return [(int(d), c) for d, _, c in _corpus_rows(args.corpus)
                if wanted is None or int(d) in wanted]

    def write(rows):
        with open(args.output, "w", encoding="utf-8") as fw:
            for q, d in rows:
                fw.write(f"{q}\t{d}\n")

    if args.repair:
        from ..data import io as dio
        from ..data.prepare import qg_repair
        rows = [(q, ids[0]) for q, ids in
                dio.read_query_docids_tsv(args.repair)]
        for rnd in range(args.repair_rounds):
            rows, need = qg_repair(rows, n_per_doc=args.n_gen_query)
            if not need:
                break
            print(f"repair round {rnd}: {len(need)} docs need "
                  "regeneration", file=sys.stderr)
            todo = corpus_texts(set(need))
            rows += gen_rows([c for _, c in todo], [d for d, _ in todo])
        rows, need = qg_repair(rows, n_per_doc=args.n_gen_query)
        write(rows)
        print(f"repaired qg written: {len(rows)} rows, "
              f"{len(need)} docs still short")
        return rows
    todo = corpus_texts()
    rows = gen_rows([c for _, c in todo], [d for d, _ in todo])
    write(rows)
    return rows


def cmd_evaluate(args):
    """Recall/MRR of a ranks tsv against a gt tsv (host only)."""
    from ..data import io as dio
    from ..eval.metrics import evaluate_ranks
    gts = dio.read_gt_dict(args.gt_file)
    preds, _, _ = dio.parse_result_tsv(
        args.ranks_file, {"query": 0, "pred": args.pred_col})
    ks = tuple(int(x) for x in args.recall_num.split(","))
    m = evaluate_ranks(gts, preds, ks)
    for name in ("recall", "mrr"):
        for k in ks:
            print(f"{name.upper()}{k}", m[name][k])
    if args.ofile:
        with open(args.ofile, "w") as fw:
            json.dump(m, fw, indent=1)


def cmd_ensemble(args):
    """Fuse an ANCE run with the coarse (and fine) MEVI runs over a grid
    of (alpha, beta, gamma) (host only, ``ensemble_marco.py``)."""
    import pickle
    from ..data import io as dio
    from ..eval.ensemble import run_ensemble
    gts = dio.read_gt_dict(args.gt_file)
    ance_preds, ance_scores, _ = dio.parse_result_tsv(
        args.ance_file, {"query": 0, "pred": 2, "score": 3})
    _, _, clusters = dio.parse_result_tsv(args.coarse_file,
                                          {"query": 0, "cluster": 1})
    fine_preds = fine_scores = None
    if args.fine_file:
        fine_preds, fine_scores, _ = dio.parse_result_tsv(
            args.fine_file, {"query": 0, "pred": 2, "score": 3})
    if args.mapping_file.endswith(".pkl"):
        with open(args.mapping_file, "rb") as fr:
            mapping = pickle.load(fr)
    else:
        codes = np.load(args.mapping_file)
        mapping = {i: tuple(c.tolist()) for i, c in enumerate(codes)}
    results = run_ensemble(
        gts, ance_preds, ance_scores, clusters, mapping,
        fine_preds, fine_scores,
        alphas=tuple(float(x) for x in args.alphas.split(",")),
        betas=tuple(float(x) for x in args.betas.split(",")),
        gammas=tuple(float(x) for x in args.gammas.split(",")),
        recall_ks=tuple(int(x) for x in args.recall_num.split(",")))
    lines = []
    for (a, b, g), m in results.items():
        lines.append(f"alpha={a} beta={b} gamma={g}: " + " ".join(
            f"R@{k}={v:.6f}" for k, v in m["recall"].items()) + " "
            + " ".join(f"MRR@{k}={v:.6f}" for k, v in m["mrr"].items()))
    print("\n".join(lines))
    if args.ofile:
        with open(args.ofile, "w") as fw:
            fw.write("\n".join(lines) + "\n")


# --------------------------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(prog="mevi_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("gen-embeddings")
    sp.add_argument("--config", default=None)
    sp.add_argument("--checkpoint", required=True)
    sp.add_argument("--documents", required=True)
    sp.add_argument("--doc_length", type=int, default=128)
    sp.add_argument("--output", required=True)
    sp.add_argument("--profile", action="store_true",
                    help="encoder latency across batch sizes")
    sp.set_defaults(fn=cmd_gen_embeddings)

    sp = sub.add_parser("build-index")
    sp.add_argument("--config", default=None)
    sp.add_argument("--embeddings", required=True)
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--cache_dir", default=None)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--iters", type=int, default=25)
    sp.set_defaults(fn=cmd_build_index)

    sp = sub.add_parser("build-hier")
    sp.add_argument("--config", default=None)
    sp.add_argument("--embeddings", required=True)
    sp.add_argument("--output_dir", required=True)
    sp.add_argument("--k", type=int, default=30)
    sp.add_argument("--c", type=int, default=30)
    sp.add_argument("--layers", default="1,2,3")
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--iters", type=int, default=10)
    sp.set_defaults(fn=cmd_build_hier)

    sp = sub.add_parser("search")
    sp.add_argument("--config", default=None)
    sp.add_argument("--doc_embeddings", required=True)
    sp.add_argument("--query_embeddings", required=True)
    sp.add_argument("--queries_tsv", default=None)
    sp.add_argument("--topk", type=int, default=1000)
    sp.add_argument("--batch", type=int, default=256)
    sp.add_argument("--bf16", action="store_true")
    sp.add_argument("--profile", action="store_true",
                    help="latency profile across batch sizes")
    sp.add_argument("--adc_codes", default=None,
                    help="rq_codes.npy: ADC scan instead of exact MIPS")
    sp.add_argument("--adc_codebooks", default=None,
                    help="rq_codebooks.npy (required with --adc_codes)")
    sp.add_argument("--output", default=None)
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("train")
    sp.add_argument("--config", default=None)
    sp.add_argument("--queries", required=True,
                    help="token memmap prefix")
    sp.add_argument("--query_length", type=int, default=32)
    sp.add_argument("--codes", required=True,
                    help="rq_codes.npy (per doc)")
    sp.add_argument("--train_tsv", default=None,
                    help="query->docid tsv aligning rows to codes")
    sp.add_argument("--log_dir", default=None)
    sp.add_argument("--log_every", type=int, default=50)
    sp.add_argument("--max_epochs", type=int, default=0)
    sp.add_argument("--resume", default=None,
                    help="'best' or a checkpoint tag")
    sp.add_argument("--dev_queries", default=None,
                    help="npy (n, qlen) dev query tokens: enables the "
                         "between-epoch coarse-hit@10 probe and ranks "
                         "checkpoints on it (mode=max) instead of loss")
    sp.add_argument("--dev_codes", default=None,
                    help="npy (n, M) gt RQ codes for --dev_queries")
    sp.add_argument("--dev_batch", type=int, default=256)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("doc2query")
    sp.add_argument("--checkpoint", required=True,
                    help="docT5query torch ckpt / state dict")
    sp.add_argument("--corpus", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--n_gen_query", type=int, default=10)
    sp.add_argument("--doc_max_len", type=int, default=512)
    sp.add_argument("--query_max_len", type=int, default=64)
    sp.add_argument("--num_layers", type=int, default=12)
    sp.add_argument("--d_model", type=int, default=768)
    sp.add_argument("--d_kv", type=int, default=64)
    sp.add_argument("--d_ff", type=int, default=3072)
    sp.add_argument("--num_heads", type=int, default=12)
    sp.add_argument("--batch", type=int, default=32)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--allow_hash_tokenizer", action="store_true")
    sp.add_argument("--repair", default=None,
                    help="existing qg tsv: run the regeneration loop")
    sp.add_argument("--repair_rounds", type=int, default=3)
    sp.set_defaults(fn=cmd_doc2query)

    sp = sub.add_parser("train-joint")
    sp.add_argument("--config", default=None)
    sp.add_argument("--queries", required=True,
                    help="query token memmap prefix")
    sp.add_argument("--query_length", type=int, default=32)
    sp.add_argument("--train_tsv", required=True,
                    help="query -> docid tsv (row-aligned to queries)")
    sp.add_argument("--documents", required=True,
                    help="corpus token memmap prefix")
    sp.add_argument("--doc_length", type=int, default=128)
    sp.add_argument("--codebooks", default=None,
                    help="rq_codebooks.npy initial codebooks")
    sp.add_argument("--codes", default=None,
                    help="rq_codes.npy for in-cluster negative sampling")
    sp.add_argument("--tower_ckpt", default=None,
                    help="torch state dict for the twin tower")
    sp.add_argument("--pq_update", choices=["grad", "ema"],
                    default="grad")
    sp.add_argument("--alt_epochs", default=None,
                    help="'a,c': nci for a of every c epochs, twin rest")
    sp.add_argument("--dev_tsv", default=None,
                    help="dev tsv enabling RQ-refit validation")
    sp.add_argument("--val_every", type=int, default=1)
    sp.add_argument("--rq_iters", type=int, default=10)
    sp.add_argument("--monitor", default="recall100")
    sp.add_argument("--resume", default=None,
                    help="'best' or a checkpoint tag to resume from")
    sp.add_argument("--max_epochs", type=int, default=0)
    sp.add_argument("--log_dir", default=None)
    sp.add_argument("--allow_hash_tokenizer", action="store_true")
    sp.add_argument("--remat", action="store_true",
                    help="recompute each T5 block of the NCI and the "
                         "tower in the backward (training memory)")
    sp.set_defaults(fn=cmd_train_joint)

    sp = sub.add_parser("eval")
    sp.add_argument("--config", default=None)
    sp.add_argument("--nci_ckpt", required=True,
                    help="a checkpoint tag directory of this package or a "
                         "reference Lightning checkpoint file")
    sp.add_argument("--tower_ckpt", required=True)
    sp.add_argument("--embeddings", required=True)
    sp.add_argument("--codes", required=True)
    sp.add_argument("--dev_tsv", required=True)
    sp.add_argument("--query_length", type=int, default=32)
    sp.add_argument("--num_return_sequences", type=int, default=10)
    sp.add_argument("--recall_level", default="both")
    sp.add_argument("--recall_num", default="1,5,10,20,50,100,1000")
    sp.add_argument("--max_cluster_docs", type=int, default=4096)
    sp.add_argument("--rank_mode", default="score",
                    choices=("score", "beam_major"),
                    help="fine pool ordering: global tower top-k or "
                         "beam-rank-major with tower tiebreak")
    sp.add_argument("--batch_size", type=int, default=16)
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 fine index (host-streamed corpus too)")
    sp.add_argument("--corpus_int8", action="store_true",
                    help="int8-quantize the fine index (half memory)")
    sp.add_argument("--host_stream", action="store_true",
                    help="corpus stays host-resident; fine stage "
                         "streams bucket panels to the device (any "
                         "corpus size: the NQ 21M regime)")
    sp.add_argument("--eval_all_documents", action="store_true")
    sp.add_argument("--save_path", default=None)
    sp.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace here")
    sp.add_argument("--allow_hash_tokenizer", action="store_true")
    sp.add_argument("--nq_answer_offsets", default=None,
                    help="test_inverse_offsets.bin: NQ answer-set mode")
    sp.add_argument("--nq_answer_array", default=None,
                    help="test_inverse_array.bin (with --nq_answer_offsets)")
    sp.set_defaults(fn=cmd_eval)

    for sp in sub.choices.values():
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")

    # host-only commands: no --device
    sp = sub.add_parser("prepare")
    sp.add_argument("--raw_dir", required=True)
    sp.add_argument("--origin_dir", required=True)
    sp.add_argument("--doc_aug", action="store_true")
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("tokenize")
    sp.add_argument("--kind", choices=["corpus", "queries"], required=True)
    sp.add_argument("--style", default="ance")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--length", type=int, default=128)
    sp.add_argument("--allow_hash_tokenizer", action="store_true",
                    help="permit the offline HashTokenizer stub")
    sp.set_defaults(fn=cmd_tokenize)

    sp = sub.add_parser("evaluate")
    sp.add_argument("--gt_file", required=True)
    sp.add_argument("--ranks_file", required=True)
    sp.add_argument("--pred_col", type=int, default=-1)
    sp.add_argument("--recall_num", default="1,5,10,20,50,100,1000")
    sp.add_argument("--ofile", default=None)
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("ensemble")
    sp.add_argument("--gt_file", required=True)
    sp.add_argument("--ance_file", required=True)
    sp.add_argument("--coarse_file", required=True)
    sp.add_argument("--fine_file", default=None)
    sp.add_argument("--mapping_file", required=True)
    sp.add_argument("--alphas", default="0.6")
    sp.add_argument("--betas", default="0.03")
    sp.add_argument("--gammas", default="0.02")
    sp.add_argument("--recall_num", default="10,50,1000")
    sp.add_argument("--ofile", default=None)
    sp.set_defaults(fn=cmd_ensemble)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
