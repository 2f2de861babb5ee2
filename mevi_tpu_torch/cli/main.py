"""Command line of the port (``mevi_tpu.cli.main``'s index-build,
search, NCI-training and offline-metric subcommands; the others come
with the next training PR and slice E):

  build-index    RQ codebooks + CSR fine index  (marco_generate_*_rq.sh)
  build-hier     hierarchical k-means ids, prefix clusters, trie tables
  search         exact MIPS top-k over embeddings, or an ADC scan over
                 RQ codes                              (faiss_search.py)
  train          NCI seq2seq training              (marco_train_nci_rq.sh)
  evaluate       Recall/MRR of a ranks tsv against a gt tsv
  ensemble       ANCE + MEVI coarse/fine fusion grid  (ensemble_marco.py)

Every command takes the JAX package's flags and writes its output
files and lines.  The device commands also take ``--config
config.json`` (defaults when absent) and ``--device`` (default
``cuda``); ``evaluate`` and ``ensemble`` run on the host.  Run
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
import torch

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

    for sp in sub.choices.values():
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")

    # host-only commands: no --device
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
