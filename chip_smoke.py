#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mevi_tpu_torch``) on one NVIDIA
GPU: builds the hand-written bucket kernels from ``mevi_tpu_torch/csrc``,
holds each against its plain PyTorch version, serves batches end to end
and runs the offline evaluation at full width over an MS MARCO-scale
corpus.

    python3 chip_smoke.py [--seed 0] [--phase1-only | --phase6-only |
                                     --phase7-only | --phase8-only |
                                     --phase9-only | --phase10-only |
                                     --phase11-only | --phase12-only]

``--phase1-only`` builds the kernels, runs phase 1 and stops, with no
result line: the kernel A/B at phase-1 geometry.  ``--phase6-only``
builds the kernels and the models and runs phase 6 alone, with no
result line; ``--phase7-only`` runs phase 6a's corpus build, then
phase 7, with no result line; ``--phase8-only`` builds the kernels and
runs phase 8 alone, with no result line; ``--phase9-only`` runs phase
6a's corpus build, phase 7, then phase 9, with no result line;
``--phase10-only`` builds the kernels and runs phase 10 alone, with no
result line; ``--phase11-only`` builds the kernels, runs 10a (the bundle
phase 11 reads), then phase 11, with no result line; ``--phase12-only``
builds the kernels and runs phase 12 alone, with no result line.

Phases:
  1. the bucket kernels (v3, fused, v2 and raw modes) against their plain
     versions at serving geometry (G = 512 x 10 buckets, cap 512, d 768),
     bf16 queries over bf16 and int8 corpora, and float32 queries over a
     float32 copy (the instance phase 11a serves), with kernel / plain /
     yardstick times (CUDA events) and their bytes, achieved rate and
     bounds; v3 and fused also at the Evaluator's cap
     (``InferConfig().max_cluster_docs``, 4096) over the same buckets;
     then ``scripts.profile_bucket.profile`` (the v2 path) over the int8
     corpus; then the fused RMSNorm (``ops.rmsnorm``) against
     ``rmsnorm_plain`` on the same inputs at its served shapes (16,384 x
     768, 5,120 x 768, 16,384 x 2,048 and 512 of 576-wide rows in place)
     in every pair of x and weight dtypes, one bf16 ulp / 2e-6 relative,
     its gradients under autograd against the composition's, and
     ``scripts.profile_rmsnorm.profile`` (kernel, byte bound, plain
     composition, ``F.rms_norm``);
  2. the main path: ``BucketServer`` with the NCI model (T5-base
     12 + 6 layers, PAWA 4 layers, kary 32, M 4) and the T5 query tower
     (12 + 12 layers), random bf16 weights from the seed, over
     8,841,823 x 768 bf16 rows made on the device; batch 512, 10 beams,
     cap 512, pool 1000, length penalty 0.8; with the beam's own codes
     and with doc-weighted ``cidx_override``; one batch's pool
     recomputed with the plain bucket version;
  2b. the raw-score path on the last override batch:
     ``bucket_scores_dispatch`` (raw kernel) + ``mask_pool_topk``, held
     against the server's pool;
  3. served batches over the same corpus quantized to int8 (phase 2's
     warm-up and timed counts);
  4. offline evaluation (``Evaluator``, ``InferConfig`` defaults: 10
     beams, cap 4096, pool 1000) of 1,024 queries at batch 512 over the
     bf16 index; coarse metrics against a plain recomputation; host
     streaming over a host copy of the int8 corpus against the device
     reranker (v3 over the int8 corpus, its launches counted);
     ``eval_all_documents`` on the device against the host-streamed
     scan; the result tsvs written and read back;
  5. the index build, after phases 1-4's corpus is freed:
     ``build_rq_index`` of ``configs/marco_rq4x5.json`` (4 levels x 32,
     l2, 25 Lloyd iterations, seed 42, bf16 serving copy) over
     8,841,823 x 768 bf16 rows with RQ structure made on the device,
     timed per level, with peak memory, size histogram and
     reconstruction error; checks on the built index: (a) ``assign``
     on 262,144 rows against the trained codes, (b) the CSR is a
     permutation laid out by the codes, (c) ``doc_topk_codes`` (top 10)
     on 65,536 rows, (d) ``adc_search`` of 512 queries at k 1000 over
     the device one-hot matrix against a plain recompute, (e) one
     ``BucketServer`` batch over the built index against the plain
     pool; then the ``center_levels`` build on 1,048,576 rows and (f)
     ``hierarchical_kmeans_ids`` (k 30, c 30) on 65,536 rows;
  6. ``bench.py``'s synthetic corpus at its TPU geometry, after phase 5
     is freed (``data/synth.py``: 8,841,823 x 768, kary 32, 4 levels,
     seed 0, query length 32): (a) tables and Zipf draws on the host, the
     RQ fit on the card (500,000-row sample, 8 iterations), the CSR and
     the bf16 cluster-sorted fill, timed, with peak memory and cluster
     sizes; 65,536 sample rows held against ``gen_rows`` of their draws
     and their codes against ``assign``; (b) batches of 512 of its query
     language (2 warm-up, 5 timed) through ``BucketServer`` without and
     with the PAWA prefix tables (their build time and bytes), the beams
     of the two compared (and of a float32 copy of the NCI, each
     decoder's scores held against an exact float32 panel rescoring),
     one pool (gold-doc cluster first) against the plain bucket
     version; (c) the int8 scale from the true maximum over every row,
     the int8 fill after the bf16 one is freed, its sample rows and one
     batch; (d) ``ceiling_report`` for 512 clean queries and 512 with
     info dropout 0.3, with the seconds of each part; clean queries must
     find their documents (recall@100 1.0, recall@1 up to duplicates);
  7. training over phase 6's corpus: (a) ``mevi_tpu_torch.cli.main
     train --device cuda --max_epochs 1`` in-process over
     ``configs/marco_rq4x5.json`` with bf16 compute and dropout 0.1,
     76,800 query-language queries for random documents with their
     codes (150 steps at batch 512), the 1,024-query dev hit@10 probe:
     ms a step (median, spread), queries/s, model FLOPs a step and their
     share of the bf16 dense peak, peak memory, the first and last 20
     losses, the leaderboard; (b) the best tag restored through
     ``CheckpointManager``, bit for bit against the live parameters and
     optimizer state; (c) the first batch's loss in bf16 compute
     against float32 on the initial weights (within 2%); (d) bf16
     copies of the trained and of the initial NCI served through
     ``BucketServer`` (v3, batch 512, 10 beams, cap 512, pool 1000) over
     the bf16 fill, 2 warm-up and 5 timed batches of held-out queries:
     q/s, stage ms, pool filled, coarse hit@1/@10 and per-level top-beam
     prefix accuracy, one pool against the plain bucket version; (e) one
     twin-tower step (T5 12 + 12) and one joint step (NCI + tower +
     codebooks, ``pq_loss`` ce, the NCI frozen) then its EMA variant at
     batch 64, 7 negatives, 128 doc tokens, remat on: ms, peak, losses,
     every group's update non-zero (frozen exactly zero);
  8. the single-card CLI pipeline, each command in process through
     ``mevi_tpu_torch.cli.main.main([...])`` with ``--device cuda``,
     over ``configs/marco_rq4x5.json`` with bf16 compute and synthetic
     MS MARCO text from the seed (16,384 passages of ~32 Zipf words,
     4,096 train and 1,024 dev queries of words of their gold passage,
     in MS MARCO's raw file layouts; a T5-base ``T5Model`` checkpoint
     in HF names from seeded random tensors): (a) ``prepare --doc_aug``
     and ``tokenize`` (128 / 32 tokens, ``HashTokenizer``), whether the
     native library loaded; (b) ``gen-embeddings`` (emb/s, FLOPs and
     their share of the bf16 peak, the ``--profile`` table), 1,024 rows
     held against a float32 recompute (per-row relative L2 2e-2); (c)
     ``build-index`` (RQ 4 x 32, 25 iterations); (d) ``train
     --train_tsv`` one epoch at batch 512, then ``--resume best
     --max_epochs 2``, entered at the restored step; (e) ``eval`` of
     the dev queries at batch 512, 10 beams, ``--bf16``: plain,
     ``--corpus_int8``, ``--host_stream`` (equal to the device
     reranker's report), one batch's pool against the plain bucket
     version, the result tsvs read back; (f) ``train-joint`` (tower and
     codes and codebooks of (b)-(c), 4 steps at batch 64, 7 negatives,
     remat) whose validation refits RQ over the 16,384 passages and
     evaluates 256 dev queries, then ``--resume best``, bit for bit;
     (g) float32 decoding: ``trie_beam_search`` over ``build-hier`` ids
     (k 30, c 30) of 16,384 embeddings, 512 queries, 10 beams, every id
     a trie path to a terminal and its score the teacher-forced one
     (1e-3); ``brute_force_topk`` over all 32^4 sequences of (d)'s NCI
     for one query against ``nci_beam_search_incremental``; (h)
     ``doc2query`` (64 passages x 10 queries of 64 tokens, batch 128),
     a greedy ``generate`` of 64 passages against the panel's argmax at
     every step, one ``--repair`` round over 16 broken docs;
  9. the multi-device path (``mevi_tpu_torch.parallel``), its ranks
     spawned by ``launch_local`` on this one card over gloo (a card
     takes one NCCL rank): (a) ``ShardedBucketServer`` with phase 7's
     trained NCI (its state dict through a file) and phase 2's tower in
     four ranks, mesh data 2 x corpus 2, over phase 6's bf16 fill
     (refilled; each rank clones its 4,420,912-row shard from the
     parent's matrix, shared through CUDA IPC), weights checked equal
     by gathered checksums, batches of 512 of the query language (256 a
     data rank; 2 warm-up, 5 timed), stage ms and q/s a rank, each
     rank's v3 launches, pools against the single-device oracle (the
     plain version of v3 with ``align=1`` over the whole matrix on the
     ranks' own query reps and beams, then ``merge_pool``; scores
     1e-3), beams against
     a single-rank beam of the same slice; (b) the same over the int8
     fill; (c) one 256-query slice through a 1 x 1 mesh of a one-rank
     NCCL world against the oracle; (d) one data-parallel float32 NCI
     step and one twin step (cross-device negatives, one negative a
     query, remat) in two ranks at batch 64 each against the
     single-process step on the 128 rows with the ranks' row layout
     (the forward run on each 64-row half in turn, the two halves'
     gradients summed by autograd): parameters bitwise equal across
     the ranks, Adam's first moments (relative L2) within 4 times the
     same step's distance from itself with the batch's halves swapped
     (float32 rounding of the sum, measured in the same run; at least
     float32's epsilon), losses at 1e-4; parameters within 2 lr (a
     smoke check only: Adam's first update is lr g / (|g| + eps));
 10. the scripts that measure the served main path and its trained
     quality, each
     through its entry point: (a) ``scripts.quality_full``'s stages
     data, train, tower and eval (``QF_STAGE`` each in turn) at full
     width (T5-base NCI 12 + 6 with PAWA 4, a 12 + 12 tower, RQ 4 x 32,
     bf16), cut in depth (``QUAL10``: 153,600 documents, 300 NCI steps
     at batch 512, 800 tower steps, 512 dev queries), the bundle in a
     temporary directory removed at the end; the QUALITY json's coarse
     hits against a plain recomputation from ``served_eval.npz``; (b)
     ``bench``'s random-weight pipeline at bf16 over 8,841,823 x 768
     rows (its kernel check, recall against exact MIPS, 20 timed batches
     of 512, the reference-style baseline, the stage split), one timed
     batch's pool against the plain v3; (c) ``scripts.int8_tax`` over
     (a)'s bundle at 8,841,823 rows, the trained pipeline, bf16 then
     int8, each bench run a process of its own; its trained coarse keys
     equal between the two, its trained fine recall@100 within 0.02;
     (d) the same at the bundle's own 153,600 rows (5 timed batches),
     where the cap truncates few leaves, its trained fine
     recall@100 also above 0 in both.  Every bench line is printed
     whole, with every key of the JAX line, recalls under their
     coverage bound;
 11. the rest of the scripts, over 10a's bundle (kept until the end):
     (a) ``scripts.quality_full``'s ``sharded`` stage: the bundle in
     float32 served through ``ShardedBucketServer`` in eight ranks on
     the card (data 2 x corpus 4, the JAX stage's mesh; gloo; the v3
     kernel over a float32 corpus at ``align=1``) and through the
     single-device path in the ranks' row layout; gates:
     beam codes equal, canonical metrics equal, top-100 overlap above
     0.99; (b) ``scripts.data_ceiling`` over its dev set; (c)
     ``scripts.scaling_curve`` at 1,000,000 and 8,841,823 rows (the JAX
     curve's ends), int8, a bench process a size with 2 timed batches
     (``SCALE11``), every line whole and under its coverage bound; (d)
     ``scripts.nq_scale_demo`` at 21,015,324 rows and d 768: the mesh
     stage in a process of its own (eight ranks, each making its 4.03
     GB int8 shard on the card), its pool against the plain v3 over the
     same rows (1e-3), then stream (a 16.1 GB host memmap in a
     temporary directory) and adc (RQ 8 x 32, 5.4 GB one-hot); (e)
     ``scripts.quality_demo`` at its device widths (200,000 x 768, NCI
     6 + 3 at d 512, batch 256) with ``DEMO11`` steps of its 4,000; (f)
     the coarse stage's instruments at the serving shapes:
     ``profile_beam`` (with its traced breakdown), ``profile_step``,
     ``beam_trace`` (device ms by kernel category, share of the bf16
     peak) and ``trace_beam_only``;
 12. the NQ-DPR configuration (``configs/nqdpr_rq4x5.json``, bf16
     compute, one training epoch): (a) the port's
     ``scripts/nqdpr_pipeline.sh`` run stage by stage (prepare, answers,
     index, train, eval), each CLI call a process, over NQ's raw
     layouts made from the seed (65,536 passages of ~100 Zipf words in
     ``psgs_w100.tsv``, 16,384 items of ``biencoder-nq-train.json``,
     nq-test's 3,610 questions with 2-3 word answer spans in
     ``nq-test.qa.csv``) and ``ar2_nq.pkl``, two BERT towers at
     ERNIE-base widths (12 layers, d 768, type vocabulary 4) with HF's
     initialization under HF ``BertModel`` names; gates: 1,024 rows of
     ``docemb.bin`` against a float32 recompute with the ``ctx_model.``
     tower (per-row relative L2 2e-2), the eval report equal to a numpy
     recomputation from the result tsvs, ``rq_codes.npy`` and the
     inverse answer arrays, fine hitrate@100 above 0, one batch's pool
     against the plain v3 (1e-3), v3 launched by the eval stage; (b)
     ``Evaluator.evaluate_nq`` over 21,015,324 x 768 bf16 rows with RQ
     structure made on the card in CSR order (phase 5's recipe, the
     leaves scaled to the rows), (a)'s trained NCI and bf16
     ``question_model.`` tower, the 3,610 questions at batch 512,
     ``InferConfig`` defaults (10 beams, cap 4096, pool 1000), each
     question's answering passage planted at a drawn rank below 150 of
     the plain pool of its beams; gates: every planted rank found (ties
     aside) and the hit rates the planted shares, the coarse hit 1 for
     every planted question, the whole report equal to a numpy
     recomputation from the kept results, one batch's pool against the
     plain v3, v3 launched; one launch at cap 4096 timed alone, and
     ``merge_pool`` alone over its outputs.

Prints JSON lines as it goes; before the last line the card's name and
power limit and one JSON object of the kernels (the bf16 phase-1 run,
with the int8 run under ``int8`` and the float32 run under ``f32``, the
cap-4096 runs of v3 and fused under ``cap_4096``;
phase 9's and 11's launches summed over their ranks; phases 10's,
11's and 12's under ``launches_by_path``, bf16, int8 and f32; last the
fused RMSNorm's, its launches by path: phase 1's checks, each served
path's warm-up, with the beam's eager run and capture, and timed
batches, where the beam's replays launch without counting, and phase
7a's training); the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
card or if any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import os.path as osp
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

FULL = dict(ndocs=8_841_823, d=768, kary=32, levels=4, nonempty=305_777,
            sigma=1.9, batch=512, qlen=32, beams=10, cap=512, pool=1000,
            length_penalty=0.8, warmup=2, timed=5, kernel_reps=20,
            profile_reps=5, eval_queries=1024, stream_queries=64,
            vocab=32128, d_kv=64, d_ff=3072, heads=12, enc_layers=12,
            dec_layers=6, qdec_layers=12)
KERNEL_SRC = "mevi_tpu_torch/csrc/bucket.cu"
REPLACES = {
    "v3": "mevi_tpu/ops/bucket.py:297 (_kernel_v3; pallas_call :366)",
    "fused": "mevi_tpu/ops/bucket.py:93 (_fused_kernel; pallas_call :196)",
    "v2": "mevi_tpu/ops/bucket.py:206 (_kernel_v2; pallas_call :287)",
    "raw": "mevi_tpu/ops/bucket.py:41 (_kernel, v1; pallas_call :82)"}
BUILD = dict(config="configs/marco_rq4x5.json", seed=42, iters=25,
             noise=0.1, assign_rows=262_144, topk_rows=65_536, topk=10,
             adc_queries=512, adc_k=1000, hier_rows=65_536, hier_k=30,
             hier_c=30, hier_iters=10, center_rows=1_048_576)
SYNTH = dict(seed=0, fit_sample=500_000, fit_iters=8, check_rows=65_536,
             ceiling_queries=512, ceiling_dropout=0.3, f32_tol=2e-5,
             bf16_tie=2e-2)
# 76,800 queries = 150 steps at the config's batch 512 (300 steps until
# phase 12 needed the room: 60.7-64.4 s for phase 7); the twin and joint
# steps are cut to batch 64 (512 documents of 128 tokens through a 12 +
# 12 T5 tower) from the config's 512
TRAIN7 = dict(config="configs/marco_rq4x5.json", train_queries=76_800,
              steps=150, dev_queries=1024, dropout=0.1, bf16_gap=0.02,
              twin_batch=64, co_neg=7, doc_len=128)
# phase 8: 16,384 passages and 4,096 + 1,024 queries cut from MS MARCO's
# 8.8M and 502,939 + 6,980, build-hier on all 16,384 rows, 4 joint steps
# and 64 doc2query passages, for the script's time (phase 12 runs the same
# commands over 65,536 passages in the BERT family; at 65,536 passages,
# 16,384 + 1,024 queries, 20 joint steps and 512 doc2query passages
# phase 8 took 168-199 s); the models keep their widths
PIPE8 = dict(config="configs/marco_rq4x5.json", passages=16_384, words=32,
             vocab_words=30_000, zipf_a=1.1, query_words=6,
             train_queries=4_096, dev_queries=1_024, doc_len=128, qlen=32,
             check_rows=1_024, emb_tol=2e-2, rq_iters=25, eval_batch=512,
             joint_steps=4, joint_batch=64, joint_dev=256, co_neg=7,
             trie_rows=16_384, trie_queries=512, hier_k=30, hier_c=30,
             decode_tol=1e-3, brute_block=4096, d2q_passages=64, d2q_n=10,
             d2q_qlen=64, d2q_batch=128, greedy_rows=64, repair_docs=16)
# bytes of gathered window a phase-1 yardstick block holds at most
YARD_BYTES = 8.5e9
WRAPPER = {"v3": "bucket_scores_v3", "fused": "bucket_scores_fused",
           "v2": "bucket_scores_v2", "raw": "bucket_scores"}
# the fused RMSNorm at its served shapes (rows x d, /row stride): the beam
# encoder and the T5 tower, decoder steps 1-4, DeepSeek-V2's layers, its
# kv_a_layernorm read in place from 576-wide rows
RMS = dict(src="mevi_tpu_torch/csrc/rmsnorm.cu",
           replaces="none: mevi_tpu/models/t5.py:53 (RMSNorm, plain jnp)",
           shapes=("16384x768", "5120x768", "16384x2048", "16384x512/576"),
           grad_shape="5120x768", eps=1e-6, f32_rel=2e-6, grad_rel=1e-2)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """One entry per compiled kernel of ``nvcc -Xptxas -v``'s output:
    name and corpus pointer type (demangled where ``c++filt`` is
    present), registers, spill bytes (stores + loads).  Empty when the
    library was built by an earlier process."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append({"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            e["kernel"] for e in out), capture_output=True, text=True).stdout
        for e, n in zip(out, names.splitlines()):
            head, _, args = n.replace("(anonymous namespace)::", "").partition(
                "(")           # keep the corpus pointer: the int8 overload
            e["kernel"] = f"{head}({args.split(',')[0]}, ...)"
    return out


def timed_ms(fn, reps):
    """Median ms of ``reps`` calls, each between two CUDA events."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_corpus(cfg, dev, seed):
    """Cluster-sorted bf16 rows N(0, 1/d) made on the device, and codes
    with a skewed (log-normal, sigma 1.9) cluster-size distribution over
    ``nonempty`` of the K**M leaves; returns (semb, offsets, doc_ids,
    doc cluster ids)."""
    from mevi_tpu_torch.index.csr import build_csr, unpack_codes
    N, d, K, M = cfg["ndocs"], cfg["d"], cfg["kary"], cfg["levels"]
    rng = np.random.default_rng(seed)
    active = rng.choice(K ** M, size=min(cfg["nonempty"], K ** M),
                        replace=False)
    w = rng.lognormal(0.0, cfg["sigma"], size=active.size)
    counts = rng.multinomial(N, w / w.sum())
    doc_cluster = np.repeat(active, counts)
    rng.shuffle(doc_cluster)
    offsets, doc_ids = build_csr(unpack_codes(doc_cluster, M, K), K)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    semb = torch.empty((N, d), dtype=torch.bfloat16, device=dev)
    step = 1 << 20
    for s in range(0, N, step):
        n = min(step, N - s)
        semb[s:s + n] = torch.randn((n, d), generator=g, device=dev,
                                    dtype=torch.bfloat16).mul_(d ** -0.5)
    return semb, offsets, doc_ids, doc_cluster


def cluster_stats(offsets, cap):
    sizes = np.diff(offsets.astype(np.int64))
    nz = sizes[sizes > 0]
    return {"clusters": int(sizes.size), "nonempty": int(nz.size),
            "mean": float(nz.mean()), "p99": float(np.percentile(nz, 99)),
            "max": int(nz.max()), "over_cap": int((nz > cap).sum())}


def phase1_cidx(rng, doc_cluster, offsets, G):
    """Bucket ids for the kernel check: doc-weighted (real sizes, some
    over cap), uniform over all leaves (mostly small or empty), the
    biggest and the last cluster id."""
    C = len(offsets) - 1
    n_doc = G * 3 // 4
    ci = np.concatenate([doc_cluster[rng.integers(0, len(doc_cluster),
                                                  n_doc)],
                         rng.integers(0, C, G - n_doc)]).astype(np.int32)
    ci[0] = int(np.argmax(np.diff(offsets.astype(np.int64))))
    ci[1] = C - 1
    return ci


# ---------------------------------------------------------------------------
# phase 1: the kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernel(tag, semb, off_d, cidx, q, cap, dev, reps,
                 modes=("v3", "fused", "v2", "raw")):
    """Each of ``modes`` against its plain version on the phase-1
    buckets; kernel ms timed at the launch alone (the wrappers' bounds
    check, a host sync, stays out)."""
    from mevi_tpu_torch.ops import bucket as B
    from mevi_tpu_torch.scripts.profile_bucket import bound_ms, bytes_of
    ci = cidx.long()
    st, en = off_d[ci].contiguous(), off_d[ci + 1].contiguous()
    al = B.align_down(st)
    G, d = q.shape
    plain = B.bucket_scores_v3_plain(semb, st, en, q, cap)
    plain_raw = (B.bucket_scores_plain(semb, al, q, cap) if "raw" in modes
                 else None)
    runs = {
        "v3": (lambda: B.bucket_scores_v3(semb, st, en, q, cap, device=dev),
               lambda: B._launch(semb, q, cap, 8, starts=st, ends=en)),
        "fused": (lambda: B.bucket_scores_fused(semb, off_d, cidx, q, cap,
                                                device=dev),
                  lambda: B._launch(semb, q, cap, 8, offsets=off_d,
                                    cidx=cidx)),
        "v2": (lambda: B.bucket_scores_v2(semb, st, en, q, cap, device=dev),
               lambda: B._launch_v2(semb, st, en, q, cap, 8)),
        "raw": (lambda: B.bucket_scores(semb, al, q, cap, device=dev),
                lambda: B._launch_raw(semb, al, q, cap))}
    ok = plain[1] >= 0
    results = {}
    for mode in modes:
        checked, bare = runs[mode]
        out = checked()
        torch.cuda.synchronize()
        if mode == "raw":
            torch.testing.assert_close(out, plain_raw, rtol=1e-4, atol=1e-3)
            err = float((out - plain_raw).abs().max())
        else:
            if not torch.equal(out[1], plain[1]):
                raise AssertionError(f"{tag}/{mode}: rows differ from plain")
            torch.testing.assert_close(out[0], plain[0], rtol=1e-4,
                                       atol=1e-3)
            err = (float((out[0] - plain[0]).abs()[ok].max()) if ok.any()
                   else 0.0)
        results[mode] = dict(max_abs_err=err, ms=timed_ms(bare, reps))
    plain_ms = timed_ms(lambda: B.bucket_scores_v3_plain(
        semb, st, en, q, cap), 3)
    plain_raw_ms = (timed_ms(lambda: B.bucket_scores_plain(semb, al, q, cap),
                             3) if "raw" in modes else None)
    # the gathered window in blocks of at most YARD_BYTES (one block at
    # cap 512; 4-8 at cap 4096, whose whole window would take 32-64 GB)
    per = max(1, int(YARD_BYTES // (cap * d * (semb.element_size() + (
        q.element_size() if semb.dtype != q.dtype else 0)))))

    def yardstick():
        rows = (al.long()[:, None] + torch.arange(cap, device=dev)).clamp_(
            0, semb.shape[0] - 1)
        for g0 in range(0, G, per):
            r = rows[g0:g0 + per]
            block = semb.index_select(0, r.reshape(-1)).view(-1, cap, d)
            if block.dtype != q.dtype:
                block = block.to(q.dtype)
            torch.bmm(block, q[g0:g0 + per].unsqueeze(-1))
    yard_ms = timed_ms(yardstick, 5)
    nb = bytes_of(st.cpu().numpy(), en.cpu().numpy(), cap, d,
                  semb.element_size(), G, semb.shape[0], q.element_size())
    n_valid = int(ok.sum())
    flops_valid, flops_full = 2.0 * n_valid * d, 2.0 * G * cap * d
    for mode, r in results.items():
        if mode == "raw":
            r.update(plain_ms=plain_raw_ms,
                     bytes_full_window=nb["raw_full_window"],
                     bytes_unique_rows=nb["raw_unique_rows"],
                     gbps_full_window=nb["raw_full_window"]
                     / (r["ms"] * 1e-3) / 1e9,
                     bound_ms_full_window=bound_ms(nb["raw_full_window"],
                                                   flops_full),
                     bound_ms=bound_ms(nb["raw_unique_rows"], flops_full))
        else:
            r.update(plain_ms=plain_ms,
                     bytes_full_window=nb["full_window"],
                     bytes_valid_rows=nb["valid_rows"],
                     bytes_unique_rows=nb["unique_rows"],
                     gbps_valid_rows=nb["valid_rows"] / (r["ms"] * 1e-3)
                     / 1e9,
                     bound_ms_full_window=bound_ms(nb["full_window"],
                                                   flops_valid),
                     bound_ms_valid_rows=bound_ms(nb["valid_rows"],
                                                  flops_valid),
                     bound_ms=bound_ms(nb["unique_rows"], flops_valid))
        r["yardstick_ms"] = yard_ms
        emit(phase=1, corpus=tag, kernel=mode, G=G, cap=cap, d=d,
             valid_slots=n_valid, **r,
             yardstick="index_select + torch.bmm over the gathered "
                       "(G, cap, d) aligned window (unmasked: the raw "
                       "function; no single PyTorch call computes the "
                       "masked one)", yardstick_blocks=-(-G // per))
    return results


def bf16_ulps(a, b):
    """The largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(i >= 0x8000, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


# the fused RMSNorm's launches by path: phase 1's checks, each
# ``run_path`` (warm-up with the beam's eager run and capture, then the
# timed batches), phase 7a's training
RMS_LAUNCHES = {}


def check_rmsnorm(dev, seed, reps):
    """The fused RMSNorm against ``rmsnorm_plain`` on the same card
    inputs at ``RMS["shapes"]`` in every pair of x and weight dtypes: one
    bf16 ulp for a bf16 output, 2e-6 relative for a float32 one, two
    launches bitwise equal; the gradients through the kernel against the
    composition's at ``RMS["grad_shape"]``; then
    ``scripts.profile_rmsnorm.profile`` (bf16) for the kernel's ms against
    its byte bound, the plain composition's and ``F.rms_norm``'s."""
    from mevi_tpu_torch.ops import rmsnorm as R
    from mevi_tpu_torch.scripts import profile_rmsnorm
    k = R.build_kernel()
    emit(rmsnorm_build_s=k.build_seconds, library=k.path.name,
         ptxas=ptxas_summary(k.build_log))
    eps, bf16, f32 = RMS["eps"], torch.bfloat16, torch.float32
    pairs = ((bf16, bf16), (bf16, f32), (f32, bf16), (f32, f32))
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    n0 = R.launch_count()
    worst = dict(max_abs_err=0.0, bf16_ulps=0, f32_rel=0.0)
    for shape in RMS["shapes"]:
        rows, d, stride = profile_rmsnorm.parse_shape(shape)
        base = 3 * torch.randn((rows, stride), generator=g, device=dev)
        w32 = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        for xd, wd in pairs:
            x, w = base.to(xd)[:, :d], w32.to(wd)
            with torch.inference_mode():
                got = R.rmsnorm(x, w, eps)
                again = R.rmsnorm(x, w, eps)
                want = R.rmsnorm_plain(x, w, eps)
            tag = f"1_rmsnorm {shape} x {xd} w {wd}"
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two launches differ")
            if xd == bf16:
                ulps = bf16_ulps(got, want)
                if ulps > 1:
                    raise AssertionError(f"{tag}: {ulps} bf16 ulps")
                worst["bf16_ulps"] = max(worst["bf16_ulps"], ulps)
            else:
                rel = float(((got - want).abs() / want.abs().clamp_min(
                    1e-30)).max())
                if not rel <= RMS["f32_rel"]:
                    raise AssertionError(f"{tag}: relative error {rel}")
                worst["f32_rel"] = max(worst["f32_rel"], rel)
            worst["max_abs_err"] = max(worst["max_abs_err"], float(
                (got.float() - want.float()).abs().max()))
        del base, x, got, again, want
    # under autograd: the kernel's forward, the float32 backward
    rows, d, _ = profile_rmsnorm.parse_shape(RMS["grad_shape"])
    grad_err = 0.0
    for xd, wd in pairs:
        x = (3 * torch.randn((rows, d), generator=g, device=dev)).to(xd)
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(wd)
        go = torch.randn((rows, d), generator=g, device=dev).to(xd)
        grads = []
        for fn in (R.rmsnorm, R.rmsnorm_plain):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            fn(xa, wa, eps).backward(go)
            grads.append((xa.grad, wa.grad))
        for got, ref in zip(*grads):
            err = float((got.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            if not err <= RMS["grad_rel"]:
                raise AssertionError(f"1_rmsnorm grad x {xd} w {wd}: {err}")
            grad_err = max(grad_err, err)
    n_checks = R.launch_count() - n0
    if n_checks != len(RMS["shapes"]) * len(pairs) * 2 + len(pairs):
        raise AssertionError(f"1_rmsnorm: {n_checks} launches counted")
    RMS_LAUNCHES["1_checks"] = n_checks
    prof = profile_rmsnorm.profile(list(RMS["shapes"]), reps, seed)
    emit(phase="1_rmsnorm", shapes=list(RMS["shapes"]),
         dtype_pairs=[f"{a} x {b}" for a, b in pairs], launches=n_checks,
         **worst, grad_shape=RMS["grad_shape"], grad_max_rel_err=grad_err,
         profile=prof)
    head = prof["shapes"][RMS["shapes"][0]]
    return dict(**worst, grad_max_rel_err=grad_err, ms=head["kernel_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                library_ms=head["library_ms"], shapes=prof["shapes"])


# ---------------------------------------------------------------------------
# phases 2 and 3: the served path
# ---------------------------------------------------------------------------

def t5_widths(cfg):
    return dict(vocab_size=cfg["vocab"], d_model=cfg["d"], d_kv=cfg["d_kv"],
                d_ff=cfg["d_ff"], num_heads=cfg["heads"],
                num_layers=cfg["enc_layers"])


def build_qtower(cfg, dev, seed):
    """The T5 query tower (12 + 12) in bf16, random weights from the
    seed."""
    from mevi_tpu_torch.models.t5 import T5Dims, T5Model
    from mevi_tpu_torch.weights import init_random_
    qt5 = T5Dims(num_decoder_layers=cfg["qdec_layers"], **t5_widths(cfg))
    return init_random_(T5Model(qt5, device=dev, dtype=torch.bfloat16),
                        seed + 1)


def build_models(cfg, dev, seed):
    from mevi_tpu_torch.models.nci import NCIDims, NCIT5
    from mevi_tpu_torch.models.t5 import T5Dims
    from mevi_tpu_torch.weights import init_random_
    t5 = T5Dims(num_decoder_layers=cfg["dec_layers"], **t5_widths(cfg))
    nci = NCIT5(NCIDims(t5=t5, kary=cfg["kary"],
                        max_output_length=cfg["levels"] + 2),
                device=dev, dtype=torch.bfloat16)
    init_random_(nci, seed)
    return build_qtower(cfg, dev, seed), nci


def pool_with_plain(server, cidx, q_rep, B):
    """The server's pool with the bucket stage recomputed by the plain
    PyTorch version (same bounds, same query rows)."""
    from mevi_tpu_torch.ops.bucket import bucket_scores_v3_plain
    ci = cidx.long()
    off = server.csr.offsets_d
    s, r = bucket_scores_v3_plain(server.sorted_emb, off[ci], off[ci + 1],
                                  q_rep, server.cap)
    return server.pool_topk(s, r, B)


def compare_pools(tag, kern, plain, atol=1e-3):
    ks, kr = (t.cpu().numpy() for t in kern)
    ps, pr = (t.cpu().numpy() for t in plain)
    if not np.isfinite(ks).all():
        raise AssertionError(f"{tag}: non-finite pool scores")
    np.testing.assert_allclose(np.sort(ks, 1), np.sort(ps, 1), atol=atol,
                               rtol=0)
    gap = np.abs(np.diff(ps, axis=1)) > atol
    sep = np.ones_like(ps, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    if not (kr[sep] == pr[sep]).all():
        raise AssertionError(f"{tag}: pool ids differ from the plain path")
    return float(np.abs(ks - ps).max()), int(sep.sum())


def serve_stages(server, ids, mask, cidx_override):
    """One batch through the public stages, synchronized between them;
    returns (per-stage ms, finalized outputs, (cidx, q_rep))."""
    from mevi_tpu_torch.serve import Handle
    B = ids.shape[0]
    t0 = time.perf_counter()
    codes, bsc, cidx, q_rep = server.coarse(ids, mask)
    if cidx_override is not None:
        cidx = cidx_override
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores, rows, fault = server.bucket(cidx, q_rep)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ts, tr = server.pool_topk(scores, rows, B)
    out = server.finalize(Handle((ts, tr, codes, bsc), fault))
    t3 = time.perf_counter()
    ms = {"coarse_ms": (t1 - t0) * 1e3, "bucket_ms": (t2 - t1) * 1e3,
          "pool_finalize_ms": (t3 - t2) * 1e3}
    return ms, out, (cidx, q_rep, ts, tr)


def agree(tag, a, b, atol=1e-3):
    """Two served results of one batch: codes equal, pool scores
    within atol, >= 99% of pool ids equal (bf16 matmuls may reorder
    near-ties between calls)."""
    np.testing.assert_array_equal(a[2], b[2], err_msg=tag)
    np.testing.assert_allclose(a[0], b[0], atol=atol, rtol=0, err_msg=tag)
    same = float((a[1] == b[1]).mean())
    if same < 0.99:
        raise AssertionError(f"{tag}: only {same:.4f} of pool ids agree")


def check_outputs(tag, out, cfg, B):
    scores, ids, codes, bsc, ndoc = out
    k = min(cfg["pool"], cfg["beams"] * cfg["cap"])
    if scores.shape != (B, k) or ids.shape != (B, k):
        raise AssertionError(f"{tag}: pool shape {scores.shape}")
    if codes.shape != (B, cfg["beams"], cfg["levels"]):
        raise AssertionError(f"{tag}: codes shape {codes.shape}")
    if not (np.isfinite(bsc).all() and (np.diff(bsc, axis=1) <= 1e-6).all()):
        raise AssertionError(f"{tag}: beam scores not finite/descending")
    valid = ids >= 0
    if not np.isfinite(scores[valid]).all():
        raise AssertionError(f"{tag}: non-finite doc scores")
    if not ((codes >= 0) & (codes < cfg["kary"])).all():
        raise AssertionError(f"{tag}: codes out of range")
    return float(valid.mean()), float(ndoc.mean())


def run_path(tag, server, batches, cfg):
    """Warm-up, then timed batches; counts the launches of the served
    kernel (v3) only across this path's own batches, and the fused
    RMSNorm's in the warm-up and in the timed batches."""
    from mevi_tpu_torch.ops.bucket import launch_counts
    from mevi_tpu_torch.ops.rmsnorm import launch_count as rms_count
    from mevi_tpu_torch.utils.timers import counter
    rms0, cap0 = rms_count(), counter("beam.graph.capture")
    for ids, mask, ov in batches[:cfg["warmup"]]:
        server.finalize(server.query_device(ids, mask, ov))
    torch.cuda.synchronize()
    rms_warm = rms_count() - rms0
    captures = counter("beam.graph.capture") - cap0
    if captures and not rms_warm:
        raise AssertionError(f"{tag}: the beam's capture launched no "
                             "RMSNorm kernel")
    rms0 = rms_count()
    launches0 = launch_counts()["v3"]
    stage_ms, q_ms, last = [], [], None
    for ids, mask, ov in batches[cfg["warmup"]:]:
        ms, out, extra = serve_stages(server, ids, mask, ov)
        stage_ms.append(ms)
        t0 = time.perf_counter()
        out2 = server.finalize(server.query_device(ids, mask, ov))
        q_ms.append((time.perf_counter() - t0) * 1e3)
        agree(f"{tag}: stages vs query", out, out2)
        last = (ids, mask, ov, out, extra)
    launches = launch_counts()["v3"] - launches0
    if launches == 0:
        raise AssertionError(f"{tag}: the bucket kernel never launched")
    # timed: each served call's eager tower norms; the beam's replays
    # launch without counting
    rms_timed = rms_count() - rms0
    RMS_LAUNCHES[tag] = {"warmup": rms_warm, "captures": captures,
                         "timed": rms_timed,
                         "timed_per_call": rms_timed / (2 * len(stage_ms))}
    med = {k: statistics.median(m[k] for m in stage_ms)
           for k in stage_ms[0]}
    B = batches[0][0].shape[0]
    fill, ndoc = check_outputs(tag, last[3], cfg, B)
    emit(phase=tag, batches=len(stage_ms), batch=B, **med,
         query_ms=statistics.median(q_ms),
         queries_per_s=B / (statistics.median(q_ms) * 1e-3),
         kernel_launches=launches, pool_filled=fill, ndoc_per_query=ndoc,
         rmsnorm_launches=RMS_LAUNCHES[tag])
    return launches, last


def profile_path(server, batches, tag="2_profile"):
    """Device busy time, idle share and the top device kernels of served
    batches, from a ``torch.profiler`` (CUPTI) chrome trace read by
    ``utils.profiling.traced_stage_seconds`` (CUDA kernels only)."""
    from mevi_tpu_torch.utils.profiling import traced_stage_seconds
    tr = traced_stage_seconds(
        lambda i: server.finalize(server.query_device(*batches[i])),
        len(batches))
    n = len(batches)
    kern = sorted(tr.per_op.items(), key=lambda r: -r[1])
    emit(phase=tag, batches=n, wall_ms_per_batch=tr.wall_s * 1e3,
         device_busy_ms_per_batch=tr.device_s * 1e3,
         idle_share=1.0 - tr.device_s / tr.wall_s if tr.wall_s else None,
         device_kernels_per_batch=sum(tr.calls.values()) / n,
         top=[{"kernel": k[:90], "ms_per_batch": s * 1e3 / n,
               "calls_per_batch": tr.calls[k] / n} for k, s in kern[:12]])


# the kernels' launch counts at the last ``reset_counts``
COUNTS0 = {}


def reset_counts():
    from mevi_tpu_torch.ops.bucket import launch_counts
    COUNTS0.update(launch_counts())


def read_counts():
    """Launches of each kernel mode since the last ``reset_counts``."""
    from mevi_tpu_torch.ops.bucket import launch_counts
    return {mode: n - COUNTS0.get(mode, 0)
            for mode, n in launch_counts().items()}


# ---------------------------------------------------------------------------
# phase 2b: the raw-score path
# ---------------------------------------------------------------------------

def raw_path(server, cidx, q_rep, pool_ref, B, dev):
    """Raw kernel over aligned starts, masked and pooled per query by
    ``mask_pool_topk``, against the server's (v3) pool of the same
    buckets.  Returns the raw kernel's launches on this path."""
    from mevi_tpu_torch.eval import searcher as S
    from mevi_tpu_torch.ops.bucket import align_down
    ci = cidx.long()
    st = server.csr.offsets_d[ci].contiguous()
    en = server.csr.offsets_d[ci + 1].contiguous()
    al = align_down(st)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    raw = S.bucket_scores_dispatch(server.sorted_emb, al, q_rep, server.cap,
                                   device=dev)
    pooled = S.mask_pool_topk(raw, al, st, en, server.cap, server.pool, B,
                              server.num_beams)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = read_counts()
    if n["raw"] == 0:
        raise AssertionError("2b: the raw kernel never launched")
    err, n_sep = compare_pools("2b_raw_vs_server", pooled, pool_ref)
    emit(phase="2b_raw_path", raw_launches=n["raw"], launches=n,
         raw_plus_mask_pool_ms=ms, max_abs_pool_err=err,
         ids_compared=n_sep)
    return n["raw"]


# ---------------------------------------------------------------------------
# phase 4: offline evaluation
# ---------------------------------------------------------------------------

def plain_coarse_metrics(results, gts, doc_codes, ks):
    """Coarse Recall/MRR/HitRate@k by a per-query loop over the beam codes
    (one gt doc a query): the first beam whose code tuple is the gt
    doc's."""
    codes = np.concatenate([r.beam_codes for r in results])
    agg = {m: {k: 0.0 for k in ks} for m in ("recall", "mrr", "hitrate")}
    for i, g in enumerate(gts):
        want = tuple(doc_codes[g[0]].tolist())
        rank = next((j for j, c in enumerate(codes[i].tolist())
                     if tuple(c) == want), None)
        for k in ks:
            hit = rank is not None and rank < k
            agg["recall"][k] += float(hit)
            agg["hitrate"][k] += float(hit)
            agg["mrr"][k] += 1.0 / (rank + 1) if hit else 0.0
    return {m: {k: v / len(gts) for k, v in d.items()}
            for m, d in agg.items()}


def pools_of(results):
    return (np.concatenate([r.fine_scores for r in results]),
            np.concatenate([r.fine_ids for r in results]))


def free_g():
    return subprocess.run(["free", "-g"], capture_output=True,
                          text=True).stdout.strip().splitlines()


def eval_phase(cfg, seed, dev, qtower, nci, index, semb_i8, scale,
               doc_cluster, offsets, doc_ids):
    from mevi_tpu_torch.config import InferConfig
    from mevi_tpu_torch.data.io import parse_result_tsv
    from mevi_tpu_torch.eval.run_eval import Evaluator, write_result_files
    from mevi_tpu_torch.eval.searcher import FineIndex, FineReranker
    from mevi_tpu_torch.index.csr import unpack_codes
    rng = np.random.default_rng(seed + 11)
    n = cfg["eval_queries"]
    ids = rng.integers(2, cfg["vocab"], size=(n, cfg["qlen"])).astype(
        np.int32)
    mask = np.ones_like(ids)
    queries = [f"q{i}" for i in range(n)]
    gts = [[int(g)] for g in rng.integers(0, len(doc_cluster), n)]
    doc_codes = unpack_codes(doc_cluster, cfg["levels"], cfg["kary"])
    icfg = InferConfig()
    B = cfg["batch"]

    # 4a: evaluate over the bf16 index on the card
    ev = Evaluator(nci, icfg, fine_index=index,
                   query_rep_fn=qtower.first_token_rep,
                   doc_codes=doc_codes, device=dev)
    ev.run_batch(queries[:B], ids[:B], mask[:B])       # warm-up
    torch.cuda.synchronize()
    ev.timings.clear()
    reset_counts()
    t0 = time.perf_counter()
    out = ev.evaluate(queries, ids, mask, gts, batch_size=B,
                      keep_results=True)
    wall = time.perf_counter() - t0
    n_eval = read_counts()
    if n_eval["v3"] == 0:
        raise AssertionError("4: the v3 kernel never launched")
    ks = sorted({k for k in icfg.recall_num
                 if k <= icfg.num_return_sequences}
                | {icfg.num_return_sequences})
    plain = plain_coarse_metrics(out.results, gts, doc_codes, ks)
    for m in plain:
        for k in ks:
            if abs(plain[m][k] - out.coarse[m][k]) > 1e-12:
                raise AssertionError(f"4: coarse {m}@{k} differs from the "
                                     "plain recomputation")
    fs, fi = pools_of(out.results)
    if fs.shape != (n, max(icfg.recall_num)) or not np.isfinite(fs).all():
        raise AssertionError(f"4: fine pool shape {fs.shape} / non-finite")
    med = {k: statistics.median(t[k] for t in ev.timings)
           for k in ev.timings[0]}
    emit(phase="4_evaluate", queries=n, batch=B, batches=len(ev.timings),
         coarse=out.coarse, fine=out.fine,
         ndoc_per_query=out.ndoc_per_query, nonempty_hit=out.nonempty_hit,
         pool_filled=float((fi >= 0).mean()), **med,
         queries_per_s=n / wall, launches=n_eval,
         coarse_equals_plain_recomputation=True)

    # 4b: result tsvs, written and read back
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: f"{tmp}/{k}.tsv" for k in ("coarse", "fine", "hn")}
        write_result_files(out, gts, coarse_path=paths["coarse"],
                           fine_path=paths["fine"], hardneg_path=paths["hn"],
                           hard_neg_k=100)
        _, _, clus = parse_result_tsv(paths["coarse"],
                                      {"query": 0, "cluster": 1})
        preds, _, _ = parse_result_tsv(paths["fine"], {"query": 0, "pred": 2})
        hn, hn_s, _ = parse_result_tsv(paths["hn"], {"query": 0, "pred": 2,
                                                     "score": 3})
    want = [int((row >= 0).sum()) for row in fi]
    if not (len(clus) == len(preds) == len(hn) == n
            and [len(preds[q]) for q in queries] == want
            and all(len(clus[q]) == icfg.num_return_sequences
                    for q in queries)
            and [len(hn[q]) for q in queries] == [min(w, 100) for w in want]
            and all(len(hn_s[q]) == len(hn[q]) for q in queries)):
        raise AssertionError("4: result tsvs do not read back")
    emit(phase="4_result_tsvs", rows=n, fine_ids=int(sum(want)))

    # 4c: host streaming over a host copy of the int8 corpus, against the
    # device reranker over the same int8 index with the same window
    # contract (unaligned, clusters cut at cap: HostStreamFineReranker's)
    emit(phase="4_host_memory", free_g=free_g())
    t0 = time.perf_counter()
    host_i8 = semb_i8.cpu()
    copy_s = time.perf_counter() - t0
    index8 = index._replace(sorted_emb=semb_i8)
    index8_host = FineIndex(torch.from_numpy(offsets), torch.from_numpy(
        doc_ids), host_i8, cfg["levels"], cfg["kary"], host_offsets=offsets,
        host_doc_ids=doc_ids)
    inv = 1.0 / scale

    def rep8(i, m):       # int8 scores calibrated: 1/scale in the query
        return qtower.first_token_rep(i, m) * inv
    m = cfg["stream_queries"]
    ev_hs = Evaluator(nci, icfg, fine_index=index8_host, query_rep_fn=rep8,
                      doc_codes=doc_codes, host_stream=True, device=dev)
    out_hs = ev_hs.evaluate(queries[:m], ids[:m], mask[:m], gts[:m],
                            batch_size=m, keep_results=True)
    hs_ms = ev_hs.timings[-1]
    dev_rr = FineReranker(index8, icfg.max_cluster_docs,
                          max(icfg.recall_num), overflow="truncate",
                          align=1, device=dev)
    codes_hs = np.concatenate([r.beam_codes for r in out_hs.results])
    with torch.inference_mode():
        qemb = rep8(torch.from_numpy(ids[:m]).to(dev),
                    torch.from_numpy(mask[:m]).to(dev))
    reset_counts()
    ds, di, dn = dev_rr(qemb, codes_hs)
    n_4c = read_counts()["v3"]
    if n_4c == 0:
        raise AssertionError("4c: the v3 kernel never launched")
    hs_s, hs_i = pools_of(out_hs.results)
    err, n_sep = compare_pools("4_host_stream", (torch.from_numpy(hs_s),
                                                 torch.from_numpy(hs_i)),
                               (torch.from_numpy(ds), torch.from_numpy(di)))
    emit(phase="4_host_stream", queries=m, host_copy_s=copy_s,
         host_stream_ms=hs_ms, max_abs_pool_err=err, ids_compared=n_sep,
         device_rerank_v3_launches=n_4c,
         pool_filled=float((hs_i >= 0).mean()),
         ndoc_equal=bool((np.concatenate([r.ndoc for r in out_hs.results])
                          == dn).all()))

    # 4d: eval_all_documents, device scan vs host-streamed scan (one batch)
    acfg = InferConfig(eval_all_documents=True)
    res = {}
    for tag, fidx, hs in (("device", index8, False),
                          ("host_stream", index8_host, True)):
        ev_a = Evaluator(nci, acfg, fine_index=fidx, query_rep_fn=rep8,
                         doc_codes=doc_codes, host_stream=hs, device=dev)
        res[tag] = (ev_a.run_batch(queries[:B], ids[:B], mask[:B]),
                    ev_a.timings[-1])
    (rd, td), (rh, th) = res["device"], res["host_stream"]
    err_a, n_sep_a = compare_pools(
        "4_eval_all", (torch.from_numpy(rd.fine_scores),
                       torch.from_numpy(rd.fine_ids)),
        (torch.from_numpy(rh.fine_scores), torch.from_numpy(rh.fine_ids)))
    emit(phase="4_eval_all_documents", queries=B, device_ms=td,
         host_stream_ms=th, max_abs_pool_err=err_a, ids_compared=n_sep_a)
    return n_eval, n_4c


# ---------------------------------------------------------------------------
# phase 5: the RQ index build at full width
# ---------------------------------------------------------------------------

def make_structured_corpus(cfg, dev, seed):
    """Rows with structure k-means can find, made on the device: four
    random level codebooks (K x d, entries N(0, s_l^2 / d), s_l = 2^-l),
    doc codes drawn as :func:`make_corpus` draws them (log-normal leaf
    sizes), each row the sum of its four centroids plus N(0,
    noise^2 / d) noise, stored bf16.  Returns (rows, true codes)."""
    from mevi_tpu_torch.index.csr import unpack_codes
    N, d, K, M = cfg["ndocs"], cfg["d"], cfg["kary"], cfg["levels"]
    rng = np.random.default_rng(seed + 21)
    active = rng.choice(K ** M, size=min(cfg["nonempty"], K ** M),
                        replace=False)
    w = rng.lognormal(0.0, cfg["sigma"], size=active.size)
    doc_cluster = np.repeat(active, rng.multinomial(N, w / w.sum()))
    rng.shuffle(doc_cluster)
    codes = unpack_codes(doc_cluster, M, K)
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    books = [torch.randn((K, d), generator=g, device=dev) * (0.5 ** lvl)
             * d ** -0.5 for lvl in range(M)]
    codes_d = torch.from_numpy(codes).to(dev).long()
    emb = torch.empty((N, d), dtype=torch.bfloat16, device=dev)
    step = 1 << 18
    for s in range(0, N, step):
        c = codes_d[s:s + step]
        x = torch.randn((c.shape[0], d), generator=g, device=dev).mul_(
            BUILD["noise"] * d ** -0.5)
        for lvl in range(M):
            x += books[lvl][c[:, lvl]]
        emb[s:s + c.shape[0]] = x.to(torch.bfloat16)
    return emb, codes


def check_csr(tag, arts, n):
    """(b) The CSR is a permutation of arange(n) laid out by the codes:
    offsets[-1] == n, offsets are the code counts' prefix sums, and the
    rows' packed codes never decrease."""
    from mevi_tpu_torch.index.csr import pack_codes
    off = arts.fine.host_offsets.astype(np.int64)
    ids = arts.fine.host_doc_ids
    if off[-1] != n or len(ids) != n:
        raise AssertionError(f"{tag}: offsets[-1] {off[-1]} != {n}")
    if not (np.bincount(ids, minlength=n) == 1).all():
        raise AssertionError(f"{tag}: doc ids are not a permutation")
    packed = pack_codes(arts.codes, arts.fine.kary).astype(np.int64)
    if not (np.diff(packed[ids]) >= 0).all() or not np.array_equal(
            np.diff(off), np.bincount(packed, minlength=len(off) - 1)):
        raise AssertionError(f"{tag}: CSR disagrees with the codes")


def check_assign(tag, emb, arts, dev, rows):
    """(a) ``assign`` with the built codebooks (and shift tables) on the
    first ``rows`` rows against the codes ``rq_train`` returned (see
    :func:`assign_agreement`)."""
    cbs = torch.from_numpy(arts.codebooks).to(dev)
    shift = (None if arts.prefix_shift is None else
             [torch.from_numpy(t).to(dev) for t in arts.prefix_shift])
    return assign_agreement(tag, emb[:rows], cbs, shift,
                            torch.from_numpy(arts.codes[:rows]).to(dev))


def assign_agreement(tag, x, cbs, shift, ref):
    """``assign`` of rows ``x`` against reference codes: at most 0.1% of
    rows may differ, each only where the top two similarities of its
    first differing level are within 1e-3 relative."""
    from mevi_tpu_torch.ops.rq import assign_with_logits
    rows = x.shape[0]
    codes, logits = assign_with_logits(x, cbs, "rq", "l2", shift)
    diff = codes != ref
    bad = diff.any(-1).nonzero()[:, 0]
    n_diff = int(bad.numel())
    worst = 0.0
    if n_diff:
        lvl = diff[bad].int().argmax(-1)
        top2 = logits[bad, lvl].topk(2, -1).values
        rel = (top2[:, 0] - top2[:, 1]).abs() / top2[:, 0].abs().clamp_min(
            1e-30)
        worst = float(rel.max())
    if n_diff > 0.001 * rows or worst >= 1e-3:
        raise AssertionError(f"{tag}: {n_diff} of {rows} rows differ from "
                             f"rq_train's codes (top-2 gap {worst:.3g})")
    return {"rows": rows, "rows_differing": n_diff,
            "max_rel_top2_gap_of_differing": worst}


def adc_check(emb, arts, dev, seed):
    """(d) ``adc_search`` of 512 queries at k 1000 over the device
    one-hot matrix, timed; 8 queries' scores held against a plain
    recompute over the reconstructed rows (float32, atol 1e-2), at the
    returned ids and as the exact top-k."""
    from mevi_tpu_torch.ops.adc import adc_search, fill_onehot_matrix
    from mevi_tpu_torch.ops.rq import reconstruct
    N = emb.shape[0]
    K, nq, k, n8 = arts.fine.kary, BUILD["adc_queries"], BUILD["adc_k"], 8
    t0 = time.perf_counter()
    oh = fill_onehot_matrix(arts.codes, K, device=dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    pick = torch.randint(0, N, (nq,), generator=g, device=dev)
    q = emb[pick].float() + 0.05 * emb.shape[1] ** -0.5 * torch.randn(
        (nq, emb.shape[1]), generator=g, device=dev)
    cbs = torch.from_numpy(arts.codebooks).to(dev).float()
    adc_search(q[:n8], cbs, oh, k=k, device=dev)                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, ids = adc_search(q, cbs, oh, k=k, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (torch.isfinite(scores).all() and (ids >= 0).all()
            and (ids < N).all()):
        raise AssertionError("5d: ADC scores non-finite or ids outside "
                             "the corpus")
    codes_d = torch.from_numpy(arts.codes).to(dev)
    plain = torch.empty((n8, N), dtype=torch.float32, device=dev)
    for s in range(0, N, 1 << 16):
        plain[:, s:s + (1 << 16)] = q[:n8] @ reconstruct(
            codes_d[s:s + (1 << 16)], cbs).T
    at_ids = torch.gather(plain, 1, ids[:n8])
    exact = plain.topk(k, -1).values
    err_ids = float((scores[:n8] - at_ids).abs().max())
    err_top = float((scores[:n8] - exact).abs().max())
    if err_ids > 1e-2 or err_top > 1e-2:
        raise AssertionError(f"5d: ADC scores off the plain recompute "
                             f"({err_ids:.3g} at ids, {err_top:.3g} top-k)")
    return {"queries": nq, "k": k, "onehot_fill_s": fill_s,
            "onehot_gb": oh.numel() / 1e9, "search_ms": ms,
            "queries_per_s": nq / (ms * 1e-3),
            "max_abs_err_at_ids": err_ids, "max_abs_err_topk": err_top}


def serve_built(cfg, seed, dev, qtower, nci, arts):
    """(e) One ``BucketServer`` batch of 512 over the built fine index,
    doc-weighted ``cidx_override``; its pool held against the plain
    bucket recomputation.  Returns the v3 kernel's launches on it."""
    from mevi_tpu_torch.index.csr import pack_codes
    from mevi_tpu_torch.serve import BucketServer
    server = BucketServer(qtower, nci, arts.fine, num_beams=cfg["beams"],
                          cap=cfg["cap"], pool=cfg["pool"],
                          length_penalty=cfg["length_penalty"], device=dev)
    rng = np.random.default_rng(seed + 41)
    B, G = cfg["batch"], cfg["batch"] * cfg["beams"]
    ids = torch.from_numpy(rng.integers(2, cfg["vocab"], size=(
        B, cfg["qlen"])).astype(np.int32)).to(dev)
    mask = torch.ones_like(ids)
    ov = torch.from_numpy(pack_codes(arts.codes[rng.integers(
        0, len(arts.codes), G)], arts.fine.kary)).to(dev)
    server.finalize(server.query_device(ids, mask, ov))         # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms, out, (cidx, q_rep, ts, tr) = serve_stages(server, ids, mask, ov)
    n = read_counts()
    if n["v3"] == 0:
        raise AssertionError("5e: the v3 kernel never launched")
    err, n_sep = compare_pools("5e_plain", (ts, tr),
                               pool_with_plain(server, cidx, q_rep, B))
    fill, ndoc = check_outputs("5e_serve", out, cfg, B)
    emit(phase="5e_serve_built_index", batch=B, **ms, launches=n,
         max_abs_pool_err=err, ids_compared=n_sep, pool_filled=fill,
         ndoc_per_query=ndoc,
         cluster_sizes=cluster_stats(arts.fine.host_offsets, cfg["cap"]))
    return n["v3"]


def profile_lloyd(emb, arts, dev):
    """One Lloyd iteration (assignment + statistics pass over every row)
    with level 0's codebook, under ``torch.profiler``: wall and
    device-busy ms, top device kernels, and its bound (two reads of the
    corpus at the HBM rate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mevi_tpu_torch.ops.kmeans import kmeans_assign, kmeans_stats
    from mevi_tpu_torch.scripts.profile_bucket import bound_ms
    c = torch.from_numpy(arts.codebooks[0]).to(dev)
    kmeans_stats(emb[:1 << 16], kmeans_assign(emb[:1 << 16], c), c.shape[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kmeans_stats(emb, kmeans_assign(emb, c), c.shape[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    nbytes = 2 * emb.numel() * emb.element_size()
    emit(phase="5_profile_lloyd_iteration", wall_ms=wall,
         device_busy_ms=busy, idle_share=1.0 - busy / wall,
         bound_ms=bound_ms(nbytes, 2 * 2.0 * emb.numel() * c.shape[0]),
         device_kernels=sum(r[2] for r in kern),
         top=[{"kernel": k[:90], "ms": ms, "calls": n}
              for k, ms, n in kern[:8]])


def build_once(tag, cfg5, emb, dev):
    """``build_rq_index`` at the configuration's widths, timed per level,
    with peak device memory, the CSR's size histogram, the
    reconstruction error and the CSR check (b)."""
    from mevi_tpu_torch.index.build import build_rq_index
    from mevi_tpu_torch.index.csr import size_histogram
    from mevi_tpu_torch.ops.rq import reconstruction_mse
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    levels = []
    t0 = time.perf_counter()
    arts = build_rq_index(cfg5, emb, seed=BUILD["seed"],
                          iters=BUILD["iters"], serving_dtype=torch.bfloat16,
                          level_stats=levels, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_csr(tag, arts, emb.shape[0])
    codes_d = torch.from_numpy(arts.codes).to(dev)
    cbs = torch.from_numpy(arts.codebooks).to(dev)
    mse = {"reconstruction_mse": float(reconstruction_mse(emb, codes_d, cbs))}
    if arts.prefix_shift is not None:
        mse["reconstruction_mse_without_shift"] = mse["reconstruction_mse"]
        mse["reconstruction_mse"] = float(reconstruction_mse(
            emb, codes_d, cbs, prefix_shift=[torch.from_numpy(t).to(dev)
                                             for t in arts.prefix_shift]))
    emit(phase=tag, rows=int(emb.shape[0]), d=int(emb.shape[1]),
         levels=cfg5.rq.subvector_num, kary=cfg5.rq.kary,
         dist_mode=cfg5.rq.dist_mode, center_levels=cfg5.rq.center_levels,
         iters=BUILD["iters"], seed=BUILD["seed"], per_level=levels,
         build_s=build_s, peak_device_gb=peak,
         size_histogram=size_histogram(arts.fine.host_offsets),
         csr_is_permutation=True, **mse)
    return arts, build_s


def build_phase(cfg, seed, dev, qtower, nci):
    """Phase 5: ``build_rq_index`` of ``configs/marco_rq4x5.json`` over
    the structured corpus, checks (a)-(e) on the built index, the
    ``center_levels`` build, and (f) hierarchical ids.  Returns the v3
    kernel's launches on the served batch."""
    import dataclasses
    from mevi_tpu_torch.cli.main import load_config
    from mevi_tpu_torch.index.build import doc_topk_codes
    from mevi_tpu_torch.index.hierarchical import hierarchical_kmeans_ids
    from mevi_tpu_torch.ops.rq import beam_search
    t_phase = time.perf_counter()
    cfg5 = load_config(str(Path(__file__).resolve().parent / BUILD["config"]))
    if (cfg5.rq.subvector_num, cfg5.rq.kary, cfg5.rq.emb_size) != (
            cfg["levels"], cfg["kary"], cfg["d"]):
        raise AssertionError("5: the config's geometry is not the corpus'")
    t0 = time.perf_counter()
    emb, true_codes = make_structured_corpus(cfg, dev, seed)
    torch.cuda.synchronize()
    emit(phase="5_corpus", rows=int(emb.shape[0]), d=int(emb.shape[1]),
         corpus_gb=emb.numel() * 2 / 1e9, setup_s=time.perf_counter() - t0,
         allocated_gb_before=torch.cuda.memory_allocated() / 1e9)

    arts, _ = build_once("5_build", cfg5, emb, dev)
    profile_lloyd(emb, arts, dev)
    emit(phase="5a_assign", **check_assign("5a", emb, arts, dev,
                                           BUILD["assign_rows"]))
    # (c) per-doc top-k codes by the codebook beam
    rows, topk = BUILD["topk_rows"], BUILD["topk"]
    t0 = time.perf_counter()
    tk_codes = doc_topk_codes(cfg5, emb[:rows], arts.codebooks, topk,
                              device=dev)
    topk_s = time.perf_counter() - t0
    bc, bs = beam_search(emb[:rows], torch.from_numpy(arts.codebooks).to(
        dev), topk, "rq", cfg5.rq.dist_mode, cfg5.rq.rq_topk_score)
    if not np.array_equal(bc.cpu().numpy(), tk_codes):
        raise AssertionError("5c: doc_topk_codes differs from beam_search")
    if not ((bs > 0).all() and (bs <= 1).all()
            and (bs[:, 1:] <= bs[:, :-1]).all()):
        raise AssertionError("5c: beam scores outside (0, 1] or increasing")
    top1 = float((tk_codes[:, 0] == arts.codes[:rows]).all(-1).mean())
    emit(phase="5c_doc_topk_codes", rows=rows, topk=topk, seconds=topk_s,
         top1_equals_assignment=top1,
         min_score=float(bs.min()), max_score=float(bs.max()))
    emit(phase="5d_adc", **adc_check(emb, arts, dev, seed))
    n_build = serve_built(cfg, seed, dev, qtower, nci, arts)
    # how much of the generating level-0 structure the build found: the
    # share of docs in their built level-0 cluster's majority true code
    K = cfg["kary"]
    table = np.bincount(arts.codes[:, 0].astype(np.int64) * K
                        + true_codes[:, 0], minlength=K * K).reshape(K, K)
    purity = float(table.max(1).sum() / len(true_codes))
    del arts
    gc.collect()
    torch.cuda.empty_cache()

    # the center_levels build (scripts/quality_full.py's path) on the
    # first 1,048,576 rows (full width until phase 12 needed the room:
    # 13.7-14.2 s)
    n_c = BUILD["center_rows"]
    cfg_c = dataclasses.replace(cfg5, rq=dataclasses.replace(
        cfg5.rq, center_levels=True))
    arts_c, _ = build_once("5_build_center_levels", cfg_c, emb[:n_c], dev)
    emit(phase="5a_assign_center_levels",
         **check_assign("5a_center", emb, arts_c, dev,
                        min(BUILD["assign_rows"], n_c)))
    del arts_c
    gc.collect()
    torch.cuda.empty_cache()

    # (f) hierarchical k-means ids, reduced: the full corpus means some
    # 10^4 k-means calls from the host
    n_h = BUILD["hier_rows"]
    t0 = time.perf_counter()
    ids = hierarchical_kmeans_ids(emb[:n_h], k=BUILD["hier_k"],
                                  c=BUILD["hier_c"], iters=BUILD["hier_iters"],
                                  device=dev)
    hier_s = time.perf_counter() - t0
    if len(ids) != n_h or len({tuple(s) for s in ids}) != n_h or \
            min(len(s) for s in ids) < 1:
        raise AssertionError("5f: hierarchical ids not unique / not covering")
    lens = [len(s) for s in ids]
    emit(phase="5f_hierarchical_ids", rows=n_h, k=BUILD["hier_k"],
         c=BUILD["hier_c"], iters=BUILD["hier_iters"], seconds=hier_s,
         max_len=max(lens), mean_len=sum(lens) / n_h, reduced=True)
    emit(phase="5_done", seconds=time.perf_counter() - t_phase,
         level0_purity=purity,
         center_levels_rows=n_c,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    return n_build


# ---------------------------------------------------------------------------
# phase 6: bench.py's synthetic corpus at full width
# ---------------------------------------------------------------------------

@torch.inference_mode()
def rescore_f32(nci32, ids, mask, codes, length_penalty, chunk=128):
    """Length-normalised log-probs of given beams (B, nb, M) under a
    float32 NCI, teacher-forced through the panel ``compact_logits``
    (every position recomputed, PAWA net included: no tables)."""
    from mevi_tpu_torch.models.nci import codes_to_tokens
    B, nb, M = codes.shape
    K = nci32.dims.kary
    out = []
    for s in range(0, B, chunk):
        i, m = ids[s:s + chunk], mask[s:s + chunk]
        c = codes[s:s + chunk].reshape(-1, M).long().to(ids.device)
        enc = nci32.encode(i, m)
        mem, mmask, _ = nci32.build_memory(enc, m)
        zero = torch.zeros_like(c[:, :1])       # start token 0, EOS 1
        dec_in = torch.cat([zero, codes_to_tokens(c, K), zero + 1], 1)
        logits, _ = nci32.compact_logits(
            dec_in, mem.repeat_interleave(nb, 0),
            mmask.repeat_interleave(nb, 0))
        logp = torch.log_softmax(logits.float(), -1)
        tot = logp[:, :M].gather(2, c[..., None])[..., 0].sum(1) \
            + logp[:, M, K]
        out.append((tot / float(M + 1) ** length_penalty).reshape(-1, nb))
    return torch.cat(out).cpu().numpy()


def beams_diff(codes_a, scores_a, codes_b, scores_b):
    """Beams whose codes differ between two decoders of the same queries,
    and the gaps between the two beam scores there and elsewhere."""
    differ = (np.asarray(codes_a) != np.asarray(codes_b)).any(-1)
    gaps = np.abs(np.asarray(scores_a, np.float64)
                  - np.asarray(scores_b, np.float64))
    return {"beams": int(differ.size), "beams_differing": int(differ.sum()),
            "queries_differing": int(differ.any(1).sum()),
            "gaps_where_differing": sorted(
                (float(g) for g in gaps[differ]), reverse=True)[:40],
            "max_gap_where_equal": float(gaps[~differ].max())
            if (~differ).any() else 0.0}


def duplicate_stats(draws, gt, pool_n, kary):
    """Per gold doc: how many docs share its 4 draws (identical rows), and
    how many of them have a lower id."""
    keys = (((draws[:, 0].astype(np.int64) * kary + draws[:, 1]) * kary
             + draws[:, 2]) * pool_n + draws[:, 3])
    ids = np.nonzero(np.isin(keys, keys[gt]))[0]
    same = keys[ids][None, :] == keys[gt][:, None]
    total = same.sum(1)
    lower = (same & (ids[None, :] < gt[:, None])).sum(1)
    return total, lower


def timed(secs, name, fn):
    """``fn()`` between two synchronizations; its seconds go to
    ``secs[name]``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    return out


def synth_corpus(cfg, seed, dev):
    """Phase 6a: ``bench.py``'s corpus (``data/synth.py``) at its TPU
    geometry, built on the card, a sample of its rows and codes checked.
    Returns the corpus as a dict (spec, host tables, device tables,
    draws, codebooks, codes, CSR, the bf16 cluster-sorted fill, the
    sample) and the seconds of each step."""
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.index.csr import build_csr
    S = SYNTH
    K, M, cap = cfg["kary"], cfg["levels"], cfg["cap"]
    spec = synth.SynthSpec(ndoc=cfg["ndocs"], d=cfg["d"], kary=K, levels=M,
                           seed=S["seed"], qlen=cfg["qlen"])
    secs = {}

    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    tab = timed(secs, "make_tables_s", lambda: synth.make_tables(spec))
    draws = timed(secs, "make_draws_s", lambda: synth.make_draws(spec))
    tables = synth.tables_to(tab, dev)
    with tempfile.TemporaryDirectory() as tmp:
        cbs, codes = timed(secs, "fit_rq_codes_s",
                           lambda: synth.fit_rq_codes(
                               spec, tables, draws, cache_base=tmp,
                               fit_sample=S["fit_sample"],
                               iters=S["fit_iters"], device=dev))
    offsets, doc_ids = timed(secs, "csr_s", lambda: build_csr(codes, K))
    semb = timed(secs, "fill_bf16_s", lambda: synth.fill_sorted_matrix(
        spec, tables, draws, doc_ids, n_pad_rows=cap + 8,
        dtype=torch.bfloat16, device=dev))
    emit(phase="6a_corpus", rows=spec.ndoc, d=spec.d,
         buffer_rows=int(semb.shape[0]),
         corpus_gb=semb.numel() * semb.element_size() / 1e9, seconds=secs,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         allocated_gb_before=base_gb,
         cluster_sizes=cluster_stats(offsets, cap))
    rng = np.random.default_rng(seed + 61)
    pick = np.sort(rng.choice(spec.ndoc, S["check_rows"], replace=False))
    pick_d = torch.from_numpy(pick).to(dev)
    sample_docs = doc_ids[pick]
    ref = synth.gen_rows(tables, draws[sample_docs])
    got = semb[pick_d].float()
    want = ref.to(torch.bfloat16).float()
    torch.testing.assert_close(got, ref, rtol=2.0 ** -8, atol=0.0)
    if semb[spec.ndoc:].abs().max() != 0:
        raise AssertionError("6a: pad rows are not zero")
    emit(phase="6a_checks", rows=S["check_rows"],
         max_abs_err_vs_float32_row=float((got - ref).abs().max()),
         elements_not_equal_to_bf16_of_row=int((got != want).sum()),
         pad_rows_zero=True,
         assign=assign_agreement("6a_assign", ref,
                                 torch.from_numpy(cbs).to(dev), None,
                                 torch.from_numpy(codes[sample_docs]).to(
                                     dev)))
    return dict(spec=spec, tab=tab, tables=tables, draws=draws, cbs=cbs,
                codes=codes, offsets=offsets, doc_ids=doc_ids, semb=semb,
                pick=pick, ref=ref, rng=rng), secs


def synth_phase(cfg, seed, dev, qtower, nci, corpus, secs):
    """Phase 6 over the corpus of :func:`synth_corpus`: (b) serve
    512-query batches of its query language through ``BucketServer``
    without and with the PAWA prefix tables, compare their beams (and a
    float32 copy's), hold one pool against the plain bucket version;
    (c) the int8 copy, one batch; (d) the ceilings.  The bf16 fill is
    freed (``corpus["semb"]`` set to None).  Returns the v3 launches:
    (served batches, int8 batch)."""
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.decode.beam import nci_beam_search_incremental
    from mevi_tpu_torch.eval import ceiling
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.index.csr import pack_codes
    from mevi_tpu_torch.serve import BucketServer
    S = SYNTH
    t_phase = time.perf_counter()
    K, M, cap, nb = cfg["kary"], cfg["levels"], cfg["cap"], cfg["beams"]
    Bq, lp = cfg["batch"], cfg["length_penalty"]
    spec, tab, tables, draws = (corpus[k] for k in ("spec", "tab", "tables",
                                                     "draws"))
    codes, offsets, doc_ids = (corpus[k] for k in ("codes", "offsets",
                                                    "doc_ids"))
    semb, ref = corpus["semb"], corpus["ref"]
    corpus["semb"] = None
    pick_d = torch.from_numpy(corpus["pick"]).to(dev)
    rng = corpus["rng"]

    # ---- (b) serve, without and with the PAWA prefix tables -----------
    index = FineIndex(torch.from_numpy(offsets).to(dev),
                      torch.from_numpy(doc_ids).to(dev), semb, M, K,
                      host_offsets=offsets, host_doc_ids=doc_ids)
    kw = dict(num_beams=nb, cap=cap, pool=cfg["pool"], length_penalty=lp,
              device=dev)
    plain = BucketServer(qtower, nci, index, **kw)
    with torch.inference_mode():
        tabs = timed(secs, "pawa_tables_build_s",
                     lambda: nci.pawa_prefix_tables(plain.level_tables))
    leaves = (list(tabs["T"].values()) + [tabs["delta0"]]
              + [x for e in [*tabs["KV"].values(), tabs["e0"]]
                 for kv in e for x in kv])
    tab_bytes = sum(x.numel() * x.element_size() for x in leaves)
    del tabs, leaves
    tab_server = BucketServer(qtower, nci, index, pawa_tables=True, **kw)
    if tab_server.pawa_tables is None:
        raise AssertionError("6b: the PAWA prefix tables were not built")
    mask = torch.ones((Bq, cfg["qlen"]), dtype=torch.int32, device=dev)

    def query_batch():
        gold = rng.integers(0, spec.ndoc, Bq)
        tok = synth.query_tokens(spec, draws[gold], rng)
        return torch.from_numpy(tok).to(dev), gold

    t0 = time.perf_counter()
    batches = [(query_batch()[0], mask, None)
               for _ in range(cfg["warmup"] + cfg["timed"])]
    secs["query_tokens_s"] = time.perf_counter() - t0
    n_plain, _ = run_path("6b_plain_beam", plain, batches, cfg)
    n_tab, _ = run_path("6b_pawa_tables", tab_server, batches, cfg)
    # the two servers in turns on each timed batch (plain, tables,
    # tables, plain): the coarse stage drifts between runs
    turns = {"plain": [], "tables": []}
    outs = []
    for i, m, _ in batches[cfg["warmup"]:]:
        got = {}
        for name, srv in (("plain", plain), ("tables", tab_server),
                          ("tables", tab_server), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = srv.finalize(srv.query_device(i, m))
            turns[name].append((time.perf_counter() - t0) * 1e3)
            got.setdefault(name, o)
        outs.append((got["plain"], got["tables"]))
    med = {k: statistics.median(v) for k, v in turns.items()}
    emit(phase="6b_in_turns", batches=cfg["timed"], runs_each=len(turns[
        "plain"]), query_ms=med, queries_per_s={
        k: Bq / (v * 1e-3) for k, v in med.items()},
        tables_over_plain=med["tables"] / med["plain"],
        query_ms_all=turns)
    profile_path(plain, batches[-2:], "6b_profile_plain")
    profile_path(tab_server, batches[-2:], "6b_profile_tables")
    cp, sp, ct, st = (np.concatenate([o[j][k] for o in outs])
                      for j, k in ((0, 2), (0, 3), (1, 2), (1, 3)))
    diff16 = beams_diff(cp, sp, ct, st)
    # the same beams in float32 (the weights upcast), and each decoder's
    # beams rescored exactly by the float32 panel
    ids0 = batches[cfg["warmup"]][0]
    nci32 = copy.deepcopy(nci).float()
    with torch.inference_mode():
        lt32 = nci32.head_level_tables()
        pt32 = nci32.pawa_prefix_tables(lt32)
        c32p, s32p, _ = nci_beam_search_incremental(
            nci32, ids0, mask, nb, lp, level_tables=lt32)
        c32t, s32t, _ = nci_beam_search_incremental(
            nci32, ids0, mask, nb, lp, level_tables=lt32, pawa_tables=pt32)
    c32p, s32p, c32t, s32t = (x.cpu().numpy() for x in (c32p, s32p, c32t,
                                                        s32t))
    diff32 = beams_diff(c32p, s32p, c32t, s32t)
    err32 = {"tables": float(np.abs(s32t - rescore_f32(
        nci32, ids0, mask, torch.from_numpy(c32t), lp)).max()),
        "plain": float(np.abs(s32p - rescore_f32(
            nci32, ids0, mask, torch.from_numpy(c32p), lp)).max())}
    err16 = {"tables": float(np.abs(st[:Bq] - rescore_f32(
        nci32, ids0, mask, torch.from_numpy(ct[:Bq]), lp)).max()),
        "plain": float(np.abs(sp[:Bq] - rescore_f32(
            nci32, ids0, mask, torch.from_numpy(cp[:Bq]), lp)).max())}
    del nci32, lt32, pt32
    emit(phase="6b_beams", batches=cfg["timed"], bf16_servers=diff16,
         float32_copy=diff32,
         max_err_vs_float32_rescoring={"bf16": err16, "float32": err32},
         pawa_tables_bytes=tab_bytes,
         pawa_tables_build_s=secs["pawa_tables_build_s"],
         query_tokens_s=secs["query_tokens_s"])
    # the gates: in float32 the tables decoder is as close to the exact
    # rescoring as the plain one (2e-5, the CPU parity tolerance) and
    # equal beams score the same; in bf16 its error is within the bf16
    # near-tie scale or within twice the plain decoder's own
    if err32["tables"] > err32["plain"] + S["f32_tol"] or \
            diff32["max_gap_where_equal"] > S["f32_tol"]:
        raise AssertionError(f"6b: float32 tables beams off the plain "
                             f"beams {err32} / {diff32}")
    if err16["tables"] > S["bf16_tie"] and \
            err16["tables"] > 2 * err16["plain"]:
        raise AssertionError(f"6b: the tables server's bf16 scores are off "
                             f"their exact rescoring by {err16}")

    # one batch's pool against the plain bucket version; each query's
    # first bucket is its gold doc's cluster, the others doc-weighted
    cidx_doc = pack_codes(codes, K)
    ids_g, gold = query_batch()
    ov = cidx_doc[rng.integers(0, spec.ndoc, (Bq, nb))]
    ov[:, 0] = cidx_doc[gold]
    ov = torch.from_numpy(ov.reshape(-1)).to(dev)
    ms, out, (cidx, q_rep, ts, tr) = serve_stages(tab_server, ids_g, mask, ov)
    err, n_sep = compare_pools("6b_plain_bucket", (ts, tr),
                               pool_with_plain(tab_server, cidx, q_rep, Bq))
    fill, _ = check_outputs("6b_gold_override", out, cfg, Bq)
    emit(phase="6b_plain_check", **ms, max_abs_pool_err=err,
         ids_compared=n_sep, pool_filled=fill,
         gold_in_pool=float((out[1] == gold[:, None]).any(1).mean()))
    del plain, tab_server, index, semb, cidx, q_rep, ts, tr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) int8: the scale from the true maximum over every row ------
    s_max = timed(secs, "abs_max_pass_s",
                  lambda: synth.rows_abs_max(tables, draws, device=dev))
    q_scale = 126.0 / s_max
    semb8 = timed(secs, "fill_int8_s", lambda: synth.fill_sorted_matrix(
        spec, tables, draws, doc_ids, n_pad_rows=cap + 8, dtype=torch.int8,
        q_scale=q_scale, device=dev))
    d8 = (semb8[pick_d].int() - synth.quantize_rows(ref, q_scale).int()).abs()
    if int(d8.max()) > 1 or semb8[spec.ndoc:].abs().max() != 0:
        raise AssertionError("6c: int8 rows off their quantized rows")
    index8 = FineIndex(torch.from_numpy(offsets).to(dev),
                       torch.from_numpy(doc_ids).to(dev), semb8, M, K,
                       host_offsets=offsets, host_doc_ids=doc_ids)
    server8 = BucketServer(qtower, nci, index8, inv_scale=1.0 / q_scale, **kw)
    server8.finalize(server8.query_device(ids_g, mask, ov))      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ms8, out8, (cidx8, q8, ts8, tr8) = serve_stages(server8, ids_g, mask, ov)
    n8 = read_counts()["v3"]
    if n8 == 0:
        raise AssertionError("6c: the v3 kernel never launched")
    err8, n_sep8 = compare_pools("6c_plain_bucket", (ts8, tr8),
                                 pool_with_plain(server8, cidx8, q8, Bq))
    fill8, _ = check_outputs("6c_int8", out8, cfg, Bq)
    emit(phase="6c_int8", int8_scale=q_scale, abs_max=s_max,
         corpus_gb=semb8.numel() / 1e9,
         seconds={k: secs[k] for k in ("abs_max_pass_s", "fill_int8_s")},
         sample_rows_off_by_one=int((d8 > 0).sum()), **ms8,
         queries_per_s=Bq / (sum(ms8.values()) * 1e-3), v3_launches=n8,
         max_abs_pool_err=err8, ids_compared=n_sep8, pool_filled=fill8,
         top1_agree_with_bf16=float((out8[1][:, 0] == out[1][:, 0]).mean()))
    del server8, index8, semb8, cidx8, q8, ts8, tr8
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the ceilings ----------------------------------------------
    rng_c = np.random.default_rng(seed + 71)
    for drop in (0.0, S["ceiling_dropout"]):
        sp_d = dataclasses.replace(spec, info_dropout=drop)
        gt = rng_c.integers(0, spec.ndoc, S["ceiling_queries"])
        tok = synth.query_tokens(sp_d, draws[gt], rng_c)
        tm = {}
        rep = ceiling.ceiling_report(sp_d, tab, draws, codes, tok, gt,
                                     device=dev, timings=tm)
        total, lower = duplicate_stats(draws, gt, spec.pool_n, K)
        dup = {"queries_with_duplicates": int((total > 1).sum()),
               "max_copies": int(total.max()),
               "recall@1_if_lower_id_first": float((lower == 0).mean())}
        emit(phase="6d_ceiling", info_dropout=drop,
             queries=S["ceiling_queries"], **rep, seconds=tm,
             duplicates=dup)
        if drop == 0.0 and (
                rep["oracle_tower_recall@100"] != 1.0
                or rep["oracle_tower_recall@1"]
                < round(float((total == 1).mean()), 4)):
            raise AssertionError("6d: clean queries miss their documents")
    emit(phase="6_done", seconds=time.perf_counter() - t_phase,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    return n_plain + n_tab, n8

# ---------------------------------------------------------------------------
# phase 7: training through the real entry points, then the trained NCI
# served
# ---------------------------------------------------------------------------

def nci_step_flops(dims, b, lq):
    """Model FLOPs of one NCI training step (forward + backward = 3x the
    forward's matmul FLOPs), counted from the shapes: T5 encoder and
    decoder (cross-attention K/V over the encoder states), PAWA over
    the decode positions (its memory is one vector), the compact head
    and the per-level PAWA weight delta."""
    t5 = dims.t5
    dm, h, dk, dff = t5.d_model, t5.num_heads, t5.d_kv, t5.d_ff
    inner = h * dk
    L, K = dims.max_output_length, dims.kary
    T, Td = b * lq, b * L
    enc = t5.num_layers * (2 * T * dm * inner * 4 + 4 * b * h * lq * lq * dk
                           + 4 * T * dm * dff)
    dec = t5.num_decoder_layers * (
        2 * Td * dm * inner * 4 + 4 * b * h * L * L * dk          # self
        + 2 * Td * dm * inner * 2 + 2 * T * dm * inner * 2        # cross
        + 4 * b * h * L * lq * dk + 4 * Td * dm * dff)
    pw = dims.pawa_dims()
    pd, ph = pw.d_model, pw.num_heads
    pawa = pw.num_layers * (2 * Td * pd * pd * 4 + 4 * b * ph * L * L
                            * (pd // ph) + 2 * Td * pd * pd * 2
                            + 2 * b * pd * pd * 2 + 4 * Td * pd * pw.d_ff)
    head = 2 * Td * dm * (K + 1) * 2 + 2 * Td * dm * dm * (K + 1)
    return 3 * (enc + dec + pawa + head)


def snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def group_updates(model, before, labels):
    """Largest |update| of each optimizer label over one step."""
    from mevi_tpu_torch.weights import flax_names
    names = flax_names(model)
    out = {}
    for n, p in model.named_parameters():
        lab = labels[names[n]]
        d = float((p.detach() - before[n]).abs().max())
        out[lab] = max(out.get(lab, 0.0), d)
    return out


def check_updates(tag, upd, frozen=()):
    for lab, d in upd.items():
        if (lab in frozen or lab == "frozen") and d != 0.0:
            raise AssertionError(f"{tag}: frozen group {lab} moved by {d}")
        if lab not in frozen and lab != "frozen" and not d > 0.0:
            raise AssertionError(f"{tag}: group {lab} did not move")


def coarse_quality(codes, gold_codes):
    """Coarse hit@1/@10 and per-level top-beam prefix accuracy of beam
    codes (B, nb, M) against the gold documents' codes (B, M)."""
    eq = codes == gold_codes[:, None, :]
    full = eq.all(-1)
    pref = np.cumprod(eq[:, 0], axis=1)
    return {"hit@1": float(full[:, 0].mean()),
            "hit@10": float(full.any(1).mean()),
            "top_beam_prefix_acc": [float(x) for x in pref.mean(0)]}


def train_phase(cfg, seed, dev, qtower, corpus, nci_out=None):
    """Phase 7 over phase 6's corpus: (a) the ``train`` command on the
    card (``configs/marco_rq4x5.json`` in bf16 compute, dropout 0.1,
    76,800 queries of the query language, 150 steps at batch 512, the
    1,024-query dev probe); (b) the best tag restored bit for bit; (c)
    the first batch in bf16 compute against float32 on the initial
    weights; (d) a bf16 copy of the trained NCI, and of its initial
    weights, served through ``BucketServer`` over the bf16 fill; (e) one
    twin-tower and one joint step (then its EMA variant) at full width,
    batch 64 with remat.  Returns the v3 launches of (d)'s trained
    server; with ``nci_out``, (d)'s bf16 copy of the trained NCI is saved
    there (its dims and state dict) for phase 9."""
    from mevi_tpu_torch import frozen_eval
    from mevi_tpu_torch.cli.main import _nci_dims, load_config
    from mevi_tpu_torch.cli.main import main as cli_main
    from mevi_tpu_torch.data import io as dio
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.data.datasets import NCIDataset
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.models.nci import NCIT5
    from mevi_tpu_torch.models.t5 import T5Dims, T5Model
    from mevi_tpu_torch.models.twin_tower import Tower
    from mevi_tpu_torch.ops import rq as rq_ops
    from mevi_tpu_torch.ops.rmsnorm import launch_count as rms_count
    from mevi_tpu_torch.serve import BucketServer
    from mevi_tpu_torch.train import joint as J
    from mevi_tpu_torch.train import trainer as T
    from mevi_tpu_torch.train.checkpoints import CheckpointManager
    from mevi_tpu_torch.utils.profiling import (
        H100_SXM_BF16_DENSE_FLOPS)
    from mevi_tpu_torch.weights import flax_names, init_random_
    P7 = TRAIN7
    t_phase = time.perf_counter()
    spec, draws, codes = corpus["spec"], corpus["draws"], corpus["codes"]
    K, M, cap, nb = cfg["kary"], cfg["levels"], cfg["cap"], cfg["beams"]
    Bq, lq = cfg["batch"], cfg["qlen"]
    rng = np.random.default_rng(seed + 81)
    secs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # ---- (a) the train command ------------------------------------
        gold = rng.integers(0, spec.ndoc, P7["train_queries"])
        tok = timed(secs, "query_tokens_s",
                    lambda: synth.query_tokens(spec, draws[gold], rng))
        dio.write_token_memmaps(osp.join(tmp, "q"), tok.astype(np.int64),
                                np.ones_like(tok, np.int64))
        np.save(osp.join(tmp, "codes.npy"), codes[gold])
        dev_gold = rng.integers(0, spec.ndoc, P7["dev_queries"])
        np.save(osp.join(tmp, "dev_q.npy"),
                synth.query_tokens(spec, draws[dev_gold], rng))
        np.save(osp.join(tmp, "dev_codes.npy"), codes[dev_gold])
        with open(P7["config"]) as fr:
            raw = json.load(fr)
        raw["model"].update(dtype="bfloat16", dropout_rate=P7["dropout"])
        raw["ckpt_dir"] = osp.join(tmp, "ckpts")
        cfgp = osp.join(tmp, "config.json")
        with open(cfgp, "w") as fw:
            json.dump(raw, fw)
        mcfg = load_config(cfgp)
        if spec.vocab_size > mcfg.model.vocab_size:
            raise AssertionError("7a: the query language's vocabulary "
                                 "exceeds the model's")
        # Each step is bracketed by CUDA events and its loss kept on the
        # card, read after the run: the command logs at its default
        # interval, so no per-step float() drains the queue.
        rec = dict(events=[], losses=[], entry_steps=[])
        step_ev, step_loss = rec["events"], rec["losses"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        make_step = observe_steps(T, "make_nci_train_step", rec)
        rms0 = rms_count()
        try:
            state = cli_main([
                "train", "--config", cfgp, "--queries", osp.join(tmp, "q"),
                "--query_length", str(lq),
                "--codes", osp.join(tmp, "codes.npy"),
                "--device", str(dev), "--max_epochs", "1",
                "--log_dir", osp.join(tmp, "logs"),
                "--dev_queries", osp.join(tmp, "dev_q.npy"),
                "--dev_codes", osp.join(tmp, "dev_codes.npy")])
        finally:
            T.make_nci_train_step = make_step
        torch.cuda.synchronize()
        secs["train_command_s"] = time.perf_counter() - t0
        # every norm of a step through the kernel, under autograd
        RMS_LAUNCHES["7a_train"] = rms_count() - rms0
        if not RMS_LAUNCHES["7a_train"]:
            raise AssertionError("7a: training launched no RMSNorm kernel")
        peak_train = torch.cuda.max_memory_allocated() / 1e9
        step_ms = np.array([a.elapsed_time(b) for a, b in step_ev])
        window_ms = step_ev[0][0].elapsed_time(step_ev[-1][1])
        losses = torch.stack(step_loss).float().cpu().numpy().tolist()
        if len(step_ev) != P7["steps"] or state.step != P7["steps"]:
            raise AssertionError(f"7a: {len(step_ev)} steps observed, "
                                 f"{state.step} taken")
        if not np.isfinite(losses).all():
            raise AssertionError("7a: a non-finite training loss")
        ckdir = osp.join(tmp, "ckpts", "nci")
        with open(osp.join(ckdir, "leaderboard.json")) as fr:
            board = json.load(fr)
        dims = state.model.dims
        flops = nci_step_flops(dims, mcfg.train.train_batch_size, lq)
        med = float(np.median(step_ms))
        emit(phase="7a_train", steps=state.step,
             batch=mcfg.train.train_batch_size, queries=len(gold),
             step_ms_median=med,
             step_ms_p10_p90=[float(np.percentile(step_ms, 10)),
                              float(np.percentile(step_ms, 90))],
             step_ms_min_max=[float(step_ms.min()), float(step_ms.max())],
             step_ms_window_mean=window_ms / len(step_ev),
             queries_per_s=mcfg.train.train_batch_size / (med * 1e-3),
             model_tflop_per_step=flops / 1e12,
             bf16_dense_peak_share=(flops / (med * 1e-3)
                                    / H100_SXM_BF16_DENSE_FLOPS),
             peak_device_gb=peak_train, card=card_line(),
             rmsnorm_launches=RMS_LAUNCHES["7a_train"],
             loss_first_20=losses[:20], loss_last_20=losses[-20:],
             dev_hit10_leaderboard=board, seconds=secs)

        # ---- (b) the best tag restored bit for bit ---------------------
        ckpts = CheckpointManager.from_dir(ckdir)
        t0 = time.perf_counter()
        restored = ckpts.restore(ckpts.best_tag())
        secs["restore_s"] = time.perf_counter() - t0
        live = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}
        n_tensors = trees_equal("7b", live["model"], restored["model"]) \
            + trees_equal("7b", live["optimizer"], restored["optimizer"])
        emit(phase="7b_checkpoint", tag=ckpts.best_tag(),
             monitor=ckpts.monitor, tensors_bitwise_equal=n_tensors,
             restore_s=secs["restore_s"])
        del restored, live

        # ---- (c) bf16 compute against float32, first batch -------------
        init = init_random_(NCIT5(_nci_dims(mcfg), device=dev),
                            mcfg.train.seed)
        first = next(NCIDataset(tok, np.ones_like(tok),
                                codes[gold].astype(np.int32)).batches(
            mcfg.train.train_batch_size,
            np.random.default_rng(mcfg.train.seed)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        with torch.no_grad():
            l32, _ = T.nci_loss_fn(init, batch, T.NCIStepConfig())
            with T.compute_autocast(dev, torch.bfloat16):
                l16, _ = T.nci_loss_fn(init, batch, T.NCIStepConfig())
        gap = abs(float(l16) - float(l32)) / float(l32)
        emit(phase="7c_bf16_vs_float32", loss_float32=float(l32),
             loss_bf16_compute=float(l16), relative_gap=gap,
             first_train_step_loss_with_dropout=losses[0])
        if not gap <= P7["bf16_gap"]:
            raise AssertionError(f"7c: bf16 loss {float(l16)} is {gap:.4f} "
                                 f"off float32 {float(l32)}")

        # ---- (d) the trained NCI served --------------------------------
        semb = corpus["semb"]
        if semb is None:
            semb = timed(secs, "refill_bf16_s",
                         lambda: synth.fill_sorted_matrix(
                             spec, corpus["tables"], draws,
                             corpus["doc_ids"], n_pad_rows=cap + 8,
                             dtype=torch.bfloat16, device=dev))
        offsets, doc_ids = corpus["offsets"], corpus["doc_ids"]
        index = FineIndex(torch.from_numpy(offsets).to(dev),
                          torch.from_numpy(doc_ids).to(dev), semb, M, K,
                          host_offsets=offsets, host_doc_ids=doc_ids)
        kw = dict(num_beams=nb, cap=cap, pool=cfg["pool"],
                  length_penalty=cfg["length_penalty"], device=dev)
        mask = torch.ones((Bq, lq), dtype=torch.int32, device=dev)
        held = []
        for _ in range(cfg["warmup"] + cfg["timed"]):
            g = rng.integers(0, spec.ndoc, Bq)
            held.append((torch.from_numpy(synth.query_tokens(
                spec, draws[g], rng)).to(dev), g))
        batches = [(i, mask, None) for i, _ in held]
        served = {}
        n_trained = 0
        for name, model in (("trained", state.model), ("initial", init)):
            nci16 = frozen_eval(copy.deepcopy(model).to(torch.bfloat16))
            server = BucketServer(qtower, nci16, index, **kw)
            reset_counts()
            n, _ = run_path(f"7_{name}_serve", server, batches, cfg)
            if name == "trained":
                n_trained = n
                if nci_out:
                    torch.save({"dims": nci16.dims,
                                "state": nci16.state_dict()}, nci_out)
                ms, out, (cidx, q_rep, ts, tr) = serve_stages(
                    server, batches[-1][0], mask, None)
                err, n_sep = compare_pools(
                    "7d_plain_bucket", (ts, tr),
                    pool_with_plain(server, cidx, q_rep, Bq))
                emit(phase="7d_plain_check", **ms, max_abs_pool_err=err,
                     ids_compared=n_sep)
            outs = [server.query(i, mask) for i, _ in held[cfg["warmup"]:]]
            g_all = np.concatenate([g for _, g in held[cfg["warmup"]:]])
            bc = np.concatenate([o[2] for o in outs])
            ids = np.concatenate([o[1] for o in outs])
            served[name] = dict(
                coarse_quality(bc, codes[g_all]),
                pool_filled=float(np.mean([(o[1] >= 0).mean()
                                           for o in outs])),
                gold_in_pool=float((ids == g_all[:, None]).any(1).mean()))
            del server, nci16
        emit(phase="7d_served", batches=cfg["timed"], batch=Bq,
             v3_launches_trained=n_trained, **served)
        del index, semb, init
        corpus["semb"] = None
        state.optimizer = None
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (e) a twin step and a joint step at full width ------------
        n_b, n_neg, ld = P7["twin_batch"], P7["co_neg"], P7["doc_len"]
        g = rng.integers(0, spec.ndoc, n_b)
        q_ids = torch.from_numpy(synth.query_tokens(spec, draws[g], rng)
                                 ).to(dev)
        docs = torch.randint(2, cfg["vocab"], (n_b, 1 + n_neg, ld),
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed + 83), device=dev)
        ones = torch.ones_like
        tdims = T5Dims(vocab_size=cfg["vocab"], d_model=cfg["d"],
                       d_kv=cfg["d_kv"], d_ff=cfg["d_ff"],
                       num_heads=cfg["heads"], num_layers=cfg["enc_layers"],
                       num_decoder_layers=cfg["qdec_layers"],
                       dropout_rate=0.0, remat=True, dtype=torch.bfloat16)
        tower = Tower("t5", init_random_(T5Model(tdims, device=dev),
                                         seed + 5))
        tlabels = T.nci_param_labels(flax_names(tower.module).values())
        topt = T.make_optimizer(mcfg.train, tower.module, total_steps=10)
        tstate = T.init_state(tower.module, topt)
        tstep = T.make_twin_train_step(tower)
        tb = {"query_ids": q_ids, "query_mask": ones(q_ids),
              "doc_ids": docs.reshape(-1, ld),
              "doc_mask": ones(docs.reshape(-1, ld))}
        torch.cuda.reset_peak_memory_stats()
        twin_ms = []
        for _ in range(2):
            before = snapshot(tower.module)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tstate, tm = tstep(tstate, tb)
            co = float(tm["co_loss"])
            twin_ms.append((time.perf_counter() - t0) * 1e3)
        upd = group_updates(tower.module, before, tlabels)
        check_updates("7e_twin", upd)
        if not np.isfinite(co):
            raise AssertionError("7e: non-finite twin loss")
        emit(phase="7e_twin_step", batch=n_b, docs=n_b * (1 + n_neg),
             doc_len=ld, remat=True, step_ms=twin_ms, co_loss=co,
             max_update_by_group=upd,
             peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        del topt, tstate, before

        ndims = _nci_dims(mcfg)
        ndims = dataclasses.replace(
            ndims, t5=dataclasses.replace(ndims.t5, remat=True))
        nci = init_random_(NCIT5(ndims, device=dev), mcfg.train.seed)
        model = J.JointModel(nci, tower,
                             torch.from_numpy(corpus["cbs"]).to(dev))
        paths = flax_names(model).values()
        jb = {"query_ids": q_ids, "query_mask": ones(q_ids),
              "pos_doc_ids": docs[:, 0], "pos_doc_mask": ones(docs[:, 0]),
              "neg_doc_ids": docs[:, 1:], "neg_doc_mask": ones(docs[:, 1:])}
        gen = torch.Generator().manual_seed(seed + 85)
        joint = {}
        torch.cuda.reset_peak_memory_stats()
        # pq_loss 'ce' gives the NCI no gradient (its softmax is the
        # stop-gradient target): the NCI is frozen there, and the EMA
        # variant trains it on the runtime labels ('label')
        for tag, pq_loss, fix in (("joint", "ce", {"fixnci": True}),
                                  ("joint_ema", "label", {"fixpq": True})):
            labels = J.joint_param_labels(paths, **fix)
            opt = T.make_optimizer(mcfg.train, model, total_steps=10,
                                   labels=labels)
            jstate = T.init_state(model, opt)
            jcfg = J.JointStepConfig(pq_loss=pq_loss)
            before = snapshot(model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tag == "joint":
                jstate, jm = J.make_joint_train_step(model, jcfg)(
                    jstate, jb, gen)
            else:
                ema = rq_ops.ema_init(model.codebooks.detach())
                jstate, ema, jm = J.make_joint_train_step_ema(
                    model, jcfg)(jstate, ema, jb, gen)
            jm = {k: float(v) for k, v in jm.items()}
            ms = (time.perf_counter() - t0) * 1e3
            if not np.isfinite(list(jm.values())).all():
                raise AssertionError(f"7e_{tag}: non-finite losses {jm}")
            upd = group_updates(model, before, labels)
            if tag == "joint_ema":
                # the codebooks are frozen to the optimizer and moved by
                # the EMA
                ema_move = float((model.codebooks.detach()
                                  - before["codebooks"]).abs().max())
                upd.pop("frozen")
                if not ema_move > 0.0:
                    raise AssertionError("7e: the EMA left the codebooks")
                upd["codebooks_ema"] = ema_move
            check_updates(f"7e_{tag}", upd)
            joint[tag] = dict(pq_loss=pq_loss, fix=sorted(fix), step_ms=ms,
                              losses=jm, max_update_by_group=upd)
            del opt, jstate, before
        emit(phase="7e_joint_steps", batch=n_b, co_neg=n_neg, doc_len=ld,
             remat=True, **joint,
             peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, nci, tower
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="7_done", seconds=time.perf_counter() - t_phase)
    return n_trained


# ---------------------------------------------------------------------------
# phase 8: the single-card CLI pipeline at full width
# ---------------------------------------------------------------------------

def synth_marco_text(root, P, seed):
    """MS MARCO's raw layouts from the seed: ``corpus.tsv`` (id, title,
    ~32 Zipf words), ``train.query.txt`` / ``dev.query.txt`` (id, words
    of the gold passage) and the qrels; returns the content rows."""
    rng = np.random.default_rng(seed)
    n, nw = P["passages"], P["words"]
    rank = np.arange(1, P["vocab_words"] + 1, dtype=np.float64)
    p = rank ** -P["zipf_a"]
    words = np.array([f"w{i}" for i in range(P["vocab_words"])])
    lens = rng.integers(nw - 8, nw + 9, n)
    draw = words[rng.choice(len(words), (n, nw + 8), p=p / p.sum())]
    titles = words[rng.choice(len(words), (n, 3), p=p / p.sum())]
    content = [" ".join(draw[i, :lens[i]]) for i in range(n)]
    os.makedirs(root, exist_ok=True)
    with open(osp.join(root, "corpus.tsv"), "w") as fw:
        fw.writelines(f"{i}\t{' '.join(titles[i])}\t{content[i]}\n"
                      for i in range(n))
    qid = 0
    for split, nq in (("train", P["train_queries"]),
                      ("dev", P["dev_queries"])):
        gold = rng.integers(0, n, nq)
        pick = rng.integers(0, nw - 8, (nq, P["query_words"]))
        with open(osp.join(root, f"{split}.query.txt"), "w") as fq, \
                open(osp.join(root, f"qrels.{split}.tsv"), "w") as fr:
            for g, cols in zip(gold, pick):
                fq.write(f"{qid}\t{' '.join(draw[g, cols])}\n")
                fr.write(f"{qid}\t0\t{g}\t1\n")
                qid += 1
    return content


@torch.no_grad()
def hf_t5_init_(model, seed):
    """Seeded random weights with the distribution of HF
    ``T5PreTrainedModel._init_weights`` (factor 1): embeddings N(0, 1),
    q N(0, (d * d_kv)^-1/2), k / v / wi N(0, d^-1/2), o N(0, (h *
    d_kv)^-1/2), wo N(0, d_ff^-1/2), the bias table N(0, d^-1/2), norms
    1.  (Lecun-normal q, eight times larger, saturates the unscaled
    attention of a random 24-layer T5, and bf16 then decorrelates.)"""
    d = model.dims
    g = torch.Generator(device=model.shared.weight.device).manual_seed(seed)
    for n, p in model.named_parameters():
        if "norm" in n:
            p.fill_(1.0)
            continue
        std = {"shared.weight": 1.0}.get(n)
        for suffix, v in ((".q.weight", (d.d_model * d.d_kv) ** -0.5),
                          (".o.weight", (d.num_heads * d.d_kv) ** -0.5),
                          (".wo.weight", d.d_ff ** -0.5),
                          (".weight", d.d_model ** -0.5)):
            if std is None and n.endswith(suffix):
                std = v
        p.normal_(0.0, std, generator=g)
    return model


def hf_t5_state_dict(model):
    """The port's ``T5Model`` state dict under HF ``T5Model`` names (no
    ``transformers`` here: the names are spelled out)."""
    out = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "shared":
            out[name] = t
            continue
        side = parts[0]
        if parts[1] == "final_norm":
            out[f"{side}.final_layer_norm.weight"] = t
            continue
        i, sub, rest = parts[2], parts[3], ".".join(parts[4:])
        ff = 2 if side == "decoder" else 1
        head = {"self_attn": "layer.0.SelfAttention",
                "self_norm": "layer.0.layer_norm",
                "cross_attn": "layer.1.EncDecAttention",
                "cross_norm": "layer.1.layer_norm",
                "ff": f"layer.{ff}.DenseReluDense",
                "ff_norm": f"layer.{ff}.layer_norm"}[sub]
        out[f"{side}.block.{i}.{head}.{rest}"] = t
    out["encoder.embed_tokens.weight"] = out["shared.weight"]
    out["decoder.embed_tokens.weight"] = out["shared.weight"]
    return out


def t5_tower_flops(dims, n, L):
    """Forward matmul FLOPs of the T5 tower's embedding of ``n`` rows of
    ``L`` tokens: the encoder, each decoder layer's cross-attention K/V
    over the encoder states, and the one decoder token."""
    dm, inner, dff = dims.d_model, dims.num_heads * dims.d_kv, dims.d_ff
    T = n * L
    enc = dims.num_layers * (2 * T * dm * inner * 4 + 4 * T * L * inner
                             + 4 * T * dm * dff)
    dec = dims.num_decoder_layers * (
        2 * T * dm * inner * 2 + 2 * n * dm * inner * 6 + 4 * n * L * inner
        + 4 * n * dm * dff)
    return enc + dec


def quiet(fn, *a):
    """``fn(*a)`` with its standard output and errors captured; returns
    (result, stdout, stderr)."""
    import contextlib
    import io as _io
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*a)
    return res, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def no_transformers():
    """``import transformers`` fails for the span of the block: this
    machine has no HF tokenizer files, so the CLI's tokenizer falls back
    to the hash stub, here without first importing transformers (7-15 s
    a process on the card's host).  Only that entry of ``sys.modules``
    is touched."""
    missing = object()
    saved = sys.modules.get("transformers", missing)
    sys.modules["transformers"] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules["transformers"]
        else:
            sys.modules["transformers"] = saved


def observe_steps(module, name, record):
    """Patch ``module.name`` (a step factory) so that each step it makes
    is bracketed by CUDA events and keeps its loss on the card and the
    step count it was entered at; returns the original to restore."""
    make = getattr(module, name)

    def observed(*a, **kw):
        inner = make(*a, **kw)

        def step(state, batch, rng=None):
            record["entry_steps"].append(state.step)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, metrics = inner(state, batch, rng)
            ev[1].record()
            record["events"].append(ev)
            record["losses"].append(metrics["loss"])
            return state, metrics
        return step
    setattr(module, name, observed)
    return make


def trie_teacher_scores(model, ids, mask, codes, lengths, lp, chunk=1024):
    """Teacher-forced score of variable-length ids under the NCI panel
    (the forward ``score_sequences`` runs per block, for ids of any
    length): the summed level log-probs, the EOS after the last code,
    normalized by ``(len + 1) ** lp``."""
    K, L = model.dims.kary, model.dims.max_output_length
    out = []
    for s in range(0, len(codes), chunk):
        c = codes[s:s + chunk].long()
        n = lengths[s:s + chunk].long()
        t = torch.arange(c.shape[1], device=c.device)
        toks = torch.zeros((len(c), L), dtype=torch.long, device=c.device)
        toks[:, 1:c.shape[1] + 1] = torch.where(
            t < n[:, None], c.clamp(min=0) + t * K + 2, 0)
        compact, _, _, _ = model(ids[s:s + chunk], mask[s:s + chunk], toks)
        logp = torch.log_softmax(compact.float(), -1)
        cols = torch.where(t < n[:, None], c.clamp(min=0), 0)
        lv = torch.gather(logp[:, :c.shape[1], :K], 2, cols[:, :, None])[..., 0]
        total = (lv * (t < n[:, None])).sum(1) + logp[
            torch.arange(len(c), device=c.device), n, K]
        out.append(total / (n.float() + 1) ** lp)
    return torch.cat(out)


def pipeline_phase(cfg, seed, dev):
    """Phase 8: the single-card CLI pipeline at full width, every
    command in process through ``mevi_tpu_torch.cli.main.main`` with
    ``--device cuda``: (a) ``prepare --doc_aug`` and ``tokenize`` of
    synthetic MS MARCO text, (b) ``gen-embeddings`` with a T5-base
    checkpoint in HF layout, (c) ``build-index``, (d) ``train`` and its
    resume, (e) ``eval`` plain, int8 and host-streamed, (f)
    ``train-joint`` with RQ-refit validation and its resume, (g) the
    trie and brute-force decoders, (h) ``doc2query`` and its repair.
    Returns the v3 launches of each eval / validation path."""
    from mevi_tpu_torch.cli.main import _nci_dims, load_config
    from mevi_tpu_torch.cli.main import main as cli_main
    from mevi_tpu_torch.data import io as dio
    from mevi_tpu_torch.data.prepare import qg_repair
    from mevi_tpu_torch.decode.beam import nci_beam_search_incremental
    from mevi_tpu_torch.decode.brute import brute_force_topk
    from mevi_tpu_torch.decode.generate import _lm_logits, generate
    from mevi_tpu_torch.decode.trie import trie_beam_search
    from mevi_tpu_torch.models import convert
    from mevi_tpu_torch.models.nci import NCIDims, NCIT5
    from mevi_tpu_torch.models.t5 import T5Dims, T5Model
    from mevi_tpu_torch.train import joint as J
    from mevi_tpu_torch.train import trainer as T
    from mevi_tpu_torch.train.checkpoints import (CheckpointManager,
                                                  restore_tree_host)
    from mevi_tpu_torch.utils import native
    from mevi_tpu_torch.utils.profiling import (
        H100_SXM_BF16_DENSE_FLOPS)
    from mevi_tpu_torch.weights import init_random_
    P = PIPE8
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    raw, origin = osp.join(tmp, "raw"), osp.join(tmp, "origin")
    j = lambda *a: osp.join(tmp, *a)          # noqa: E731
    launches = {}
    try:
        # ---- config: marco_rq4x5 with bf16 compute ----------------------
        with open(P["config"]) as fr:
            rawcfg = json.load(fr)
        rawcfg["model"]["dtype"] = "bfloat16"
        rawcfg["encoder"]["dtype"] = "bfloat16"
        rawcfg["ckpt_dir"] = j("ckpts")
        rawcfg["train"]["eval_batch_size"] = P["joint_dev"]
        cfgp = j("config.json")
        with open(cfgp, "w") as fw:
            json.dump(rawcfg, fw)
        mcfg = load_config(cfgp)

        # ---- (a) prepare --doc_aug, tokenize ----------------------------
        secs = {}
        t0 = time.perf_counter()
        content = synth_marco_text(raw, P, seed + 91)
        secs["write_text_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_main(["prepare", "--raw_dir", raw, "--origin_dir", origin,
                  "--doc_aug"])
        secs["prepare_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_main(["tokenize", "--kind", "corpus", "--input",
                  osp.join(raw, "corpus.tsv"), "--output", j("docs"),
                  "--length", str(P["doc_len"]), "--allow_hash_tokenizer"])
        secs["tokenize_corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_main(["tokenize", "--kind", "queries", "--input",
                  osp.join(origin, "train_mevi.tsv"), "--output", j("q"),
                  "--length", str(P["qlen"]), "--allow_hash_tokenizer"])
        secs["tokenize_queries_s"] = time.perf_counter() - t0
        with open(osp.join(origin, "doc_aug.tsv")) as fr:
            n_aug = sum(1 for _ in fr)
        emit(phase="8a_prepare_tokenize", passages=P["passages"],
             train_queries=P["train_queries"], dev_queries=P["dev_queries"],
             doc_aug_rows=n_aug,
             native_library_loaded=native.ensure_built() is not None,
             seconds=secs)

        # ---- (b) gen-embeddings ------------------------------------------
        tdims = T5Dims(vocab_size=cfg["vocab"], d_model=cfg["d"],
                       d_kv=cfg["d_kv"], d_ff=cfg["d_ff"],
                       num_heads=cfg["heads"], num_layers=cfg["enc_layers"],
                       num_decoder_layers=cfg["qdec_layers"],
                       dropout_rate=0.0)
        tower32 = hf_t5_init_(T5Model(tdims, device=dev), seed + 93)
        hf_sd = hf_t5_state_dict(tower32)
        back = convert.convert_t5_model(
            {k: v.cpu() for k, v in hf_sd.items()}, tdims.num_layers,
            tdims.num_decoder_layers)
        if set(back) != set(tower32.state_dict()) or not all(
                torch.equal(v, tower32.state_dict()[k].cpu())
                for k, v in back.items()):
            raise AssertionError("8b: HF names do not convert back")
        torch.save({k: v.cpu() for k, v in hf_sd.items()}, j("t5.pt"))
        del hf_sd, back
        args_b = ["gen-embeddings", "--config", cfgp, "--checkpoint",
                  j("t5.pt"), "--documents", j("docs"), "--doc_length",
                  str(P["doc_len"]), "--output", j("docemb.bin"),
                  "--device", str(dev)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet(cli_main, args_b)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        _, _, prof = quiet(cli_main, args_b + ["--profile"])
        emb = dio.open_embedding_memmap(j("docemb.bin"), cfg["d"])
        flops = t5_tower_flops(tdims, P["passages"], P["doc_len"])
        tok, msk = dio.open_token_memmaps(j("docs"), P["doc_len"])
        n_chk = P["check_rows"]
        with torch.inference_mode():
            ref = torch.cat([tower32.first_token_rep(
                torch.from_numpy(np.asarray(tok[s:e], np.int32)).to(dev),
                torch.from_numpy(np.asarray(msk[s:e], np.int32)).to(dev))
                for s, e in ((s, min(s + 256, n_chk))
                             for s in range(0, n_chk, 256))]).cpu().numpy()
        got = np.asarray(emb[:n_chk])
        rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
        if not (np.isfinite(emb).all() and emb.shape == (P["passages"],
                                                          cfg["d"])):
            raise AssertionError("8b: embeddings not finite / misshapen")
        if not rel.max() <= P["emb_tol"]:
            raise AssertionError(f"8b: bf16 embeddings {rel.max():.4f} off "
                                 f"the float32 recompute (> {P['emb_tol']})")
        emit(phase="8b_gen_embeddings", rows=P["passages"],
             doc_len=P["doc_len"], command_s=gen_s,
             embeddings_per_s=P["passages"] / gen_s,
             model_tflop=flops / 1e12,
             bf16_dense_peak_share=flops / gen_s / H100_SXM_BF16_DENSE_FLOPS,
             profile=[ln.strip() for ln in prof.splitlines()
                      if ln.startswith("bs=")],
             check_rows=n_chk, max_row_rel_l2_err=float(rel.max()),
             mean_row_rel_l2_err=float(rel.mean()),
             max_abs_err=float(np.abs(got - ref).max()), tol=P["emb_tol"],
             card=card_line())

        # ---- (c) build-index ---------------------------------------------
        t0 = time.perf_counter()
        _, hist, _ = quiet(cli_main, [
            "build-index", "--config", cfgp, "--embeddings", j("docemb.bin"),
            "--output_dir", j("index"), "--iters", str(P["rq_iters"]),
            "--device", str(dev)])
        codes = np.load(j("index", "rq_codes.npy"))
        emit(phase="8c_build_index", seconds=time.perf_counter() - t0,
             codes=list(codes.shape), histogram=json.loads(hist))

        # ---- (d) train, then --resume ------------------------------------
        rec = dict(events=[], losses=[], entry_steps=[])
        args_d = ["train", "--config", cfgp, "--queries", j("q"),
                  "--query_length", str(P["qlen"]),
                  "--codes", j("index", "rq_codes.npy"),
                  "--train_tsv", osp.join(origin, "train_mevi.tsv"),
                  "--device", str(dev), "--log_dir", j("logs")]
        make = observe_steps(T, "make_nci_train_step", rec)
        try:
            t0 = time.perf_counter()
            st1, out1, _ = quiet(cli_main, args_d + ["--max_epochs", "1"])
            t1 = time.perf_counter()
            n1 = len(rec["events"])
            st2, out2, _ = quiet(cli_main, args_d + ["--max_epochs", "2",
                                                     "--resume", "best"])
            t2 = time.perf_counter()
        finally:
            T.make_nci_train_step = make
        per_epoch = P["train_queries"] // mcfg.train.train_batch_size
        if not (n1 == per_epoch and st1.step == per_epoch
                and "resumed from epoch 1" in out2
                and rec["entry_steps"][n1] == per_epoch
                and st2.step == 2 * per_epoch):
            raise AssertionError(f"8d: steps {n1}/{st1.step}, resume "
                                 f"entered at {rec['entry_steps'][n1]}, "
                                 f"ended at {st2.step}: {out2!r}")
        step_ms = np.array([a.elapsed_time(b) for a, b in rec["events"]])
        losses = torch.stack(rec["losses"]).float().cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError("8d: a non-finite training loss")
        ck = CheckpointManager.from_dir(j("ckpts", "nci"))
        best = osp.join(ck.directory, ck.best_tag())
        emit(phase="8d_train_resume", steps=[n1, len(step_ms) - n1],
             batch=mcfg.train.train_batch_size,
             step_ms_median=float(np.median(step_ms)),
             step_ms_p10_p90=[float(np.percentile(step_ms, 10)),
                              float(np.percentile(step_ms, 90))],
             epoch_command_s=[t1 - t0, t2 - t1],
             resumed_entry_step=rec["entry_steps"][n1],
             loss_first_last=[float(losses[0]), float(losses[-1])],
             epoch_lines=[ln for ln in (out1 + out2).splitlines()
                          if ln.startswith(("epoch", "resumed"))],
             best_tag=ck.best_tag())
        del st1, st2
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (e) eval: bf16, int8, host-streamed -------------------------
        args_e = ["eval", "--config", cfgp, "--nci_ckpt", best,
                  "--tower_ckpt", j("t5.pt"), "--embeddings", j("docemb.bin"),
                  "--codes", j("index", "rq_codes.npy"),
                  "--dev_tsv", osp.join(origin, "dev_mevi_dedup.tsv"),
                  "--batch_size", str(P["eval_batch"]),
                  "--num_return_sequences", str(cfg["beams"]), "--bf16",
                  "--allow_hash_tokenizer", "--device", str(dev)]
        runs = {}
        for tag, extra in (("8_eval_cli", []),
                           ("8_eval_cli_int8", ["--corpus_int8"]),
                           ("8_eval_host_stream", ["--host_stream"])):
            reset_counts()
            t0 = time.perf_counter()
            res, _, _ = quiet(cli_main, args_e + extra + [
                "--save_path", j(f"res_{tag}.tsv")])
            cmd_s = time.perf_counter() - t0
            launches[tag] = read_counts()["v3"]
            ev_s = sum(t["coarse_ms"] + t["fine_ms"]
                       for t in res["evaluator"].timings) / 1e3
            rep = res["report"]
            runs[tag] = res
            n_dev = len(res["gts"])
            emit(phase=tag, queries=n_dev, command_s=cmd_s,
                 evaluate_q_per_s=n_dev / ev_s,
                 coarse_ms=[t["coarse_ms"] for t in res["evaluator"].timings],
                 fine_ms=[t["fine_ms"] for t in res["evaluator"].timings],
                 v3_launches=launches[tag],
                 coarse={k: {n: rep["coarse"][k].get(n) for n in (1, 10)}
                         for k in ("recall", "mrr")},
                 fine={"recall": {n: rep["fine"]["recall"][n]
                                  for n in (1, 10, 100)},
                       "mrr10": rep["fine"]["mrr"][10]},
                 ndoc_per_query=rep["ndoc_per_query"])
            for part in ("coarse", "fine", "hn"):
                path = j(f"res_{tag}_{part}.tsv")
                with open(path) as fr:
                    n_rows = sum(1 for _ in fr)
                if n_rows != n_dev:
                    raise AssertionError(f"{tag}: {path} has {n_rows} rows")
            preds, _, _ = dio.parse_result_tsv(
                j(f"res_{tag}_fine.tsv"), {"query": 0, "pred": 2})
            if not preds or not all(all(isinstance(d, int) for d in v)
                                    for v in preds.values()):
                raise AssertionError(f"{tag}: the fine tsv reads back wrong")
        plain, hs = runs["8_eval_cli"]["report"], runs["8_eval_host_stream"][
            "report"]
        if hs["coarse"] != plain["coarse"] or \
                hs["fine"]["recall"] != plain["fine"]["recall"]:
            raise AssertionError("8e: host streaming differs from the "
                                 "device reranker")
        if launches["8_eval_cli"] == 0 or launches["8_eval_cli_int8"] == 0:
            raise AssertionError(f"8e: v3 never launched: {launches}")
        # one batch's pool against the plain bucket version
        res = runs["8_eval_cli"]
        ev = res["evaluator"]
        b0 = res["outputs"].results[0]
        B = len(b0.queries)
        with torch.inference_mode():
            qemb = ev.query_rep_fn(
                torch.from_numpy(res["query_ids"][:B]).to(dev),
                torch.from_numpy(res["query_mask"][:B]).to(dev))
        kern = ev._rerank(qemb, b0.beam_codes)
        with plain_v3():
            plain_pool = ev._rerank(qemb, b0.beam_codes)
        err, n_sep = compare_pools(
            "8e_plain_bucket", (torch.from_numpy(kern[0]),
                                torch.from_numpy(kern[1])),
            (torch.from_numpy(plain_pool[0]),
             torch.from_numpy(plain_pool[1])))
        emit(phase="8e_checks", host_stream_equal=True,
             plain_pool_max_abs_err=err, ids_compared=n_sep,
             launches_by_path=dict(launches))
        dev_q, dev_m = res["query_ids"], res["query_mask"]
        del runs, res, ev
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (f) train-joint with RQ-refit validation --------------------
        rows = dio.read_query_docids_tsv(osp.join(origin, "train_mevi.tsv"))
        n_j = P["joint_steps"] * P["joint_batch"]
        dio.write_query_docids_tsv(j("joint_train.tsv"), rows[:n_j])
        dio.write_query_docids_tsv(
            j("joint_dev.tsv"), dio.read_query_docids_tsv(
                osp.join(origin, "dev_mevi_dedup.tsv"))[:P["joint_dev"]])
        rawcfg["train"].update(train_batch_size=P["joint_batch"],
                               co_neg_num=P["co_neg"])
        jcfgp = j("config_joint.json")
        with open(jcfgp, "w") as fw:
            json.dump(rawcfg, fw)
        args_f = ["train-joint", "--config", jcfgp, "--queries", j("q"),
                  "--query_length", str(P["qlen"]),
                  "--train_tsv", j("joint_train.tsv"),
                  "--documents", j("docs"), "--doc_length", str(P["doc_len"]),
                  "--codes", j("index", "rq_codes.npy"),
                  "--codebooks", j("index", "rq_codebooks.npy"),
                  "--tower_ckpt", j("t5.pt"), "--dev_tsv", j("joint_dev.tsv"),
                  "--max_epochs", "1", "--val_every", "1", "--remat",
                  "--allow_hash_tokenizer", "--device", str(dev)]
        jrec = dict(events=[], losses=[], entry_steps=[])
        jmake = observe_steps(J, "make_joint_train_step", jrec)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            tl, out_f, _ = quiet(cli_main, args_f)
            t1 = time.perf_counter()
        finally:
            J.make_joint_train_step = jmake
        launches["8_train_joint_validate"] = read_counts()["v3"]
        jms = np.array([a.elapsed_time(b) for a, b in jrec["events"]])
        jl = torch.stack(jrec["losses"]).float().cpu().numpy()
        if len(jms) != P["joint_steps"] or not np.isfinite(jl).all():
            raise AssertionError(f"8f: {len(jms)} joint steps, losses {jl}")
        if launches["8_train_joint_validate"] == 0 or not tl.last_validation:
            raise AssertionError("8f: the validation never ran v3")
        peak_f = torch.cuda.max_memory_allocated() / 1e9
        tl2, out_r, _ = quiet(cli_main, args_f + ["--resume", "best"])
        if "resumed from epoch 1" not in out_r:
            raise AssertionError(f"8f: resume said {out_r!r}")
        n_eq = trees_equal("8f", tl.state.model.state_dict(),
                           tl2.state.model.state_dict()) + trees_equal(
            "8f", tl.state.optimizer.state_dict(),
            tl2.state.optimizer.state_dict())
        emit(phase="8f_train_joint", steps=len(jms),
             batch=P["joint_batch"], co_neg=P["co_neg"], remat=True,
             step_ms_median=float(np.median(jms)),
             step_ms_min_max=[float(jms.min()), float(jms.max())],
             loss_first_last=[float(jl[0]), float(jl[-1])],
             command_s=t1 - t0, refit=tl.refit_stats,
             validation=tl.last_validation,
             v3_launches=launches["8_train_joint_validate"],
             resume_tensors_bitwise_equal=n_eq, peak_device_gb=peak_f)
        del tl, tl2
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (g) decoding in float32: trie beam, brute force -------------
        sub = np.asarray(emb[:P["trie_rows"]])
        dio.write_embedding_memmap(j("sub.bin"), sub)
        t0 = time.perf_counter()
        _, hier, _ = quiet(cli_main, [
            "build-hier", "--config", cfgp, "--embeddings", j("sub.bin"),
            "--output_dir", j("hier"), "--k", str(P["hier_k"]),
            "--c", str(P["hier_c"]), "--device", str(dev)])
        hier_s = time.perf_counter() - t0
        trie = np.load(j("hier", "hier_trie.npz"))
        max_len = int(np.load(j("hier", "hier_lengths.npy")).max())
        kary_t = max(P["hier_k"], P["hier_c"])
        t5f = dataclasses.replace(tdims, num_decoder_layers=cfg["dec_layers"])
        nci_t = init_random_(NCIT5(NCIDims(
            t5=t5f, kary=kary_t, max_output_length=max_len + 2),
            device=dev), seed + 95)
        nq_t = P["trie_queries"]
        ids_t = torch.from_numpy(dev_q[:nq_t]).to(dev)
        mask_t = torch.from_numpy(dev_m[:nq_t]).to(dev)
        child = torch.from_numpy(trie["child"]).to(dev)
        term = torch.from_numpy(trie["terminal"]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc, tlen, tsc = trie_beam_search(nci_t, ids_t, mask_t, child, term,
                                         num_beams=cfg["beams"],
                                         max_steps=max_len + 1, device=dev)
        torch.cuda.synchronize()
        trie_s = time.perf_counter() - t0
        live = tsc > -1e8
        ch, tm = trie["child"], trie["terminal"]
        for c_row, n_row in zip(tc[live].cpu().numpy(),
                                tlen[live].cpu().numpy()):
            node = 0
            for c in c_row[:n_row]:
                node = ch[node, c]
                if node < 0:
                    raise AssertionError("8g: a returned id leaves the trie")
            if not tm[node] or (c_row[n_row:] != -1).any():
                raise AssertionError("8g: a returned id is not a document")
        nb = cfg["beams"]
        with torch.inference_mode():
            ref_t = trie_teacher_scores(
                nci_t, ids_t.repeat_interleave(nb, 0),
                mask_t.repeat_interleave(nb, 0), tc.reshape(nq_t * nb, -1),
                tlen.reshape(-1), cfg["length_penalty"]).reshape(nq_t, nb)
        trie_err = float((ref_t - tsc)[live].abs().max())
        if not trie_err <= P["decode_tol"]:
            raise AssertionError(f"8g: trie scores {trie_err} off the "
                                 "teacher-forced scores")
        del nci_t
        # brute force over all 32^4 sequences of the trained NCI
        nci_b = NCIT5(_nci_dims(mcfg), device=dev)
        nci_b.load_state_dict(restore_tree_host(best)["model"])
        q1 = ids_t[:1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bc, bs = brute_force_topk(nci_b, q1, mask_t[:1], k=cfg["beams"],
                                  length_penalty=cfg["length_penalty"],
                                  batch=P["brute_block"], device=dev)
        torch.cuda.synchronize()
        brute_s = time.perf_counter() - t0
        ic, isc, _ = nci_beam_search_incremental(
            nci_b, q1, mask_t[:1], cfg["beams"], cfg["length_penalty"])
        ic, isc = ic.cpu().numpy()[0], isc.cpu().numpy()[0]
        if not bs[0, 0] >= isc[0] - P["decode_tol"]:
            raise AssertionError(f"8g: brute top-1 {bs[0, 0]} below the "
                                 f"beam's {isc[0]}")
        agree_n, agree_err = 0, 0.0
        brute = {tuple(c): v for c, v in zip(map(tuple, bc[0]), bs[0])}
        for c, v in zip(map(tuple, ic), isc):
            if c in brute:
                agree_n += 1
                agree_err = max(agree_err, abs(float(brute[c]) - float(v)))
        if agree_err > P["decode_tol"]:
            raise AssertionError(f"8g: equal codes score {agree_err} apart")
        emit(phase="8g_decoding", build_hier_s=hier_s,
             hier=json.loads(hier), trie_queries=nq_t, beams=nb,
             trie_kary=kary_t, trie_max_steps=max_len + 1,
             trie_s=trie_s, trie_live_ids=int(live.sum()),
             trie_max_score_err=trie_err,
             brute_sequences=int(cfg["kary"] ** cfg["levels"]),
             brute_s=brute_s, brute_block=P["brute_block"],
             brute_top1=float(bs[0, 0]),
             beam_top1=float(isc[0]), codes_in_both_top10=agree_n,
             max_err_where_codes_agree=agree_err, tol=P["decode_tol"])
        del nci_b

        # ---- (h) doc2query, greedy check, repair ---------------------------
        with open(osp.join(raw, "corpus.tsv")) as fr, \
                open(j("corpus_d2q.tsv"), "w") as fw:
            for _, line in zip(range(P["d2q_passages"]), fr):
                fw.write(line)
        args_h = ["doc2query", "--checkpoint", j("t5.pt"),
                  "--corpus", j("corpus_d2q.tsv"),
                  "--n_gen_query", str(P["d2q_n"]),
                  "--query_max_len", str(P["d2q_qlen"]),
                  "--doc_max_len", str(P["doc_len"]),
                  "--batch", str(P["d2q_batch"]), "--seed", str(seed),
                  "--num_layers", str(tdims.num_layers),
                  "--d_model", str(tdims.d_model), "--d_kv", str(tdims.d_kv),
                  "--d_ff", str(tdims.d_ff),
                  "--num_heads", str(tdims.num_heads),
                  "--allow_hash_tokenizer", "--device", str(dev)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows_h, _, _ = quiet(cli_main, args_h + ["--output", j("qg.tsv")])
        torch.cuda.synchronize()
        d2q_s = time.perf_counter() - t0
        if len(rows_h) != P["d2q_passages"] * P["d2q_n"]:
            raise AssertionError(f"8h: {len(rows_h)} generated rows")
        # greedy: each emitted token is the argmax of the full decoder
        # panel re-run over the generated prefix (float32)
        from mevi_tpu_torch.data.tokenize import HashTokenizer
        enc = HashTokenizer()([content[i] for i in range(P["greedy_rows"])],
                              max_length=P["doc_len"])
        gi = torch.from_numpy(enc["input_ids"]).to(dev)
        gm = torch.from_numpy(enc["attention_mask"]).to(dev)
        with torch.inference_mode():
            out_g = generate(tower32, gi, gm, max_length=P["d2q_qlen"],
                             do_sample=False, device=dev)
            prefix = torch.cat([torch.zeros_like(out_g[:, :1]),
                                out_g[:, :-1]], 1)
            h = tower32.decode(prefix, tower32.encode(gi, gm), gm)
            arg = _lm_logits(tower32, h).argmax(-1)
        done = (torch.cumsum((out_g == 1).int(), 1) - (out_g == 1).int()) > 0
        mism = int(((arg != out_g) & ~done).sum())
        if mism:
            raise AssertionError(f"8h: {mism} greedy tokens are not the "
                                 "panel's argmax")
        # one repair round over a copy with blanked and duplicated rows
        qg = [ln.rstrip("\n").split("\t") for ln in open(j("qg.tsv"))]
        broken = P["repair_docs"]
        for i in range(broken):
            qg[i * P["d2q_n"]][0] = " "
            qg[i * P["d2q_n"] + 1][0] = qg[i * P["d2q_n"] + 2][0]
        with open(j("qg_broken.tsv"), "w") as fw:
            fw.writelines(f"{q}\t{d}\n" for q, d in qg)
        # the docs the repair must regenerate: the broken ones and any
        # whose sampled queries came out empty or repeated
        _, need = qg_repair([(q, int(d)) for q, d in qg], P["d2q_n"])
        t0 = time.perf_counter()
        fixed, out_rep, err_rep = quiet(cli_main, args_h + [
            "--output", j("qg_fixed.tsv"), "--repair", j("qg_broken.tsv"),
            "--repair_rounds", "1"])
        rep_s = time.perf_counter() - t0
        per_doc = {}
        for q, d in fixed:
            per_doc.setdefault(int(d), []).append(q)
        short = sum(len(v) < P["d2q_n"] for v in per_doc.values())
        if f"repair round 0: {len(need)} docs need" not in err_rep or \
                short or len(need) < broken:
            raise AssertionError(f"8h: repair said {err_rep!r} {out_rep!r}, "
                                 f"{short} docs short")
        n_tok = P["d2q_passages"] * P["d2q_n"] * P["d2q_qlen"]
        emit(phase="8h_doc2query", passages=P["d2q_passages"],
             per_passage=P["d2q_n"], query_max_len=P["d2q_qlen"],
             batch=P["d2q_batch"], command_s=d2q_s,
             passages_per_s=P["d2q_passages"] / d2q_s,
             tokens_per_s=n_tok / d2q_s, greedy_rows=P["greedy_rows"],
             greedy_argmax_mismatches=mism, repair_docs=broken,
             repair_regenerated_docs=len(need),
             repair_s=rep_s, repaired_rows=len(fixed))
        del tower32
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="8_done", seconds=time.perf_counter() - t_phase,
         launches_by_path=launches)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the multi-device path, four ranks sharing the card
# ---------------------------------------------------------------------------

# 2 x 2 mesh (data x corpus) of four ranks on cuda:0 over gloo; 9d: two
# data ranks at batch 64 each in float32, the twin step with one
# negative a query (7e's seven cut for the two float32 towers' memory)
SHARD9 = dict(data=2, corpus=2, oracle_atol=1e-3, dp_batch=64, co_neg=1,
              doc_len=128)


def load_nci(dev, nci_path):
    """Phase 7's trained NCI in bf16, from the state dict it saved."""
    from mevi_tpu_torch.models.nci import NCIT5
    saved = torch.load(nci_path, map_location=dev, weights_only=False)
    nci = NCIT5(saved["dims"], device=dev, dtype=torch.bfloat16)
    nci.load_state_dict(saved["state"])
    return nci


def rank_models(dev, nci_path, cfg, seed):
    """A rank's models: the query tower from the seed (phase 2's) and
    phase 7's trained NCI."""
    return build_qtower(cfg, dev, seed), load_nci(dev, nci_path)


def weights_checksum(*modules):
    """(sum, sum of squares) of every parameter in float64."""
    ps = [p.detach().double() for m in modules for p in m.parameters()]
    return torch.stack([sum(p.sum() for p in ps),
                        sum(p.square().sum() for p in ps)])


def card_memory_used_mib():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sharded_serve_rank(dev, semb, offsets, doc_ids, nci_path, cfg, seed,
                       batches):
    """One rank of 9a or 9b: a 2 x 2 mesh, the same weights on every rank
    (checksums gathered over both axes), this rank's clone of its shard
    of ``semb``, then ``ShardedBucketServer`` over the batches (its data
    slice of each), stages synchronized and timed; its v3 launches
    counted from 0.  Returns stage ms, launches, pool fill, peak memory
    and the last batch's slice (query reps, codes, pool)."""
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.ops import bucket as B
    from mevi_tpu_torch.parallel import mesh as PM
    from mevi_tpu_torch.serve import ShardedBucketServer, gather_batch
    t0 = time.perf_counter()
    mesh = PM.make_mesh(SHARD9["data"], SHARD9["corpus"], device=dev)
    qtower, nci = rank_models(dev, nci_path, cfg, seed)
    torch.cuda.synchronize(dev)
    setup_s = {"mesh_and_models_s": time.perf_counter() - t0}
    ck = weights_checksum(qtower, nci)
    for ax in PM.AXES:
        if not all(torch.equal(ck, c)
                   for c in PM.all_gather_list(ck, mesh, ax)):
            raise AssertionError(f"9: ranks of one {ax} group hold "
                                 "different weights")
    n = len(doc_ids)
    index_kw = dict(offsets=offsets.to(dev), doc_ids=doc_ids.to(dev),
                    levels=cfg["levels"], kary=cfg["kary"])
    torch.cuda.reset_peak_memory_stats(dev)
    shard = PM.shard_rows(semb[:n], mesh)        # the rank's own copy
    server = ShardedBucketServer(
        qtower, nci, mesh, FineIndex(sorted_emb=shard, **index_kw),
        num_beams=cfg["beams"], cap=cfg["cap"], pool=cfg["pool"],
        length_penalty=cfg["length_penalty"])
    torch.cuda.synchronize(dev)
    setup_s["shard_and_server_s"] = time.perf_counter() - t0 - sum(
        setup_s.values())
    PM.all_gather_list(ck, mesh, PM.DATA_AXIS)   # every shard is in
    PM.all_gather_list(ck, mesh, PM.CORPUS_AXIS)
    used = card_memory_used_mib() if mesh.rank == 0 else None
    launches0 = B.launch_counts()["v3"]
    stage, fill = [], []
    for i, ids_h in enumerate(batches):
        ids = PM.data_slice(ids_h, mesh).to(dev)
        mask = torch.ones_like(ids)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        qemb, codes, bsc = server.coarse(ids, mask)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        scores, dids = server.fine(qemb, codes)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        for t in gather_batch((scores, dids, codes, bsc), mesh):
            t.cpu()                                  # the host's batch
        t3 = time.perf_counter()
        if i < cfg["warmup"]:
            setup_s[f"warmup_batch_{i}_s"] = t3 - t0
        else:
            stage.append({"coarse_ms": (t1 - t0) * 1e3,
                          "fine_ms": (t2 - t1) * 1e3,
                          "gather_ms": (t3 - t2) * 1e3,
                          "query_ms": (t3 - t0) * 1e3})
            fill.append(float((dids >= 0).float().mean()))
    return dict(
        rank=mesh.rank, coords=mesh.coords, setup_s=setup_s,
        launches=B.launch_counts()["v3"] - launches0, stage_ms=stage,
        pool_filled=float(np.mean(fill)), card_used_mib=used,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        shard_rows=int(shard.shape[0]),
        shard_gb=shard.numel() * shard.element_size() / 1e9,
        qemb=qemb.float().cpu().numpy(), codes=codes.cpu().numpy(),
        scores=scores.cpu().numpy(), ids=dids.cpu().numpy())


def nccl_serve_rank(dev, semb16, offsets, doc_ids, nci_path, cfg, seed,
                    ids_h):
    """9c: one batch through ``ShardedBucketServer`` on a 1 x 1 mesh of
    a one-rank NCCL world (its collectives run through NCCL)."""
    import torch.distributed as dist
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.ops import bucket as B
    from mevi_tpu_torch.parallel import mesh as PM
    from mevi_tpu_torch.serve import ShardedBucketServer, gather_batch
    mesh = PM.make_mesh(1, 1, device=dev)
    backends = {ax: dist.get_backend(mesh.group(ax)) for ax in PM.AXES}
    qtower, nci = rank_models(dev, nci_path, cfg, seed)
    index = FineIndex(offsets.to(dev), doc_ids.to(dev),
                      PM.shard_rows(semb16[:len(doc_ids)], mesh),
                      cfg["levels"], cfg["kary"])
    server = ShardedBucketServer(qtower, nci, mesh, index,
                                 num_beams=cfg["beams"], cap=cfg["cap"],
                                 pool=cfg["pool"],
                                 length_penalty=cfg["length_penalty"])
    ids = ids_h.to(dev)
    launches0 = B.launch_counts()["v3"]
    qemb, codes, _ = server.coarse(ids, torch.ones_like(ids))
    scores, dids, _ = gather_batch((*server.fine(qemb, codes), codes), mesh)
    return dict(backends=backends,
                launches=B.launch_counts()["v3"] - launches0,
                qemb=qemb.float().cpu().numpy(), codes=codes.cpu().numpy(),
                scores=scores.cpu().numpy(), ids=dids.cpu().numpy())


def oracle_pool(semb, offsets_d, doc_ids_d, qemb, codes, cfg, dev):
    """The single-device pool of given query reps and beam codes: the
    plain PyTorch version of v3 (``align=1``, ``_beam_scores``'s window)
    over the unsharded matrix, then ``merge_pool``."""
    from mevi_tpu_torch.eval.searcher import merge_pool
    from mevi_tpu_torch.index.csr import pack_codes
    from mevi_tpu_torch.ops.bucket import bucket_scores_v3_plain
    B, nb, M = codes.shape
    cap = cfg["cap"]
    ci = pack_codes(torch.from_numpy(codes).to(dev).reshape(-1, M),
                    cfg["kary"]).long()
    s = offsets_d.long()[ci]
    e = torch.minimum(offsets_d.long()[ci + 1], s + cap)
    q = torch.from_numpy(qemb).to(dev, torch.bfloat16)
    scores, rows = bucket_scores_v3_plain(
        semb, s, e, q.repeat_interleave(nb, 0), cap, align=1)
    rows = rows.long()
    ids = torch.where(rows >= 0, doc_ids_d.long()[rows.clamp(min=0)],
                      torch.full_like(rows, -1))
    return merge_pool(scores.reshape(B, -1), ids.reshape(B, -1), nb, cap,
                      cfg["pool"])


def dp_models(cfg, seed, dev):
    """9d's float32 models at full width: the NCI of
    ``configs/marco_rq4x5.json`` and the 12 + 12 T5 tower (remat), random
    from the seed, dropout off."""
    from mevi_tpu_torch.cli.main import _nci_dims, load_config
    from mevi_tpu_torch.models.nci import NCIT5
    from mevi_tpu_torch.models.t5 import T5Dims, T5Model
    from mevi_tpu_torch.models.twin_tower import Tower
    from mevi_tpu_torch.weights import init_random_
    mcfg = load_config(TRAIN7["config"])
    nd = _nci_dims(mcfg)
    nd = dataclasses.replace(nd, t5=dataclasses.replace(
        nd.t5, dropout_rate=0.0, dtype=torch.float32))
    tdims = T5Dims(num_decoder_layers=cfg["qdec_layers"], dropout_rate=0.0,
                   remat=True, **t5_widths(cfg))
    yield "nci", init_random_(NCIT5(nd, device=dev), seed + 93), mcfg
    yield "twin", Tower("t5", init_random_(T5Model(tdims, device=dev),
                                           seed + 95)), mcfg


class InParts(torch.nn.Module):
    """``model`` run on each of ``parts`` row blocks of its inputs in
    turn, the outputs concatenated: one process's forward (and so
    backward) with the per-row layout of a ``parts``-rank data-parallel
    step; autograd sums the blocks' gradients."""

    def __init__(self, model, parts):
        super().__init__()
        self.model, self.parts, self.dims = model, parts, model.dims

    def forward(self, *xs):
        outs = [self.model(*b) for b in zip(*(x.chunk(self.parts)
                                               for x in xs))]
        return tuple(None if o[0] is None else torch.cat(o)
                     for o in zip(*outs))


def dp_step(kind, model, mcfg, batch, mesh=None, parts=1):
    """One float32 step of ``kind`` (the NCI step, or the twin step,
    whose negatives are the global batch's on a mesh); ``parts`` > 1:
    in one process, in the row layout of ``parts`` ranks
    (:class:`InParts`).  Returns (loss, flat parameters, flat Adam first
    moments)."""
    import types
    from mevi_tpu_torch.train import trainer as T
    module = model if kind == "nci" else model.module
    opt = T.make_optimizer(mcfg.train, module, total_steps=10)
    state = T.init_state(module, opt)
    if kind == "nci":
        step = T.make_nci_train_step(
            InParts(model, parts) if parts > 1 else model, mesh=mesh)
    else:
        tower = model if parts == 1 else types.SimpleNamespace(
            module=model.module, rep=lambda ids, mask: torch.cat([
                model.rep(i, m) for i, m in zip(ids.chunk(parts),
                                                mask.chunk(parts))]))
        step = T.make_twin_train_step(tower, mesh=mesh)
    state, m = step(state, batch)
    loss = float(m["loss"] if "loss" in m else m["co_loss"])
    ps = [p for p in module.parameters() if p in opt.inner.state]
    flat_p = torch.cat([p.detach().reshape(-1) for p in ps])
    flat_m = torch.cat([opt.inner.state[p]["exp_avg"].reshape(-1)
                        for p in ps])
    return loss, flat_p, flat_m


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def bit_hash(flat):
    """Two position-weighted sums of the float32 bits (equal bits, equal
    hash), in chunks."""
    h = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for s in range(0, flat.numel(), 1 << 24):
        v = flat[s:s + (1 << 24)].view(torch.int32).long()
        i = torch.arange(s, s + v.numel(), device=flat.device)
        h += torch.stack([(v * (i % 65521 + 1)).sum(),
                          (v * (i % 65519 + 7)).sum()])
    return h.tolist()


def dp_train_rank(dev, cfg, seed, batches, refs):
    """9d: one data-parallel step of each kind in a 2 x 1 mesh; the
    parameters and Adam's first moments against the single-process step
    in the ranks' row layout (``refs``, flat tensors shared from the
    parent)."""
    from mevi_tpu_torch.parallel import mesh as PM
    mesh = PM.make_mesh(2, 1, device=dev)
    out = {}
    for kind, model, mcfg in dp_models(cfg, seed, dev):
        local = {k: PM.data_slice(v.to(dev), mesh)
                 for k, v in batches[kind].items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, flat_p, flat_m = dp_step(kind, model, mcfg, local, mesh)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        ref_p, ref_m = refs[kind]
        dp = (flat_p - ref_p).abs()
        buf = flat_p.clone()             # the gradient all-reduce's size
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        PM.all_reduce_sum_([buf], mesh)
        torch.cuda.synchronize(dev)
        out[kind] = dict(
            loss=loss, step_ms=ms,
            all_reduce_ms=(time.perf_counter() - t0) * 1e3,
            hash=bit_hash(flat_p),
            params=flat_p.numel(), max_abs_param_diff=float(dp.max()),
            params_off_by_over_1e6th=int((dp > 1e-6).sum()),
            moment_rel_l2=rel_l2(flat_m, ref_m),
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del model, flat_p, flat_m, local, buf
        torch.cuda.empty_cache()
    return out


def sharded_phase(cfg, seed, dev, corpus, nci_path):
    """Phase 9: the multi-device path in ranks that share the card
    (``parallel.mesh.launch_local`` on cuda:0 over gloo).  (a) the
    sharded server over phase 6's bf16 fill with phase 7's trained NCI,
    four ranks in a 2 x 2 mesh, each serving its 256-query slice of
    batches of 512 over its own 4.4M-row shard, pools held against the
    single-device oracle, beams against a single-rank beam; (b) the same
    over the int8 fill; (c) one slice through a 1 x 1 mesh over NCCL;
    (d) one data-parallel NCI and twin step in two ranks at batch 64
    each in float32 against the single-process step on the 128 rows in
    the ranks' row layout, within 4 times that step's distance from
    itself with the halves swapped.  Returns
    the v3 launches summed over ranks: (9a, 9b, 9c)."""
    from mevi_tpu_torch.data import synth
    from mevi_tpu_torch.decode.beam import nci_beam_search_incremental
    from mevi_tpu_torch.parallel.mesh import launch_local
    S9 = SHARD9
    t_phase = time.perf_counter()
    spec, draws = corpus["spec"], corpus["draws"]
    offsets, doc_ids = corpus["offsets"], corpus["doc_ids"]
    # the ranks' host arguments as tensors, which reach them through
    # shared memory
    offsets_t, doc_ids_t = (torch.from_numpy(x) for x in (offsets, doc_ids))
    Bq, cap = cfg["batch"], cfg["cap"]
    secs = {}
    rng = np.random.default_rng(seed + 91)
    batches = torch.from_numpy(np.stack([synth.query_tokens(
        spec, draws[rng.integers(0, spec.ndoc, Bq)], rng).astype(np.int32)
        for _ in range(cfg["warmup"] + cfg["timed"])]))
    nci = load_nci(dev, nci_path)
    with torch.inference_mode():
        tables = nci.head_level_tables()
    off_d, ids_d = offsets_t.to(dev), doc_ids_t.to(dev)
    half = Bq // S9["data"]
    # the single-rank beam of each data slice of the last batch
    beams = []
    for d in range(S9["data"]):
        ids = batches[-1][d * half:(d + 1) * half].to(dev)
        with torch.inference_mode():
            beams.append(nci_beam_search_incremental(
                nci, ids, torch.ones_like(ids), cfg["beams"],
                cfg["length_penalty"], level_tables=tables)[0].cpu().numpy())
    del nci, tables
    counts = {}

    def serve(tag, semb):
        """One four-rank launch over ``semb``; the ranks' pools against
        the oracle, their beams against the single-rank beams."""
        t0 = time.perf_counter()
        res = launch_local(sharded_serve_rank, S9["data"] * S9["corpus"],
                           "gloo", "cuda:0", semb, offsets_t, doc_ids_t,
                           nci_path, cfg, seed, batches)
        secs[f"ranks_{tag}_s"] = time.perf_counter() - t0
        errs, n_sep = [], 0
        for r in res:
            d, c = r["coords"]
            twin = res[d * S9["corpus"] + (1 - c)]    # its corpus group
            np.testing.assert_array_equal(r["ids"], twin["ids"])
            np.testing.assert_array_equal(r["codes"], beams[d],
                                          err_msg=f"{tag}: rank beam")
            if c:
                continue
            with torch.inference_mode():
                ref = oracle_pool(semb, off_d, ids_d, r["qemb"], r["codes"],
                                  cfg, dev)
            e, n = compare_pools(f"{tag}_oracle", (
                torch.from_numpy(r["scores"]), torch.from_numpy(r["ids"])),
                ref, S9["oracle_atol"])
            errs.append(e)
            n_sep += n
        counts[tag] = [r["launches"] for r in res]
        if min(counts[tag]) == 0:
            raise AssertionError(f"{tag}: a rank never launched v3")
        med = {k: [statistics.median(m[k] for m in r["stage_ms"])
                   for r in res] for k in res[0]["stage_ms"][0]}
        emit(phase=tag, ranks=len(res), mesh=[S9["data"], S9["corpus"]],
             batches=cfg["timed"], batch=Bq, rank_batch=half,
             v3_launches_by_rank=counts[tag],
             stage_ms_median_by_rank=med,
             queries_per_s_per_data_rank=[half / (q * 1e-3)
                                          for q in med["query_ms"]],
             note="four ranks sharing one card's SMs, not a multi-card "
                  "throughput",
             pool_filled=[r["pool_filled"] for r in res],
             max_abs_pool_err_vs_oracle=max(errs), ids_compared=n_sep,
             shard_rows=res[0]["shard_rows"], shard_gb=res[0]["shard_gb"],
             peak_gb_by_rank=[r["peak_gb"] for r in res],
             card_used_mib=res[0]["card_used_mib"],
             parent_allocated_gb=torch.cuda.memory_allocated() / 1e9,
             launch_s=secs[f"ranks_{tag}_s"],
             rank0_setup_s=res[0]["setup_s"], card=card_line())
        return res[0]

    # ---- (a) bf16, then (c) NCCL at world 1 over the same matrix --------
    alloc0 = torch.cuda.memory_allocated()
    semb = timed(secs, "fill_bf16_s", lambda: synth.fill_sorted_matrix(
        spec, corpus["tables"], draws, doc_ids, n_pad_rows=cap + 8,
        dtype=torch.bfloat16, device=dev))
    r0 = serve("9a_bf16", semb)
    t0 = time.perf_counter()
    rc = launch_local(nccl_serve_rank, 1, "nccl", "cuda:0", semb, offsets_t,
                      doc_ids_t, nci_path, cfg, seed, batches[-1][:half])[0]
    secs["rank_9c_s"] = time.perf_counter() - t0
    if set(rc["backends"].values()) != {"nccl"} or rc["launches"] == 0:
        raise AssertionError(f"9c: {rc['backends']}, {rc['launches']} "
                             "launches")
    np.testing.assert_array_equal(rc["codes"], r0["codes"],
                                  err_msg="9c: beam differs from 9a's")
    with torch.inference_mode():
        ref = oracle_pool(semb, off_d, ids_d, rc["qemb"], rc["codes"], cfg,
                          dev)
    e9c, n9c = compare_pools("9c_oracle", (torch.from_numpy(rc["scores"]),
                                           torch.from_numpy(rc["ids"])),
                             ref, S9["oracle_atol"])
    emit(phase="9c_nccl", backends=rc["backends"], v3_launches=rc["launches"],
         max_abs_pool_err_vs_oracle=e9c, ids_compared=n9c,
         launch_s=secs["rank_9c_s"])
    fill_gb = semb.numel() * semb.element_size() / 1e9
    del semb, ref
    gc.collect()
    torch.cuda.empty_cache()
    # the parent's fill, shared with the ranks through CUDA IPC, is freed
    # once they have exited and it is dropped here
    gap = (torch.cuda.memory_allocated() - alloc0) / 1e9
    emit(phase="9_ipc_release", fill_gb=fill_gb,
         allocated_before_fill_gb=alloc0 / 1e9, gap_after_free_gb=gap)
    if gap >= 1.0:
        raise AssertionError(f"9: {gap:.2f} GB of the shared fill stayed "
                             "allocated after the ranks exited")

    # ---- (b) the int8 fill (phase 6c's quantization) ---------------------
    q_scale = 126.0 / synth.rows_abs_max(corpus["tables"], draws,
                                         device=dev)
    semb = timed(secs, "fill_int8_s", lambda: synth.fill_sorted_matrix(
        spec, corpus["tables"], draws, doc_ids, n_pad_rows=cap + 8,
        dtype=torch.int8, q_scale=q_scale, device=dev))
    serve("9b_int8", semb)
    del semb
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) data-parallel steps at full width --------------------------
    nb = 2 * S9["dp_batch"]
    g = rng.integers(0, spec.ndoc, nb)
    q = synth.query_tokens(spec, draws[g], rng).astype(np.int32)
    docs = rng.integers(2, cfg["vocab"], (nb * (1 + S9["co_neg"]),
                                          S9["doc_len"])).astype(np.int32)
    dp_batches = {
        "nci": {"query_ids": q, "query_mask": np.ones_like(q),
                "codes": corpus["codes"][g].astype(np.int32)},
        "twin": {"query_ids": q, "query_mask": np.ones_like(q),
                 "doc_ids": docs, "doc_mask": np.ones_like(docs)}}
    # the single-process step on the 128 rows in the ranks' row layout
    # (each 64-row half's forward in turn); then the same with the
    # batch's halves swapped, which changes only the order of float32
    # sums: the rounding the data-parallel step may differ by
    swapped = {kind: {k: np.concatenate(np.split(v, 2)[::-1])
                      for k, v in b.items()} for kind, b in dp_batches.items()}
    refs, single = {}, {}
    for layout in ("halves", "swapped"):
        for kind, model, mcfg in dp_models(cfg, seed, dev):
            b = dp_batches if layout == "halves" else swapped
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in b[kind].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, flat_p, flat_m = dp_step(kind, model, mcfg, batch, parts=2)
            torch.cuda.synchronize()
            if layout == "halves":
                single[kind] = dict(loss=loss, step_ms=(
                    time.perf_counter() - t0) * 1e3)
                refs[kind] = (flat_p, flat_m)
            else:
                ref_p, ref_m = refs[kind]
                single[kind]["swapped_halves"] = dict(
                    loss=loss, moment_rel_l2=rel_l2(flat_m, ref_m),
                    max_abs_param_diff=float((flat_p - ref_p).abs().max()))
            del model, batch, flat_p, flat_m
            gc.collect()
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rd = launch_local(dp_train_rank, 2, "gloo", "cuda:0", cfg, seed,
                      {kind: {k: torch.from_numpy(v) for k, v in b.items()}
                       for kind, b in dp_batches.items()}, refs)
    secs["ranks_9d_s"] = time.perf_counter() - t0
    lr = max(mcfg.train.learning_rate, mcfg.train.decoder_learning_rate,
             mcfg.train.docenc_learning_rate)
    eps32 = float(np.finfo(np.float32).eps)
    for kind in ("nci", "twin"):
        a, b = rd[0][kind], rd[1][kind]
        if a["hash"] != b["hash"]:
            raise AssertionError(f"9d_{kind}: the ranks' parameters differ")
        tol = 4 * max(single[kind]["swapped_halves"]["moment_rel_l2"], eps32)
        for r in (a, b):
            # the gradients, through Adam's first moments, within a few
            # times the rounding of their sum; parameters to 2 lr only as
            # a smoke check (Adam's first update is lr g / (|g| + eps),
            # whose sign a rounding-level gradient may flip)
            if not (r["moment_rel_l2"] <= tol
                    and r["max_abs_param_diff"] <= 2 * lr * (1 + 1e-3)
                    and abs(r["loss"] - single[kind]["loss"])
                    <= 1e-4 * abs(single[kind]["loss"])):
                raise AssertionError(f"9d_{kind}: {r} vs {single[kind]} "
                                     f"(moment tolerance {tol})")
        emit(phase=f"9d_{kind}_step", ranks=2, rank_batch=S9["dp_batch"],
             dtype="float32", single_process_in_halves=single[kind],
             by_rank=[{k: v for k, v in r.items() if k != "hash"}
                      for r in (a, b)], bitwise_equal_across_ranks=True,
             lr=lr, moment_tolerance=tol,
             co_neg=S9["co_neg"] if kind == "twin" else None,
             launch_s=secs["ranks_9d_s"])
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="9_done", seconds=time.perf_counter() - t_phase,
         part_seconds=secs)
    return (sum(counts["9a_bf16"]), sum(counts["9b_int8"]), rc["launches"])


def trees_equal(tag, a, b):
    """Bitwise equality of two (nested) state dicts; returns the number
    of tensors compared."""
    if isinstance(a, torch.Tensor):
        if not (a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"{tag}: a restored tensor differs")
        return 1
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{tag}: restored keys differ")
        return sum(trees_equal(tag, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{tag}: restored lengths differ")
        return sum(trees_equal(tag, x, y) for x, y in zip(a, b))
    if a != b:
        raise AssertionError(f"{tag}: restored {b!r} != live {a!r}")
    return 0



# ---------------------------------------------------------------------------
# phase 10: the measuring scripts (quality_full, bench, int8_tax)
# ---------------------------------------------------------------------------

# 10a's cuts, of depth only (the model, tower and RQ widths are the
# JAX script's full ones): 153,600 documents of 1,000,000, one utterance
# a document of 4 and one epoch of 8 (300 steps at batch 512), 800
# tower steps of 24,000 (the tower's dev exact-MIPS
# recall@100 reaches ~0.05, against 0.002 after 200), 512 dev queries of
# 2,048
QUAL10 = dict(QF_NDOC="153600", QF_UTT="1", QF_EPOCHS="1", QF_BATCH="512",
              QF_NDEV="512", QF_EVAL_BATCH="256", QF_TOWER_STEPS="800",
              QF_TOWER_SCAN="8", QF_TOWER_PROBE="200")
# 10c / 10d: the largest |int8 - bf16| of the trained fine recall@100, 10
# of 512 queries: int8 rounding moves a score by ~4e-4 (an error of up to
# half of 1/688 an element against a query of norm ~1), so a true
# document near rank 100 may cross a neighbour
FINE_TAX_TOL = 0.02
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "ndoc", "batch", "cap",
              "pipeline", "corpus_dtype", "rpc_floor_ms", "cluster_sizes",
              "kernel_matches_oracle", "recall100_beam_coarse",
              "recall100_oracle_coarse", "oracle_cluster_coverage",
              "cold_start_s", "ndoc_per_query", "sequential_qps",
              "baseline_qps_measured", "baseline_def", "latency_b8_ms",
              "stages", "bucket_launches")
TRAINED_KEYS = ("trained_coarse_hit@1", "trained_coarse_hit@10",
                "trained_fine_recall@100", "trained_fine_mrr@10",
                "trained_fine_recall@100_beam_major",
                "trained_fine_mrr@10_beam_major", "trained_ndoc_per_query")
STAGE_KEYS = ("qenc_ms", "beam_ms", "bucket_ms", "rpc_floor_ms",
              "qenc_device_ms", "beam_device_ms", "qenc_mfu_pct",
              "beam_mfu_pct")


def check_bench_line(tag, line, trained, on_card=True):
    """Checks a bench line (every key of the JAX line, finite positive
    rates, recalls under their coverage bound, an upper bound before the
    cap), then prints it on a line of its own."""
    want = BENCH_KEYS + (TRAINED_KEYS if trained else ())
    if line["corpus_dtype"] == "int8":
        want += ("int8_scale",)
    if not on_card:
        want = tuple(k for k in want if k != "kernel_matches_oracle")
    missing = [k for k in want if k not in line]
    missing += [f"stages.{k}" for k in STAGE_KEYS
                if on_card and k not in line["stages"]]
    if missing:
        raise AssertionError(f"{tag}: the line lacks {missing}")
    if on_card and line["kernel_matches_oracle"] is not True:
        raise AssertionError(f"{tag}: kernel check")
    for k in ("value", "baseline_qps_measured", "sequential_qps",
              "latency_b8_ms"):
        if not (np.isfinite(line[k]) and line[k] > 0):
            raise AssertionError(f"{tag}: {k} = {line[k]}")
    cov = line["oracle_cluster_coverage"]
    for k in ("recall100_beam_coarse", "recall100_oracle_coarse"):
        if line[k] > cov + 1e-9:
            raise AssertionError(f"{tag}: {k} {line[k]} above the coverage "
                                 f"bound {cov}")
    print(json.dumps(line), flush=True)


def served_coarse_hits(workdir):
    """Coarse hit@1 / hit@10 recomputed from ``served_eval.npz`` by a
    per-query loop: the first beam whose code tuple is the dev
    document's."""
    with np.load(osp.join(workdir, "served_eval.npz")) as z:
        beams, docs = z["beam_codes"], z["dev_docs"]
    codes = np.load(osp.join(workdir, "codes.npy"))
    h1 = h10 = 0
    for i, d in enumerate(docs.tolist()):
        want = tuple(codes[d].tolist())
        rank = next((j for j, c in enumerate(beams[i].tolist())
                     if tuple(c) == want), None)
        h1 += rank == 0
        h10 += rank is not None
    return round(h1 / len(docs), 4), round(h10 / len(docs), 4)


def quality_phase(dev, workdir, knobs=QUAL10):
    """10a: ``scripts.quality_full``'s stages data, train, tower and eval,
    each through its entry point (``main``, ``QF_STAGE`` set) at full
    width, cut in depth by ``knobs``.  Gate: the QUALITY json's coarse
    hits equal a plain recomputation from ``served_eval.npz``.  Returns
    eval's v3 launches and the seconds of each stage."""
    from mevi_tpu_torch import synchronize
    from mevi_tpu_torch.scripts import quality_full as qf
    secs = {}
    out = None
    for stage in qf.STAGES:
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, {"QF_STAGE": stage,
                                          "QF_WORKDIR": workdir, **knobs}):
            for k in ("QF_OUT", "QF_TINY", "QF_RESUME", "QF_TOWER_RESUME"):
                os.environ.pop(k, None)
            out = qf.main(["--device", str(dev)])
        synchronize(dev)
        secs[f"{stage}_s"] = time.perf_counter() - t0
        n = read_counts()
        if stage != "eval" and sum(n.values()):
            raise AssertionError(f"10a: stage {stage} launched {n}")
    n_eval = n["v3"]
    if n_eval == 0:
        raise AssertionError("10a: eval never launched v3")
    hits = served_coarse_hits(workdir)
    if hits != (out["coarse_hit@1"], out["coarse_hit@10"]):
        raise AssertionError(f"10a: QUALITY coarse hits "
                             f"{(out['coarse_hit@1'], out['coarse_hit@10'])}"
                             f" != recomputed {hits}")
    with open(osp.join(workdir, "ckpts", "nci", "leaderboard.json")) as fr:
        board = json.load(fr)
    with open(osp.join(workdir, "tower_probe.jsonl")) as fr:
        probes = [json.loads(x) for x in fr]
    emit(phase="10a_quality", knobs=knobs, seconds=secs, v3_launches=n_eval,
         nci_board=board, tower_probes=probes,
         coarse_hits_recomputed=hits,
         quality={k: v for k, v in out.items()
                  if k not in ("nci_ckpt", "tower_ckpt")})
    return n_eval, secs


def bench_phase(cfg, dev, ndoc=None):
    """10b: ``mevi_tpu_torch.bench``'s random-weight pipeline, bf16, over
    ``ndoc`` (default all) rows; its line, then one timed batch's pool
    against the pool with the bucket stage recomputed by the plain v3.
    Returns the v3 launches of the served path."""
    from mevi_tpu_torch import bench
    keep, extras = {}, {}
    reset_counts()
    qps, base = bench.run(ndoc or cfg["ndocs"], extras, device=dev,
                          keep=keep)
    n = read_counts()
    line = bench.result_line(qps, base, extras)
    check_bench_line("10b", line, trained=False, on_card=dev.type == "cuda")
    # the wrapper's count holds the kernel check's one launch besides the
    # served path's, which the line counts
    served = line["bucket_launches"]["v3"]
    if served == 0 or n["v3"] != served + (dev.type == "cuda"):
        raise AssertionError(f"10b: launches {n}, line "
                             f"{line['bucket_launches']}")
    server = keep.pop("server")
    ids, mask, ov = keep.pop("batches")[-1]
    B = ids.shape[0]
    _, _, _, q_rep = server.coarse(ids, mask)
    kern = server.pool_topk(*server.bucket(ov, q_rep)[:2], B)
    err, n_sep = compare_pools("10b_plain", kern,
                               pool_with_plain(server, ov, q_rep, B))
    emit(phase="10b_plain_check", max_abs_pool_err=err, ids_compared=n_sep)
    return served


def tax_phase(cfg, dev, workdir, ndoc=None, extra=(), tag="10c",
              fine_signal=False):
    """10c / 10d: ``scripts.int8_tax`` over 10a's bundle (the trained
    pipeline) at ``ndoc`` (default all) rows, bf16 then int8, each bench
    run a process of its own.  Gates: the trained coarse keys equal
    between the two (the corpus dtype does not enter the coarse stage),
    the trained fine recall@100 within ``FINE_TAX_TOL``, and with
    ``fine_signal`` above 0 in both.  Returns the v3 launches of the bf16
    and of the int8 run."""
    from mevi_tpu_torch.scripts import int8_tax
    t0 = time.perf_counter()
    art, lines = int8_tax.run(ndoc or cfg["ndocs"], str(dev), ckpt=workdir,
                              extra=extra)
    for dt, line in lines.items():
        check_bench_line(f"{tag}_{dt}", line, trained=True,
                         on_card=dev.type == "cuda")
    for k in ("trained_coarse_hit@1", "trained_coarse_hit@10"):
        if lines["bf16"][k] != lines["int8"][k]:
            raise AssertionError(f"{tag}: {k} bf16 {lines['bf16'][k]} != "
                                 f"int8 {lines['int8'][k]}")
    fine = {dt: line["trained_fine_recall@100"] for dt, line in lines.items()}
    if abs(fine["int8"] - fine["bf16"]) > FINE_TAX_TOL or \
            (fine_signal and min(fine.values()) <= 0):
        raise AssertionError(f"{tag}: trained fine recall@100 {fine}")
    n = {dt: line["bucket_launches"]["v3"] for dt, line in lines.items()}
    if not all(n.values()):
        raise AssertionError(f"{tag}: v3 launches {n}")
    emit(phase=f"{tag}_int8_tax", seconds=time.perf_counter() - t0,
         artifact=art)
    return n["bf16"], n["int8"]


def scripts_phase(cfg, dev, workdir):
    """Phase 10 (10a, 10b, 10c, 10d); the bundle is written to
    ``workdir``, which phase 11 reads and the caller removes.  Returns
    the v3 launches by path."""
    from mevi_tpu_torch.data import synth
    t_phase = time.perf_counter()
    n_a, _ = quality_phase(dev, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_b = bench_phase(cfg, dev)
    emit(phase="10b_seconds", seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    n_c, n_c8 = tax_phase(cfg, dev, workdir)
    # the bundle's own corpus, whose leaves the cap truncates far less
    # than 8,841,823 rows': the trained fine keys carry a signal there
    ndoc_own = synth.load_spec(osp.join(workdir, "spec.json")).ndoc
    n_d, n_d8 = tax_phase(cfg, dev, workdir, ndoc=ndoc_own,
                          extra=("--nbatch", "5"), tag="10d",
                          fine_signal=True)
    emit(phase="10_total", seconds=time.perf_counter() - t_phase)
    return ({"10a_quality_eval": n_a, "10b_bench_random": n_b,
             "10c_bench_trained": n_c, "10d_bench_trained_own": n_d},
            {"10c_bench_trained_int8": n_c8,
             "10d_bench_trained_own_int8": n_d8})


# ---------------------------------------------------------------------------
# phase 11: the rest of the scripts (sharded parity, ceiling, scaling,
# NQ scale, the quality demo, the coarse-stage profilers)
# ---------------------------------------------------------------------------

# the time limit's cuts, of depth only: 11c: the ends of the JAX curve's
# four sizes (all four until phase 12 needed the room: 107.5-135.5 s),
# int8, each a bench process with 2 timed batches of its 20; 11d: the
# true NQ rows at d 768, not cut; 11e: 100 DEMO_STEPS of 4,000 (300
# until phase 12)
SCALE11 = dict(sizes=(1_000_000, 8_841_823),
               dtype="int8", nbatch=2, timeout=900)
NQ11 = dict(ndoc=21_015_324, d=768, plain_atol=1e-3, timeout=900)
DEMO11 = dict(steps=100)


def sharded_stage_phase(dev, workdir):
    """11a: ``quality_full``'s ``sharded`` stage over 10a's bundle at full
    width (float32 NCI and tower, the v3 kernel over a float32 corpus at
    ``align=1`` in eight spawned ranks).  Gates: beam codes
    equal, the canonical metrics equal, top-100 overlap above 0.99, v3
    launched.  Returns the ranks' v3 launches."""
    from mevi_tpu_torch.scripts import quality_full as qf
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"QF_STAGE": "sharded",
                                      "QF_WORKDIR": workdir}):
        for k in ("QF_OUT", "QF_TINY", "QF_SHARD_DUMP"):
            os.environ.pop(k, None)
        out = qf.main(["--device", str(dev)])
    if out["beam_codes_equal"] is not True or out["sharded"] != \
            out["single"] or not out["top100_overlap"] > 0.99:
        raise AssertionError(f"11a: parity {out}")
    if out["bucket_launches"] == 0:
        raise AssertionError("11a: the ranks never launched v3")
    emit(phase="11a_sharded_parity", seconds=time.perf_counter() - t0, **out)
    return out["bucket_launches"]


def ceiling_phase(dev, workdir):
    """11b: ``data_ceiling`` over 10a's bundle (its dev set)."""
    from mevi_tpu_torch.scripts import data_ceiling
    t0 = time.perf_counter()
    rep = data_ceiling.report(workdir, device=dev)
    for k in ("bayes_recall@100", "oracle_tower_recall@100"):
        if not 0.0 <= rep[k] <= 1.0:
            raise AssertionError(f"11b: {k} = {rep[k]}")
    emit(phase="11b_data_ceiling", seconds=time.perf_counter() - t0, **rep)


def scaling_phase(cfg, dev, workdir):
    """11c: ``scaling_curve`` over 10a's bundle at ``SCALE11``'s sizes,
    int8, one bench process a size.  Gates: every row holds ``KEEP``,
    each bench line passes ``check_bench_line`` (recalls under their
    coverage bound).  Returns the v3 launches by size."""
    from mevi_tpu_torch.scripts import scaling_curve as sc
    t0 = time.perf_counter()
    side = osp.join(workdir, "scaling_stages")
    curve, lines = sc.run(SCALE11["sizes"], SCALE11["dtype"], str(dev),
                          ckpt=workdir, side_dir=side,
                          timeout=SCALE11["timeout"],
                          extra=("--nbatch", str(SCALE11["nbatch"])))
    for row in curve["curve"]:
        missing = [k for k in sc.KEEP if k not in row]
        if missing:
            raise AssertionError(f"11c: row {row.get('ndoc')} lacks "
                                 f"{missing}")
    n = {}
    for tag, line in lines.items():
        check_bench_line(f"11c_{tag}", line, trained=True,
                         on_card=dev.type == "cuda")
        n[f"11c_scaling_{line['ndoc']}_int8"] = line["bucket_launches"]["v3"]
    if not len(curve["curve"]) == len(n) == len(SCALE11["sizes"]) or \
            not all(n.values()):
        raise AssertionError(f"11c: v3 launches {n}")
    emit(phase="11c_scaling_curve", seconds=time.perf_counter() - t0,
         curve=curve)
    return n


def nq_phase(dev):
    """11d: ``nq_scale_demo`` at 21,015,324 rows and d 768: the mesh stage
    in a process of its own (ranks sharing the card), then stream and
    adc in this one.  Gates: the mesh pool within 1e-3 of the plain v3 over the
    same rows, the rows and width, v3 launched.  Returns the mesh
    stage's v3 launches."""
    from mevi_tpu_torch.scripts import nq_scale_demo as nq
    from mevi_tpu_torch.scripts.int8_tax import PACKAGE_ROOT
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_nq_")
    env = dict(os.environ, NQ_NDOC=str(NQ11["ndoc"]), NQ_MESH_D=str(NQ11["d"]),
               NQ_D=str(NQ11["d"]), NQ_STAGE_DIR=work,
               NQ_OUT=osp.join(work, "nq.json"))
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        r = subprocess.run(
            [sys.executable, "-m", "mevi_tpu_torch.scripts.nq_scale_demo",
             "--device", str(dev)], env=dict(env, NQ_STAGE="mesh"),
            stdout=subprocess.PIPE, timeout=NQ11["timeout"])
        if r.returncode != 0:
            raise AssertionError(f"11d: mesh stage rc={r.returncode}")
        mesh_s = time.perf_counter() - t0
        with mock.patch.dict(os.environ, {k: env[k] for k in (
                "NQ_NDOC", "NQ_MESH_D", "NQ_D")}):
            for k in ("NQ_ADC_TAG", "NQ_ADC_LEVELS", "NQ_ADC_KARY"):
                os.environ.pop(k, None)
            out = nq.run_stages(["stream", "adc"], dev, work,
                                osp.join(work, "nq.json"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if out["mesh_pool_max_abs_err_vs_plain"] > NQ11["plain_atol"]:
        raise AssertionError(f"11d: pool vs plain "
                             f"{out['mesh_pool_max_abs_err_vs_plain']}")
    for k in ("mesh_server_rows", "mesh_mips_rows", "stream_rows",
              "adc_rows"):
        if out[k] != NQ11["ndoc"]:
            raise AssertionError(f"11d: {k} = {out[k]}")
    if out["mesh_d"] != NQ11["d"] or out["mesh_v3_launches"] == 0:
        raise AssertionError(f"11d: mesh d {out['mesh_d']}, launches "
                             f"{out['mesh_v3_launches']}")
    emit(phase="11d_nq_scale", seconds=time.perf_counter() - t0,
         mesh_process_s=mesh_s, **out)
    return out["mesh_v3_launches"]


def demo_phase(dev):
    """11e: ``quality_demo`` at its device widths, ``DEMO_STEPS`` cut.
    Gates: finite losses, the loss down, hits in [0, 1]."""
    from mevi_tpu_torch.scripts import quality_demo
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"DEMO_STEPS": str(DEMO11["steps"])}):
        for k in ("DEMO_NDOC", "DEMO_NTRAIN"):
            os.environ.pop(k, None)
        out = quality_demo.run(dev)
    if not (np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
            and out["loss_last"] < out["loss_first"]):
        raise AssertionError(f"11e: losses {out}")
    for k in ("coarse_hit@1", "coarse_hit@10", "fine_recall@10"):
        if not 0.0 <= out[k] <= 1.0:
            raise AssertionError(f"11e: {k} = {out[k]}")
    emit(phase="11e_quality_demo", seconds=time.perf_counter() - t0,
         steps_cut_from=4000, **out)


def profilers_phase(dev):
    """11f: the coarse stage's instruments at the serving shapes:
    ``profile_beam`` (with the traced breakdown), ``profile_step``,
    ``beam_trace`` and ``trace_beam_only``.  Gates: every stage timed,
    the beam's FLOPs and device time positive, the category breakdown
    summing to the device time."""
    from mevi_tpu_torch.scripts import (beam_trace, profile_beam,
                                        profile_step, trace_beam_only)
    t0 = time.perf_counter()
    pb = profile_beam.profile(dev, trace=True)
    emit(phase="11f_profile_beam", **pb)
    gc.collect()
    torch.cuda.empty_cache()
    ps = profile_step.profile(dev)
    emit(phase="11f_profile_step", **ps)
    gc.collect()
    torch.cuda.empty_cache()
    bt = beam_trace.trace(dev)
    cats = sum(bt["trace_breakdown_ms"].values())
    if not (bt["beam_gflops"] > 0 and bt["beam_device_ms"] > 0
            and abs(cats - bt["beam_device_ms"]) < 1e-6 * max(cats, 1.0)):
        raise AssertionError(f"11f: beam_trace {bt}")
    emit(phase="11f_beam_trace", **bt)
    gc.collect()
    torch.cuda.empty_cache()
    tb = trace_beam_only.run(dev)
    emit(phase="11f_trace_beam_only", **tb)
    for name, row in pb["stages"].items():
        if not (row["seq_ms"] > 0 and row["pipe_ms"] > 0):
            raise AssertionError(f"11f: profile_beam {name} {row}")
    emit(phase="11f_seconds", seconds=time.perf_counter() - t0)


def rest_phase(cfg, dev, workdir):
    """Phase 11 (11a-11f) over 10a's bundle in ``workdir``.  Returns the
    v3 launches of the float32 path (11a) and of the int8 paths (11c,
    11d)."""
    t_phase = time.perf_counter()
    n_a = sharded_stage_phase(dev, workdir)
    ceiling_phase(dev, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    n_c = scaling_phase(cfg, dev, workdir)
    n_d = nq_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    demo_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    profilers_phase(dev)
    emit(phase="11_total", seconds=time.perf_counter() - t_phase)
    return ({"11a_sharded_parity_f32": n_a},
            {**n_c, "11d_nq_mesh_int8": n_d})


# ---------------------------------------------------------------------------
# phase 12: the NQ-DPR configuration
# ---------------------------------------------------------------------------

# 12a: NQ's raw layouts cut in scale to phase 8's 65,536 passages (of
# 21,015,324) and 16,384 training items (of nq-train's 58,880), with all
# 3,610 of nq-test's questions; one training epoch (the config's 120)
NQ12 = dict(config="configs/nqdpr_rq4x5.json", passages=65_536, words=100,
            vocab_words=30_000, zipf_a=1.1, title_words=3, common_words=5,
            train_items=16_384, test_questions=3_610, question_words=8,
            check_rows=1_024, emb_tol=2e-2, pool_batch=512, plain_atol=1e-3,
            timeout=900)
# 12b: NQ's corpus size, its leaves as phase 5's (305,777 of 32^4 at
# 8,841,823 rows, scaled to the rows), one answering passage a query
# planted at a drawn rank of the plain pool
NQ12B = dict(ndoc=21_015_324, nonempty=726_790, sigma=1.9, noise=0.1,
             plant_ranks=150, batch=512, plain_atol=1e-3, kernel_reps=10)
NQ_SCRIPT = "mevi_tpu_torch/scripts/nqdpr_pipeline.sh"
HF_BERT_LAYER = {"attn.query": "attention.self.query",
                 "attn.key": "attention.self.key",
                 "attn.value": "attention.self.value",
                 "attn.out": "attention.output.dense",
                 "attn.norm": "attention.output.LayerNorm",
                 "ff_intermediate": "intermediate.dense",
                 "ff_out": "output.dense", "ff_norm": "output.LayerNorm"}
HF_BERT_EMB = {"word": "word_embeddings", "position": "position_embeddings",
               "token_type": "token_type_embeddings", "norm": "LayerNorm"}


def synth_nq_raw(root, P, seed):
    """NQ's three raw files in DPR's published layouts, from the seed:
    ``psgs_w100.tsv`` (header ``id text title``, 1-based ids, ~100 Zipf
    words a passage), ``biencoder-nq-train.json`` (question: words of its
    gold passage; answers; its positive context with ``passage_id``,
    title and text; the negative lists, which the port reads no more
    than the reference does, empty) and
    ``nq-test.qa.csv`` (question, tab, a Python list literal of its
    answer: a 2-3 word span of its gold passage, which any passage
    holding the span also answers).  Returns the test questions' gold
    passages (0-based)."""
    rng = np.random.default_rng(seed)
    n, nw = P["passages"], P["words"]
    rank = np.arange(1, P["vocab_words"] + 1, dtype=np.float64)
    p = rank ** -P["zipf_a"]
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(P["vocab_words"])])
    lens = rng.integers(nw - 10, nw + 11, n)
    idx = rng.choice(len(words), (n, nw + 10), p=p)
    draw = words[idx]
    titles = [" ".join(t) for t in
              words[rng.choice(len(words), (n, P["title_words"]), p=p)]]
    texts = [" ".join(draw[i, :lens[i]]) for i in range(n)]
    os.makedirs(root, exist_ok=True)
    with open(osp.join(root, "psgs_w100.tsv"), "w") as fw:
        fw.write("id\ttext\ttitle\n")
        fw.writelines(f"{i + 1}\t{texts[i]}\t{titles[i]}\n"
                      for i in range(n))

    def question(g):
        pos = np.sort(rng.choice(lens[g], P["question_words"],
                                 replace=False))
        return " ".join(draw[g, pos])

    def answer(g):
        # NQ's answers are names and numbers, not function words: the
        # span holds none of the ``common_words`` most frequent words
        m = int(rng.integers(2, 4))
        ok = np.nonzero(np.lib.stride_tricks.sliding_window_view(
            idx[g, :lens[g]], m).min(1) >= P["common_words"])[0]
        s = int(ok[rng.integers(0, len(ok))]) if len(ok) else 0
        return " ".join(draw[g, s:s + m])

    def ctx(i):
        return {"title": titles[i], "text": texts[i], "score": 0,
                "title_score": 0, "passage_id": str(i + 1)}
    gold = rng.integers(0, n, P["train_items"])
    items = [{"dataset": "nq_train_psgs_w100", "question": question(g),
              "answers": [answer(g)], "positive_ctxs": [ctx(g)],
              "negative_ctxs": [], "hard_negative_ctxs": []}
             for g in gold]
    with open(osp.join(root, "biencoder-nq-train.json"), "w") as fw:
        json.dump(items, fw)
    test = rng.integers(0, n, P["test_questions"])
    with open(osp.join(root, "nq-test.qa.csv"), "w") as fw:
        fw.writelines(f"{question(g)}\t{[answer(g)]!r}\n" for g in test)
    return test


@torch.no_grad()
def hf_bert_init_(model, seed):
    """Seeded random weights with the distribution of HF
    ``BertPreTrainedModel._init_weights`` (initializer range 0.02):
    linear and embedding weights N(0, 0.02^2), the word table's padding
    row (id 0) zero, biases 0, LayerNorm weights 1 and biases 0."""
    g = torch.Generator(device=model.embeddings.word.weight.device)
    g.manual_seed(seed)
    for n, p in model.named_parameters():
        if n.split(".")[-2].endswith("norm"):
            p.fill_(1.0 if n.endswith("weight") else 0.0)
        elif n.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=g)
    model.embeddings.word.weight[0].zero_()
    return model


def hf_bert_state_dict(model, seed):
    """The port's ``BertEncoderModel`` state dict under HF ``BertModel``
    names (no ``transformers`` here: the names are spelled out), with a
    seeded pooler, which AR2's towers carry and the CLS twin tower does
    not read."""
    out = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "embeddings":
            out[f"embeddings.{HF_BERT_EMB[parts[1]]}.{parts[2]}"] = t
        else:
            sub = HF_BERT_LAYER[".".join(parts[2:-1])]
            out[f"encoder.layer.{parts[1]}.{sub}.{parts[-1]}"] = t
    w = model.embeddings.word.weight
    g = torch.Generator(device=w.device).manual_seed(seed)
    d = model.dims.d_model
    out["pooler.dense.weight"] = torch.randn(
        (d, d), generator=g, device=w.device) * 0.02
    out["pooler.dense.bias"] = torch.zeros(d, device=w.device)
    return out


def bert_tower_flops(dims, n, L):
    """Forward matmul FLOPs of the BERT tower over ``n`` rows of ``L``
    tokens: Q, K, V and output projections, scores and context, the
    feed-forward pair."""
    d, T = dims.d_model, n * L
    return dims.num_layers * (8 * T * d * d + 4 * T * L * d
                              + 4 * T * d * dims.d_ff)


@contextlib.contextmanager
def plain_v3():
    """``eval.searcher``'s bucket stage through the plain PyTorch version
    of v3 (no kernel launched) for the span of the block, in float32
    whatever autocast the caller runs under (the kernel accumulates in
    float32)."""
    from mevi_tpu_torch.eval import searcher
    from mevi_tpu_torch.ops.bucket import bucket_scores_v3_plain

    def plain(semb, s, e, q, cap, align, device=None, host_check=True):
        with torch.autocast(semb.device.type, enabled=False):
            return bucket_scores_v3_plain(semb, s, e, q, cap, align)
    with mock.patch.object(searcher, "bucket_scores_v3", plain):
        yield


def rank_metrics(ranks, ks):
    """Recall, MRR and hit rate at each k of one answer a query, from its
    first answering rank (-1: none), as ``eval.metrics`` defines them."""
    r = np.asarray(ranks)
    out = {"recall": {}, "mrr": {}, "hitrate": {}}
    for k in ks:
        hit = (r >= 0) & (r < k)
        out["recall"][k] = out["hitrate"][k] = float(hit.mean())
        out["mrr"][k] = float(np.where(hit, 1.0 / (np.maximum(r, 0) + 1),
                                       0.0).mean())
    return out


def nq_report_recomputed(save_base, codes, inv_offsets, inv_array,
                         recall_num, nrs):
    """The ``eval --nq_answer_*`` report recomputed in numpy from what the
    run wrote: each query's beam codes (coarse tsv), its ndoc and ranked
    ids (fine tsv), the documents' codes and the inverse doc ->
    answering-query arrays.  A query hits at its first beam whose code is
    an answering document's, and at its first answering document."""
    doc_of = np.repeat(np.arange(len(inv_offsets) - 1),
                       np.diff(inv_offsets.astype(np.int64)))
    order = np.argsort(inv_array, kind="stable")
    q_s, d_s = inv_array[order], doc_of[order]      # pairs by query
    coarse, fine, ndoc = [], [], []
    with open(save_base + "_coarse.tsv") as fc, \
            open(save_base + "_fine.tsv") as ff:
        for q, (lc, lf) in enumerate(zip(fc, ff)):
            lo, hi = np.searchsorted(q_s, [q, q + 1])
            docs = d_s[lo:hi]
            mine = {tuple(c) for c in codes[docs].tolist()}
            beams = json.loads(lc.rstrip("\n").split("\t")[1])
            coarse.append(next((b for b, c in enumerate(beams)
                                if tuple(c) in mine), -1))
            cols = lf.rstrip("\n").split("\t")
            ndoc.append(int(cols[1]))
            ans = set(docs.tolist())
            fine.append(next((i for i, dd in enumerate(
                json.loads(cols[2])) if dd in ans), -1))
    ks_c = sorted({k for k in recall_num if k <= nrs} | {nrs})
    return {"ndoc_per_query": float(np.mean(ndoc)),
            "coarse": rank_metrics(coarse, ks_c),
            "fine": rank_metrics(fine, recall_num)}


def reports_equal(tag, got, want, tol=1e-12):
    """A report (JSON keys as strings or ints) against a recomputed one."""
    if abs(got["ndoc_per_query"] - want["ndoc_per_query"]) > tol:
        raise AssertionError(f"{tag}: ndoc_per_query {got['ndoc_per_query']}"
                             f" != {want['ndoc_per_query']}")
    for level in ("coarse", "fine"):
        for m, by_k in want[level].items():
            for k, v in by_k.items():
                g = got[level][m].get(k, got[level][m].get(str(k)))
                if g is None or abs(g - v) > tol:
                    raise AssertionError(f"{tag}: {level} {m}@{k} {g} != "
                                         f"recomputed {v}")


def nq_script_env(work, data, cfgp, log):
    """The environment of the script's stages: ``python`` on PATH is this
    interpreter behind a shim that appends each call's start, end, exit
    code and arguments to ``log``; the checkout on PYTHONPATH; the
    script's variables, ``--allow_hash_tokenizer`` where it tokenizes.
    This machine has no HF tokenizer files, so ``transformers`` is
    hidden from the stages: its import alone took ~15 s a process
    before the tokenizer fell back to the stub all the same."""
    from mevi_tpu_torch.scripts.int8_tax import PACKAGE_ROOT
    bindir = osp.join(work, "bin")
    os.makedirs(bindir, exist_ok=True)
    shim = osp.join(bindir, "python")
    with open(shim, "w") as fw:
        fw.write(f'#!/bin/sh\nt0=$(date +%s.%N)\n"{sys.executable}" "$@"\n'
                 f'rc=$?\necho "$t0 $(date +%s.%N) $rc $*" >> "{log}"\n'
                 'exit $rc\n')
    os.chmod(shim, 0o755)
    hidden = osp.join(work, "no_transformers", "transformers")
    os.makedirs(hidden)
    with open(osp.join(hidden, "__init__.py"), "w") as fw:
        fw.write('raise ImportError("no HF tokenizer files to load")\n')
    env = dict(os.environ, DATA_DIR=data, CFG=cfgp,
               TOKENIZER_FLAGS="--allow_hash_tokenizer", DEVICE_FLAGS="",
               HF_HUB_OFFLINE="1")
    env["PATH"] = os.pathsep.join([bindir, env.get("PATH", "")])
    env["PYTHONPATH"] = os.pathsep.join(
        [osp.dirname(hidden), PACKAGE_ROOT]
        + [p for p in [env.get("PYTHONPATH")] if p])
    return env, osp.join(PACKAGE_ROOT, NQ_SCRIPT)


def command_seconds(log):
    """(command, seconds, exit code) of each shim call, in order."""
    out = []
    with open(log) as fr:
        for ln in fr:
            t0, t1, rc, *argv = ln.split()
            name = "heredoc" if argv[:1] == ["-"] else argv[2]
            if name == "tokenize":
                name += " " + argv[argv.index("--kind") + 1]
            out.append([name, float(t1) - float(t0), int(rc)])
    return out


def time_v3_launch(semb, off_d, cidx, q, cap, reps, pool=None, beams=None,
                   rank="score"):
    """v3 over the buckets ``cidx`` timed alone (CUDA events, the median
    of ``reps`` bare launches, which the wrapper does not count), its
    plain version's time, and the least time for the bytes it must move
    (unique rows read once, queries and outputs) and its valid slots'
    operations at the card's peaks.  With ``pool``, also ``merge_pool``
    timed alone over the kernel's outputs (``beams`` buckets a query), as
    the fine stage runs it between the kernel and the host map."""
    from mevi_tpu_torch.eval.searcher import merge_pool
    from mevi_tpu_torch.ops import bucket as B
    from mevi_tpu_torch.scripts.profile_bucket import (BF16_FLOPS,
                                                        HBM_BYTES_PER_S,
                                                        bytes_of)
    ci = cidx.long()
    st, en = off_d[ci].contiguous(), off_d[ci + 1].contiguous()
    ms = timed_ms(lambda: B._launch(semb, q, cap, 8, starts=st, ends=en),
                  reps)
    plain_ms = timed_ms(lambda: B.bucket_scores_v3_plain(semb, st, en, q,
                                                         cap), 1)
    G, d = q.shape
    nb = bytes_of(st.cpu().numpy(), en.cpu().numpy(), cap, d,
                  semb.element_size(), G, semb.shape[0], q.element_size())
    by_bytes = nb["unique_rows"] / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * nb["valid_slots"] * d / BF16_FLOPS * 1e3
    extra = {}
    if pool is not None:
        scores, rows = B._launch(semb, q, cap, 8, starts=st, ends=en)
        nq = G // beams
        extra["merge_pool_ms"] = timed_ms(lambda: merge_pool(
            scores.reshape(nq, -1), rows.reshape(nq, -1), beams, cap, pool,
            rank), reps)
    return dict(G=G, cap=cap, ms=ms, plain_ms=plain_ms, **extra,
                valid_slots=nb["valid_slots"],
                bytes_unique_rows=nb["unique_rows"],
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_ms_valid_rows=nb["valid_rows"] / HBM_BYTES_PER_S * 1e3,
                library_ms=None)


def nq_phase12(seed, dev):
    """Phase 12: 12a, then 12b over 12a's models and queries, in a
    temporary directory removed at the end.  Returns the v3 launches of
    each path."""
    work = tempfile.mkdtemp(prefix="chip_smoke_nqdpr_")
    try:
        n_a, models = nq_pipeline_phase(seed, dev, work)
        gc.collect()
        torch.cuda.empty_cache()
        n_b = nq_scale_phase(seed, dev, *models)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"12a_nq_pipeline_eval": n_a, "12b_evaluate_nq_21m": n_b}


def nq_pipeline_phase(seed, dev, work):
    """12a: the port's ``nqdpr_pipeline.sh`` in ``work``, stage by stage
    (prepare, answers, index, train, eval), over NQ's raw layouts and an
    AR2 checkpoint made from the seed, ``nqdpr_rq4x5.json`` with bf16
    compute and one training epoch.  Gates: (i) 1,024 rows of
    ``docemb.bin`` against a float32 recompute with the ``ctx_model.``
    tower; (ii) the eval report equal to a numpy recomputation from the
    written files; (iii) fine hitrate@100 above 0; (iv) one batch's pool
    against the plain v3; (v) v3 launched.  Returns (the eval stage's
    v3 launches, what phase 12b reads)."""
    from mevi_tpu_torch.cli.main import (_dev_inputs, _load_nci,
                                         _load_tower, load_config)
    from mevi_tpu_torch.config import InferConfig
    from mevi_tpu_torch.data import io as dio
    from mevi_tpu_torch.eval.run_eval import Evaluator
    from mevi_tpu_torch.eval.searcher import build_fine_index
    from mevi_tpu_torch.models import convert
    from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
    from mevi_tpu_torch.train.trainer import compute_autocast
    from mevi_tpu_torch.utils import native
    from mevi_tpu_torch.utils.profiling import H100_SXM_BF16_DENSE_FLOPS
    P = NQ12
    t_phase = time.perf_counter()
    data = osp.join(work, "nq")
    j = lambda *a: osp.join(data, *a)          # noqa: E731
    secs = {}
    with open(P["config"]) as fr:
        rawcfg = json.load(fr)
    rawcfg["model"]["dtype"] = "bfloat16"
    rawcfg["encoder"]["dtype"] = "bfloat16"
    rawcfg["train"]["num_train_epochs"] = 1
    cfgp = osp.join(work, "nqdpr_rq4x5.json")
    with open(cfgp, "w") as fw:
        json.dump(rawcfg, fw)
    mcfg = load_config(cfgp)
    enc = mcfg.encoder

    # ---- raw files and the AR2 checkpoint ------------------------------
    timed(secs, "write_raw_s", lambda: synth_nq_raw(j("raw"), P, seed + 121))
    t0 = time.perf_counter()
    bdims = BertDims(vocab_size=enc.vocab_size, d_model=enc.d_model,
                     num_layers=enc.num_layers, num_heads=enc.num_heads,
                     d_ff=enc.d_ff,
                     max_position_embeddings=enc.max_position_embeddings,
                     type_vocab_size=enc.type_vocab_size, dropout_rate=0.0)
    ctx32 = hf_bert_init_(BertEncoderModel(bdims, device=dev), seed + 123)
    q32 = hf_bert_init_(BertEncoderModel(bdims, device=dev), seed + 125)
    sd = {}
    for prefix, m, s in (("ctx_model.", ctx32, seed + 124),
                         ("question_model.", q32, seed + 126)):
        sd.update({prefix + k: v.cpu()
                   for k, v in hf_bert_state_dict(m, s).items()})
    split = convert.split_ar2_checkpoint(sd)
    for side, m in (("passage", ctx32), ("query", q32)):
        back = convert.convert_bert_model(split[side], bdims.num_layers)
        if set(back) != set(m.state_dict()) or not all(
                torch.equal(v, m.state_dict()[k].cpu())
                for k, v in back.items()):
            raise AssertionError(f"12a: HF names of the {side} tower do "
                                 "not convert back")
    os.makedirs(j("ckpts"))
    pkl = j("ckpts", "ar2_nq.pkl")
    torch.save({"model_dict": sd, "epoch": 0}, pkl)
    del q32, sd, split, back
    secs["write_checkpoint_s"] = time.perf_counter() - t0

    # ---- the script, stage by stage ------------------------------------
    log = osp.join(work, "commands.log")
    env, script = nq_script_env(work, data, cfgp, log)
    outs = {}
    for stage in ("prepare", "answers", "index", "train", "eval"):
        t0 = time.perf_counter()
        r = subprocess.run(["bash", script, stage], cwd=work, env=env,
                           capture_output=True, text=True,
                           timeout=P["timeout"])
        secs[f"stage_{stage}_s"] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"12a: stage {stage} rc={r.returncode}: "
                                 f"{r.stderr[-4000:]}")
        outs[stage] = r
    cmds = command_seconds(log)
    emit(phase="12a_stages", seconds=secs, commands=cmds)
    out_e = outs["eval"].stdout
    report = json.loads(out_e[out_e.index("{"):])
    launched = [json.loads(ln) for ln in outs["eval"].stderr.splitlines()
                if ln.startswith('{"bucket_launches"')]
    n_eval = launched[-1]["bucket_launches"]["v3"] if launched else 0

    # (i) the ctx tower's embeddings against a float32 recompute
    n_docs = P["passages"]
    emb = dio.open_embedding_memmap(j("ar2", "docemb.bin"), enc.d_model)
    tok, msk = dio.open_token_memmaps(j("ar2", "all_document"),
                                      enc.doc_length)
    n_chk = P["check_rows"]
    with torch.inference_mode():
        ref = torch.cat([ctx32.cls_rep(
            torch.from_numpy(np.array(tok[s:e], np.int64)).to(dev),
            torch.from_numpy(np.array(msk[s:e], np.int64)).to(dev))
            for s, e in ((s, min(s + 256, n_chk))
                         for s in range(0, n_chk, 256))]).cpu().numpy()
    del ctx32
    got = np.asarray(emb[:n_chk])
    rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
    if not (emb.shape == (n_docs, enc.d_model) and np.isfinite(emb).all()):
        raise AssertionError(f"12a: docemb {emb.shape} misshapen or not "
                             "finite")
    if not rel.max() <= P["emb_tol"]:
        raise AssertionError(f"12a: bf16 embeddings {rel.max():.4f} off "
                             f"the float32 recompute (> {P['emb_tol']})")
    if int(np.asarray(tok).max()) >= enc.vocab_size:
        raise AssertionError("12a: a token id past the BERT word table")

    # (ii) the report against a recomputation from the written files
    codes = np.load(j("ar2", "index", "rq_codes.npy"))
    inv_off = np.fromfile(j("origin", "test_inverse_offsets.bin"), np.int64)
    inv_arr = np.fromfile(j("origin", "test_inverse_array.bin"), np.int32)
    icfg = InferConfig()
    want = nq_report_recomputed(j("ar2", "nci_result_rq45_top10"), codes,
                                inv_off, inv_arr, icfg.recall_num,
                                icfg.num_return_sequences)
    reports_equal("12a", report, want)
    # (iii) the answers sit in their gold passages: some are found
    hit100 = report["fine"]["hitrate"]["100"]
    if not hit100 > 0:
        raise AssertionError(f"12a: fine hitrate@100 {hit100}")
    # (v) the eval stage went through the kernel
    if n_eval == 0:
        raise AssertionError(f"12a: the eval stage launched no v3: "
                             f"{launched}")

    # (iv) one batch's pool against the plain v3, in this process, with
    # the models, index and queries the eval stage read
    t0 = time.perf_counter()
    nci = _load_nci(osp.join(work, "ckpts", "nci", "best"), mcfg, dev)
    _, rep_fn = _load_tower(mcfg, pkl, "query", dev)
    with no_transformers():
        (queries, qids, qmask, _), _, _ = quiet(
            _dev_inputs, j("origin", "test_queries.tsv"), mcfg, 32, True)
    fine = build_fine_index(codes, np.asarray(emb), mcfg.rq.kary,
                            dtype=torch.bfloat16, device=dev)
    ev = Evaluator(nci, icfg, fine_index=fine, query_rep_fn=rep_fn,
                   doc_codes=codes, device=dev)
    B = P["pool_batch"]
    with torch.inference_mode(), compute_autocast(dev, nci.dims.t5.dtype):
        res = ev.run_batch(queries[:B], qids[:B], qmask[:B])
        ids = torch.from_numpy(qids[:B]).to(dev)
        qemb = rep_fn(ids, torch.from_numpy(qmask[:B]).to(dev))
        kern = ev._rerank(qemb, res.beam_codes)
        with plain_v3():
            plain = ev._rerank(qemb, res.beam_codes)
    err, n_sep = compare_pools(
        "12a_plain_bucket", tuple(torch.from_numpy(x) for x in kern[:2]),
        tuple(torch.from_numpy(x) for x in plain[:2]), P["plain_atol"])
    secs["pool_check_s"] = time.perf_counter() - t0
    del ev, fine

    gen_s = sum(s for c, s, _ in cmds if c == "gen-embeddings")
    flops = bert_tower_flops(bdims, n_docs, enc.doc_length)
    n_pairs = len(inv_arr)
    emit(phase="12a_nq_pipeline", passages=n_docs,
         train_items=P["train_items"], test_questions=len(queries),
         pool_check_s=secs["pool_check_s"], gen_embeddings_command_s=gen_s,
         embeddings_per_s_command=n_docs / gen_s,
         model_tflop=flops / 1e12,
         bf16_dense_peak_share_command=flops / gen_s
         / H100_SXM_BF16_DENSE_FLOPS,
         native_library_loaded=native.ensure_built() is not None,
         answer_pairs=n_pairs,
         answering_passages=int((np.diff(inv_off) > 0).sum()),
         check_rows=n_chk, max_row_rel_l2_err=float(rel.max()),
         mean_row_rel_l2_err=float(rel.mean()), emb_tol=P["emb_tol"],
         report=report, report_equals_recomputation=True,
         fine_hitrate_at_100=hit100, v3_launches=n_eval,
         plain_pool_max_abs_err=err, ids_compared=n_sep,
         peak_device_gb_this_process=torch.cuda.max_memory_allocated()
         / 1e9, phase_s=time.perf_counter() - t_phase, card=card_line())
    return n_eval, (mcfg, nci, rep_fn, queries, qids, qmask)


def nq_scale_phase(seed, dev, mcfg, nci, rep_fn, queries, qids, qmask):
    """12b: ``Evaluator.evaluate_nq`` over 21,015,324 x 768 bf16 rows with
    RQ structure (phase 5's recipe) made on the card in CSR order, 12a's
    trained NCI and ``question_model.`` tower (bf16), the 3,610 test
    questions at batch 512, ``InferConfig`` defaults.  Each query's
    answering passage is planted at a drawn rank r of the plain pool of
    its beams (plain v3 + ``merge_pool``).  Gates: the fine hit ranks are
    the planted ones (ties aside), the coarse hit rate is 1 for every
    planted query, the whole report equals a numpy recomputation from
    the kept results, one batch's pool against the plain v3, v3
    launched.  Returns the v3 launches of the evaluation."""
    from mevi_tpu_torch.config import InferConfig
    from mevi_tpu_torch.eval.ensemble import AnswerIndex
    from mevi_tpu_torch.eval.run_eval import Evaluator, pad_batch
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.index.csr import pack_codes, unpack_codes
    from mevi_tpu_torch.train.trainer import compute_autocast
    P = NQ12B
    t_phase = time.perf_counter()
    secs = {}
    N, d, K, M = P["ndoc"], mcfg.rq.emb_size, mcfg.rq.kary, \
        mcfg.rq.subvector_num
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9

    # ---- the corpus, made in CSR order (no gathered second copy) -------
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 131)
    active = rng.choice(K ** M, size=P["nonempty"], replace=False)
    w = rng.lognormal(0.0, P["sigma"], size=active.size)
    sizes = np.zeros(K ** M, np.int64)
    sizes[active] = rng.multinomial(N, w / w.sum())
    offsets = np.zeros(K ** M + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    row_cluster = np.repeat(np.arange(K ** M), sizes)      # CSR order
    doc_ids = rng.permutation(N).astype(np.int32)          # row -> doc
    doc_cluster = np.empty(N, np.int64)
    doc_cluster[doc_ids] = row_cluster
    codes = unpack_codes(doc_cluster, M, K)
    secs["codes_csr_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    row_cluster = torch.from_numpy(row_cluster).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 131)
    books = [torch.randn((K, d), generator=g, device=dev) * (0.5 ** lvl)
             * d ** -0.5 for lvl in range(M)]
    semb = torch.empty((N, d), dtype=torch.bfloat16, device=dev)
    step = 1 << 18
    for s in range(0, N, step):
        c = unpack_codes(row_cluster[s:s + step].long(), M, K).long()
        x = torch.randn((c.shape[0], d), generator=g, device=dev).mul_(
            P["noise"] * d ** -0.5)
        for lvl in range(M):
            x += books[lvl][c[:, lvl]]
        semb[s:s + c.shape[0]] = x.to(torch.bfloat16)
    del row_cluster, books, x, c
    torch.cuda.synchronize()
    secs["fill_s"] = time.perf_counter() - t0
    fine = FineIndex(torch.from_numpy(offsets).to(dev),
                     torch.from_numpy(doc_ids).to(dev), semb, M, K,
                     host_offsets=offsets, host_doc_ids=doc_ids)
    icfg = InferConfig()
    ev = Evaluator(nci, icfg, fine_index=fine, query_rep_fn=rep_fn,
                   doc_codes=codes, device=dev)
    n, Bq = len(queries), P["batch"]

    # ---- the plain pools of the beams; plant the answers ---------------
    t0 = time.perf_counter()
    plain_s, plain_i, beams = [], [], []
    with torch.inference_mode(), compute_autocast(dev, nci.dims.t5.dtype), \
            plain_v3():
        for s in range(0, n, Bq):
            sl = slice(s, min(s + Bq, n))
            (qi, qm), real = pad_batch([qids[sl], qmask[sl]], Bq)
            r = ev._trimmed(ev.run_batch(queries[sl], qi, qm), real)
            plain_s.append(r.fine_scores)
            plain_i.append(r.fine_ids)
            beams.append(r.beam_codes)
    plain_s, plain_i = np.concatenate(plain_s), np.concatenate(plain_i)
    beams = np.concatenate(beams)
    secs["plain_pools_s"] = time.perf_counter() - t0
    ranks = rng.integers(0, P["plant_ranks"], n)
    doc = plain_i[np.arange(n), ranks]
    beam_clusters = pack_codes(beams, K)
    planted = (doc >= 0) & (beam_clusters == doc_cluster[np.maximum(
        doc, 0)][:, None]).any(1)
    qs = np.nonzero(planted)[0]
    order = np.argsort(doc[qs], kind="stable")
    inv_off = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(doc[qs], minlength=N), out=inv_off[1:])
    inv_arr = qs[order].astype(np.int32)
    aidx = AnswerIndex(inv_off, inv_arr)
    inversion = {}
    inner = aidx.query_clusters

    def timed_inversion(*a):
        t = time.perf_counter()
        out = inner(*a)
        inversion["query_clusters_s"] = time.perf_counter() - t
        return out
    aidx.query_clusters = timed_inversion

    # ---- the evaluation through the kernel ------------------------------
    ev.timings.clear()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with compute_autocast(dev, nci.dims.t5.dtype):
        out = ev.evaluate_nq(queries, qids, qmask,
                             query_indices=list(range(n)), answer_index=aidx,
                             batch_size=Bq, keep_results=True)
    wall = time.perf_counter() - t0
    n_eval = read_counts()["v3"]
    if n_eval == 0:
        raise AssertionError("12b: the v3 kernel never launched")
    coarse_s = sum(t["coarse_ms"] for t in ev.timings) / 1e3
    fine_s = sum(t["fine_ms"] for t in ev.timings) / 1e3

    # ---- gates ------------------------------------------------------------
    ks_s = np.concatenate([r.fine_scores for r in out.results])
    ks_i = np.concatenate([r.fine_ids for r in out.results])
    k_beams = np.concatenate([r.beam_codes for r in out.results])
    np.testing.assert_array_equal(k_beams, beams,
                                  err_msg="12b: beams of the two passes")
    err, n_sep = compare_pools(
        "12b_plain_bucket", (torch.from_numpy(ks_s[:Bq]),
                             torch.from_numpy(ks_i[:Bq])),
        (torch.from_numpy(plain_s[:Bq]), torch.from_numpy(plain_i[:Bq])),
        P["plain_atol"])
    answer = np.where(planted, doc, -2)
    found = ks_i == answer[:, None]
    fine_rank = np.where(found.any(1), found.argmax(1), -1)
    moved = np.nonzero(planted & (fine_rank != ranks))[0]
    for q in moved:      # a tie: the planted score equals the one there
        f = fine_rank[q]
        if f < 0 or abs(plain_s[q, ranks[q]] - plain_s[q, f]) > \
                P["plain_atol"]:
            raise AssertionError(f"12b: query {q} planted at {ranks[q]} "
                                 f"found at {f}")
    want_cl = np.where(planted, doc_cluster[np.maximum(doc, 0)], -1)
    hit_c = pack_codes(k_beams, K) == want_cl[:, None]
    coarse_rank = np.where(hit_c.any(1), hit_c.argmax(1), -1)
    if (coarse_rank[planted] < 0).any():
        raise AssertionError("12b: a planted query's cluster left its "
                             "beams")
    want = {"ndoc_per_query": float(np.concatenate(
        [r.ndoc for r in out.results]).mean()),
        "coarse": rank_metrics(coarse_rank, sorted(
            {k for k in icfg.recall_num if k <= icfg.num_return_sequences}
            | {icfg.num_return_sequences})),
        "fine": rank_metrics(fine_rank, icfg.recall_num)}
    reports_equal("12b", {"ndoc_per_query": out.ndoc_per_query,
                          "coarse": out.coarse, "fine": out.fine}, want)
    share = {k: float((planted & (ranks < k)).mean())
             for k in icfg.recall_num}
    off = max(abs(out.fine["hitrate"][k] - share[k]) for k in share)
    if off > len(moved) / n + 1e-12:
        raise AssertionError(f"12b: hit rates {out.fine['hitrate']} off "
                             f"the planted shares {share}")

    # one launch over the first batch's buckets at cap 4096, timed alone
    with torch.inference_mode(), compute_autocast(dev, nci.dims.t5.dtype):
        q0 = rep_fn(torch.from_numpy(qids[:Bq]).to(dev),
                    torch.from_numpy(qmask[:Bq]).to(dev))
    q_rep = q0.to(semb.dtype).repeat_interleave(
        icfg.num_return_sequences, 0).contiguous()
    t_k = time_v3_launch(semb, fine.offsets, torch.from_numpy(
        beam_clusters[:Bq].reshape(-1)).to(dev), q_rep,
        icfg.max_cluster_docs, P["kernel_reps"], pool=max(icfg.recall_num),
        beams=icfg.num_return_sequences, rank=icfg.rank_mode)
    emit(phase="12b_evaluate_nq", rows=N, d=d,
         corpus_gb=semb.numel() * semb.element_size() / 1e9,
         nonempty=P["nonempty"], cluster_sizes=cluster_stats(
             offsets, icfg.max_cluster_docs), queries=n, batch=Bq,
         beams=icfg.num_return_sequences, cap=icfg.max_cluster_docs,
         pool=max(icfg.recall_num), seconds=secs,
         inversion_s=inversion.get("query_clusters_s"),
         evaluate_nq_s=wall, coarse_s=coarse_s, fine_s=fine_s,
         host_outside_batches_s=wall - coarse_s - fine_s,
         queries_per_s=n / wall, planted=int(planted.sum()),
         moved_by_ties=len(moved), planted_share_below_k=share,
         coarse=out.coarse, fine=out.fine,
         ndoc_per_query=out.ndoc_per_query,
         report_equals_recomputation=True, v3_launches=n_eval,
         plain_pool_max_abs_err=err, ids_compared=n_sep,
         v3_at_cap_4096=t_k, allocated_gb_at_start=base_gb,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase, card=card_line())
    return n_eval


def serve_phases(cfg, seed, dev, phase1_only=False):
    """Phases 1-4 over the corpus of :func:`make_corpus`.  Returns
    (phase-1 results, bf16, int8 and float32, launches of each kernel on
    its path, launches on the int8 paths, evaluation launches, (qtower,
    nci)), or None after phase 1 with ``phase1_only``; the corpus, its
    int8 copy and the servers are freed on return."""
    from mevi_tpu_torch.config import InferConfig
    from mevi_tpu_torch.eval.searcher import FineIndex
    from mevi_tpu_torch.index.build import quantize_int8
    from mevi_tpu_torch.scripts import profile_bucket
    from mevi_tpu_torch.serve import BucketServer

    # ---- data ----------------------------------------------------------
    t0 = time.perf_counter()
    semb, offsets, doc_ids, doc_cluster = make_corpus(cfg, dev, seed)
    torch.cuda.synchronize()
    stats = cluster_stats(offsets, cfg["cap"])
    emit(corpus_rows=int(semb.shape[0]), d=int(semb.shape[1]),
         corpus_gb=semb.numel() * semb.element_size() / 1e9,
         cluster_sizes=stats, setup_s=time.perf_counter() - t0)
    off_d = torch.from_numpy(offsets).to(dev)
    semb_i8, scale = quantize_int8(semb)
    torch.cuda.synchronize()

    # ---- phase 1 -------------------------------------------------------
    rng = np.random.default_rng(seed + 7)
    G = cfg["batch"] * cfg["beams"]
    cidx = torch.from_numpy(phase1_cidx(rng, doc_cluster, offsets, G)).to(dev)
    q = torch.randn((G, cfg["d"]), generator=torch.Generator(
        device=dev).manual_seed(seed + 3), device=dev).to(torch.bfloat16)
    # v3 and fused also at the Evaluator's cap (InferConfig's
    # max_cluster_docs, 4096), the cap of every evaluation path (4, 8e,
    # 12a, 12b); serving runs cfg["cap"] (512)
    cap_eval = InferConfig().max_cluster_docs
    reset_counts()
    p1 = check_kernel("bf16", semb, off_d, cidx, q, cfg["cap"], dev,
                      cfg["kernel_reps"])
    p1["cap_eval"] = check_kernel("bf16", semb, off_d, cidx, q, cap_eval,
                                  dev, cfg["kernel_reps"],
                                  modes=("v3", "fused"))
    q8 = (q.float() / scale).to(torch.bfloat16)
    p1_i8 = check_kernel("int8", semb_i8, off_d, cidx, q8, cfg["cap"], dev,
                         cfg["kernel_reps"])
    p1_i8["cap_eval"] = check_kernel("int8", semb_i8, off_d, cidx, q8,
                                     cap_eval, dev, cfg["kernel_reps"],
                                     modes=("v3", "fused"))
    # a float32 copy with float32 queries: the instance the sharded
    # stage of phase 11 serves (27 GB, freed at once)
    semb32 = semb.float()
    p1_f32 = check_kernel("f32", semb32, off_d, cidx, q.float(), cfg["cap"],
                          dev, cfg["kernel_reps"])
    p1_f32["cap_eval"] = check_kernel("f32", semb32, off_d, cidx, q.float(),
                                      cap_eval, dev, cfg["kernel_reps"],
                                      modes=("v3", "fused"))
    del semb32
    torch.cuda.empty_cache()
    # fused serves no path: its launches are phase 1's checked calls
    n_fused = read_counts()["fused"]
    if n_fused == 0:
        raise AssertionError("1: the fused mode never launched")
    # the v2 kernel's path: the A/B entry point, over the int8 corpus
    reset_counts()
    prof = profile_bucket.profile(semb_i8, off_d, cidx, q8, cfg["cap"],
                                  reps=cfg["profile_reps"], device=dev)
    n_profile = read_counts()
    if n_profile["v2"] == 0:
        raise AssertionError("1: profile_bucket never launched v2")
    emit(phase="1_profile_bucket", corpus="int8", G=G, cap=cfg["cap"],
         reps=cfg["profile_reps"], launches=n_profile, **prof)
    p1["rmsnorm"] = check_rmsnorm(dev, seed, cfg["kernel_reps"])
    if phase1_only:
        return None

    # ---- phase 2 -------------------------------------------------------
    t0 = time.perf_counter()
    qtower, nci = build_models(cfg, dev, seed)
    index = FineIndex(off_d, torch.from_numpy(doc_ids).to(dev), semb,
                      cfg["levels"], cfg["kary"], host_offsets=offsets,
                      host_doc_ids=doc_ids)
    kw = dict(num_beams=cfg["beams"], cap=cfg["cap"], pool=cfg["pool"],
              length_penalty=cfg["length_penalty"], device=dev)
    server = BucketServer(qtower, nci, index, **kw)
    torch.cuda.synchronize()
    emit(models_s=time.perf_counter() - t0,
         nci_params=sum(p.numel() for p in nci.parameters()),
         qtower_params=sum(p.numel() for p in qtower.parameters()))
    Bq, L = cfg["batch"], cfg["qlen"]
    n_batches = cfg["warmup"] + cfg["timed"]
    mask = torch.ones((Bq, L), dtype=torch.int32, device=dev)

    def batches(override):
        out = []
        for i in range(n_batches):
            ids = torch.from_numpy(rng.integers(
                2, cfg["vocab"], size=(Bq, L)).astype(np.int32)).to(dev)
            ov = None
            if override:
                ov = torch.from_numpy(doc_cluster[rng.integers(
                    0, len(doc_cluster), G)].astype(np.int32)).to(dev)
            out.append((ids, mask, ov))
        return out

    own = batches(False)
    over = batches(True)
    n_own, _ = run_path("2_own_codes", server, own, cfg)
    n_over, last = run_path("2_cidx_override", server, over, cfg)
    main_launches = n_own + n_over
    # the plain bucket version on the last batch
    ids, m, ov, out, (cidx_l, q_rep, ts, tr) = last
    err, n_sep = compare_pools("2_plain", (ts, tr),
                               pool_with_plain(server, cidx_l, q_rep, Bq))
    emit(phase="2_plain_check", max_abs_pool_err=err, ids_compared=n_sep)
    profile_path(server, over[-2:])
    emit(peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)

    # ---- phase 2b: the raw-score path on the last override batch --------
    n_raw = raw_path(server, cidx_l, q_rep, (ts, tr), Bq, dev)

    # ---- phase 3: int8 corpus ------------------------------------------
    index8 = index._replace(sorted_emb=semb_i8)
    server8 = BucketServer(qtower, nci, index8, inv_scale=1.0 / scale, **kw)
    reset_counts()
    n_int8, last8 = run_path("3_int8", server8, over, cfg)
    ids, m, ov, out8, (cidx8, q8s, ts8, tr8) = last8
    err8, n_sep8 = compare_pools("3_plain", (ts8, tr8),
                                 pool_with_plain(server8, cidx8, q8s, Bq))
    ref16 = server.finalize(server.query_device(ids, m, ov))
    top1 = float((ref16[1][:, 0] == out8[1][:, 0]).mean())
    emit(phase="3_int8_check", int8_scale=scale, max_abs_pool_err=err8,
         ids_compared=n_sep8, top1_agree_with_bf16=top1,
         corpus_gb=semb_i8.numel() / 1e9)
    del server8

    # ---- phase 4: offline evaluation -----------------------------------
    n_eval, n_4c = eval_phase(cfg, seed, dev, qtower, nci, index, semb_i8,
                              scale, doc_cluster, offsets, doc_ids)
    emit(peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)

    paths = {"v3": main_launches, "fused": n_fused, "v2": n_profile["v2"],
             "raw": n_raw}
    int8_paths = {"v3": {"3_int8": n_int8, "4c_device_rerank": n_4c},
                  "v2": {"1_profile_bucket": n_profile["v2"]}}
    return p1, p1_i8, p1_f32, paths, int8_paths, n_eval, (qtower, nci)


def run(cfg, seed, phase1_only=False, phase6_only=False, phase7_only=False,
        phase8_only=False, phase9_only=False, phase10_only=False,
        phase11_only=False, phase12_only=False):
    from mevi_tpu_torch.ops import bucket as B

    dev = torch.device("cuda")
    # float32 matmuls stay float32 (no TF32), stated and set explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(card_line(), flush=True)
    emit(torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    k = B.build_kernel()
    emit(kernel_build_s=k.build_seconds, library=k.path.name,
         ptxas=ptxas_summary(k.build_log))
    if phase1_only:
        serve_phases(cfg, seed, dev, phase1_only=True)
        emit(total_s=time.perf_counter() - t_start)
        print(card_line(), flush=True)
        return 0
    if phase8_only:
        with no_transformers():
            out = pipeline_phase(cfg, seed, dev)
        emit(total_s=time.perf_counter() - t_start,
             pipeline_v3_launches=out)
        print(card_line(), flush=True)
        return 0
    if phase12_only:
        out = nq_phase12(seed, dev)
        emit(total_s=time.perf_counter() - t_start, nq_v3_launches=out)
        print(card_line(), flush=True)
        return 0
    # phase 10's bundle, read by phase 11, removed at the end
    workdir = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        if phase10_only:
            n10, n10_int8 = scripts_phase(cfg, dev, workdir)
            emit(total_s=time.perf_counter() - t_start,
                 scripts_v3_launches=n10, scripts_v3_int8_launches=n10_int8)
            print(card_line(), flush=True)
            return 0
        if phase11_only:
            quality_phase(dev, workdir)
            n11, n11_int8 = rest_phase(cfg, dev, workdir)
            emit(total_s=time.perf_counter() - t_start,
                 rest_v3_f32_launches=n11, rest_v3_int8_launches=n11_int8)
            print(card_line(), flush=True)
            return 0
        nci_path = osp.join(tempfile.mkdtemp(prefix="chip_smoke_nci_"),
                            "trained_nci.pt")
        try:
            return run_phases(cfg, seed, dev, t_start, nci_path, workdir,
                              phase6_only, phase7_only, phase9_only)
        finally:
            shutil.rmtree(osp.dirname(nci_path), ignore_errors=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_phases(cfg, seed, dev, t_start, nci_path, workdir, phase6_only,
               phase7_only, phase9_only):
    """Phases 2-12 (or 6, 7, or 6a + 7 + 9 alone); the trained NCI of
    phase 7 passes to phase 9 through the file ``nci_path``, phase 10's
    bundle to phase 11 through ``workdir``."""
    if phase6_only or phase7_only or phase9_only:
        qtower, nci = build_models(cfg, dev, seed)
        corpus, secs = synth_corpus(cfg, seed, dev)
        out = {}
        if phase6_only:
            out["synth_v3_launches"] = synth_phase(cfg, seed, dev, qtower,
                                                   nci, corpus, secs)
        else:
            out["trained_serve_v3_launches"] = train_phase(
                cfg, seed, dev, qtower, corpus, nci_out=nci_path)
        if phase9_only:
            del qtower, nci
            gc.collect()
            torch.cuda.empty_cache()
            out["sharded_v3_launches"] = sharded_phase(cfg, seed, dev,
                                                       corpus, nci_path)
        emit(total_s=time.perf_counter() - t_start, **out)
        print(card_line(), flush=True)
        return 0
    p1, p1_i8, p1_f32, paths, int8_paths, n_eval, models = serve_phases(
        cfg, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    n_build = build_phase(cfg, seed, dev, *models)
    gc.collect()
    torch.cuda.empty_cache()
    corpus, secs = synth_corpus(cfg, seed, dev)
    n_synth, n_synth8 = synth_phase(cfg, seed, dev, *models, corpus, secs)
    gc.collect()
    torch.cuda.empty_cache()
    n_trained = train_phase(cfg, seed, dev, models[0], corpus,
                            nci_out=nci_path)
    # phase 8 starts from a near-empty card: the phase-2 models go, and
    # of phase 6's corpus only its tables (~0.1 GB), draws and CSR stay,
    # for phase 9 to refill the matrix
    del models
    corpus.pop("ref")
    gc.collect()
    torch.cuda.empty_cache()
    with no_transformers():
        n_pipe = pipeline_phase(cfg, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    n9, n9_int8, n9c = sharded_phase(cfg, seed, dev, corpus, nci_path)
    del corpus
    gc.collect()
    torch.cuda.empty_cache()
    n10, n10_int8 = scripts_phase(cfg, dev, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    n11, n11_int8 = rest_phase(cfg, dev, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    n12 = nq_phase12(seed, dev)

    kernels = []
    for mode in ("v3", "fused", "v2", "raw"):
        r = p1[mode]
        entry = {
            "name": WRAPPER[mode], "route": "cuda", "source": KERNEL_SRC,
            "replaces": REPLACES[mode], "launches": paths[mode],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "yardstick_ms": r["yardstick_ms"],
            "bound_ms_full_window": r["bound_ms_full_window"]}
        if "bound_ms_valid_rows" in r:
            entry["bound_ms_valid_rows"] = r["bound_ms_valid_rows"]
        keys = ("ms", "bound_ms", "bound_ms_valid_rows",
                "bound_ms_full_window", "max_abs_err", "plain_ms",
                "yardstick_ms")
        if mode in p1["cap_eval"]:          # v3 and fused at cap 4096
            entry["cap_4096"] = {k: p1["cap_eval"][mode][k] for k in keys}
        if mode == "v3":
            entry["launches"] += n_build + n_synth + n_trained + sum(
                n_pipe.values()) + n9 + n9c + sum(n10.values()) + sum(
                n11.values()) + sum(n12.values())
            # phase 9: summed over the ranks
            entry["launches_by_path"] = {"serve": paths["v3"],
                                         "index_build_serve": n_build,
                                         "synth_corpus_serve": n_synth,
                                         "7_trained_serve": n_trained,
                                         **n_pipe, "9_sharded_serve": n9,
                                         "9c_sharded_serve_nccl": n9c,
                                         **n10, **n11, **n12}
        r8 = p1_i8[mode]
        entry["int8"] = {k: r8[k] for k in keys if k in r8}
        entry["int8"]["launches_by_path"] = int8_paths.get(mode, {})
        if mode == "v3":
            entry["int8"]["launches_by_path"]["6c_synth_int8"] = n_synth8
            entry["int8"]["launches_by_path"]["9_sharded_serve_int8"] = \
                n9_int8
            entry["int8"]["launches_by_path"].update(n10_int8)
            entry["int8"]["launches_by_path"].update(n11_int8)
        rf = p1_f32[mode]
        entry["f32"] = {k: rf[k] for k in keys if k in rf}
        for sub, res in (("int8", p1_i8), ("f32", p1_f32)):
            if mode in res["cap_eval"]:
                entry[sub]["cap_4096"] = {k: res["cap_eval"][mode][k]
                                          for k in keys}
        entry["f32"]["launches_by_path"] = (
            {"11a_sharded_parity_f32": n11["11a_sharded_parity_f32"]}
            if mode == "v3" else {})
        kernels.append(entry)
    from mevi_tpu_torch.ops.rmsnorm import launch_count as rms_count
    r = p1["rmsnorm"]
    kernels.append({
        "name": "rmsnorm", "route": "cuda", "source": RMS["src"],
        "replaces": RMS["replaces"],
        "launches": sum(v if isinstance(v, int) else v["warmup"] + v["timed"]
                        for v in RMS_LAUNCHES.values()),
        "launches_by_path": RMS_LAUNCHES,
        "launches_in_process": rms_count(),
        "max_abs_err": r["max_abs_err"], "max_bf16_ulps": r["bf16_ulps"],
        "max_f32_rel_err": r["f32_rel"],
        "grad_max_rel_err": r["grad_max_rel_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
        "shape": RMS["shapes"][0], "shapes": r["shapes"]})
    emit(total_s=time.perf_counter() - t_start, int8_launches=int8_paths,
         eval_launches=n_eval)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase1-only", action="store_true",
                    help="build the kernels, run phase 1 and stop")
    ap.add_argument("--phase6-only", action="store_true",
                    help="build the kernels and the models, run phase 6 "
                         "and stop")
    ap.add_argument("--phase7-only", action="store_true",
                    help="build the kernels and the models, run phase 6a's "
                         "corpus build, then phase 7, and stop")
    ap.add_argument("--phase8-only", action="store_true",
                    help="build the kernels, run phase 8 (the CLI "
                         "pipeline) and stop")
    ap.add_argument("--phase9-only", action="store_true",
                    help="build the kernels and the models, run phase 6a's "
                         "corpus build, phase 7, then phase 9 (the "
                         "multi-device path) and stop")
    ap.add_argument("--phase10-only", action="store_true",
                    help="build the kernels, run phase 10 (quality_full, "
                         "bench, int8_tax) and stop")
    ap.add_argument("--phase11-only", action="store_true",
                    help="build the kernels, run 10a (the bundle), then "
                         "phase 11 (the rest of the scripts) and stop")
    ap.add_argument("--phase12-only", action="store_true",
                    help="build the kernels, run phase 12 (the NQ-DPR "
                         "configuration) and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    return run(FULL, args.seed, args.phase1_only, args.phase6_only,
               args.phase7_only, args.phase8_only, args.phase9_only,
               args.phase10_only, args.phase11_only, args.phase12_only)


if __name__ == "__main__":
    sys.exit(main())
