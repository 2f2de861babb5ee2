"""End-to-end serving benchmark of the port on one card: the counterpart
of ``bench.py``'s ``run()`` and of its child's result line.

It serves the reference's headline configuration (``marco_eval_nci_rq.sh``:
a T5 query tower, the NCI beam over 10 clusters, the in-cluster fine
re-rank, pool 1000) through ``serve.BucketServer`` over the synthetic
corpus of :mod:`mevi_tpu_torch.data.synth` at MS MARCO scale (8,841,823 x
768 by default, RQ 4 x 32 codes), made on the card.

    python -m mevi_tpu_torch.bench [--ndoc N] [--ckpt DIR]
        [--dtype bf16|int8] [--batch B] [--nbatch N] [--cap C]
        [--bucket_kernel v3|fused] [--device cuda|cpu]

Two pipelines:

* random weights (the default): tower and beam run in full, and the
  bucket stage is driven by ``cidx_override`` clusters drawn
  doc-weighted from the corpus (a random beam's clusters are mostly
  empty);
* ``--ckpt DIR``: a bundle written by ``scripts.quality_full`` (the
  port's; JAX bundles hold orbax checkpoints the port cannot read).  The
  beam's own codes drive the kernel.  When ``--ndoc`` differs from the
  bundle's corpus, codes are assigned with the bundle's codebooks and
  ``prefix_shift`` over the larger corpus of the same family.  An
  incomplete bundle raises.

Geometry on the card: batch 512, 20 timed batches, 10 beams, cap 512,
pool 1000, bf16 (int8 with ``--dtype int8``: the scale from the true
maximum over every row; queries stay float).  On the CPU (``--device
cpu``) the JAX script's CPU branch: at most 20,000 documents, d 64, a
2 + 2 layer T5, batch 4, 3 batches, pool 100, cap 64, float32.

Prints one JSON line on stdout (progress goes to stderr) with the keys of
the JAX line (``BENCH_r05.json`` ``parsed``), measured here on the card:

* ``metric`` / ``value`` / ``unit``: served queries/s: every timed batch
  enqueued by ``query_device``, then each ``finalize``d (device outputs
  fetched, rows mapped to doc ids), on the host clock.  The port's
  ``query_device`` syncs once a batch on the kernel wrapper's bounds
  check, where the JAX server enqueues without waiting;
* ``vs_baseline``: ``value`` over ``baseline_qps_measured``;
* ``ndoc``, ``batch``, ``cap``, ``pipeline`` (``cidx_override`` or
  ``trained``), ``corpus_dtype`` (``bf16``, ``int8``, or ``f32`` on the
  CPU), ``int8_scale`` (int8 only: 126 over the largest |component|);
* ``rpc_floor_ms``: the dispatch-and-fetch floor, a tiny op launched and
  one element fetched (mean of 5);
* ``cluster_sizes``: non-empty clusters and their mean, p99 and largest
  size, and how many exceed the cap;
* ``kernel_matches_oracle`` (card only): the kernel the server serves
  with, on 64 sampled clusters, against its plain version: rows equal,
  scores within rtol 1e-4 / atol 1e-3 (``chip_smoke.py``'s gate);
* ``recall100_beam_coarse`` / ``recall100_oracle_coarse``: recall@100
  against exact MIPS of 64 perturbed-document queries, the fine stage
  (``eval.searcher.fine_rerank``, cap-truncated clusters) fed by a
  codebook beam over the query embedding or by the coverage-optimal
  oracle clusters; ``oracle_cluster_coverage``: the share of the exact
  top-100 those 10 oracle clusters hold before the cap, an upper bound
  of both;
* ``trained_*`` (``--ckpt`` only): the served pipeline on 256 (512 on the
  card) dev utterances of indexed documents: coarse hit@1 / hit@10, fine
  recall@100 and MRR@10, the same over the beam-major order of the
  pool, documents scored a query;
* ``cold_start_s``: the first served batch (no compile; the first call's
  allocations and library set-up);
* ``ndoc_per_query``: documents in the 10 clusters of a query, averaged
  over the timed batches;
* ``sequential_qps``: half the batches, each served and fetched before
  the next;
* ``baseline_qps_measured`` / ``baseline_def``: the reference's serving
  architecture on the same card: batch 2, the cache-less panel beam
  (``decode.beam.nci_beam_search``), a host hop of the codes, then the
  plain fine re-rank;
* ``latency_b8_ms``: one batch of 8 served and fetched (mean of 5);
* ``stages``: ``qenc_ms``, ``beam_ms``, ``bucket_ms`` (each call
  synchronized, mean of 5, host clock), ``rpc_floor_ms``; on the card
  also the tower's and the beam's device ms
  (``utils.profiling.traced_stage_seconds``: CUDA kernels of a
  ``torch.profiler`` trace, a call) and their share of the H100's bf16
  dense peak from ``flops_of``;
* ``bucket_launches`` (the port's addition): launches of each bucket
  kernel wrapper in this run after the kernel check (whose one launch
  of the served kernel is a comparison, not the served path).

Not carried over from the JAX script: its corpus-size ladder, backend
probe and result sidecars.  A run that fails exits non-zero and prints
no line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import sys
import time

import numpy as np
import torch

from . import resolve_device, synchronize

NBEAM = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fetch1(t):
    """Wait for ``t`` by fetching one element to the host."""
    return t.reshape(-1)[:1].cpu()


def bundle_complete(cand) -> bool:
    """A bundle is servable when the corpus spec, the trained tower and
    a ranked NCI checkpoint board all exist."""
    need = [osp.join(cand, "spec.json"), osp.join(cand, "tower_params.npz"),
            osp.join(cand, "ckpts", "nci", "leaderboard.json")]
    return all(osp.exists(p) for p in need)


def random_models(D, KARY, M, on_card, dt, dev):
    """The random-weight models: T5-base NCI (12 + 6, PAWA 4) and a
    12 + 12 T5 tower on the card, a 2 + 2 layer T5 of width ``D`` on the
    CPU; seeded init, seed 0 (the JAX script's ``PRNGKey(0)``)."""
    from .models.nci import NCIDims, NCIT5
    from .models.t5 import T5Dims, T5Model
    from .weights import init_random_
    if on_card:
        t5 = T5Dims(num_layers=12, num_decoder_layers=6, d_model=768,
                    d_kv=64, d_ff=3072, num_heads=12, dropout_rate=0.0,
                    dtype=dt)
        qt5 = dataclasses.replace(t5, num_decoder_layers=12)
    else:
        t5 = T5Dims(vocab_size=512, num_layers=2, num_decoder_layers=2,
                    d_model=D, d_kv=16, d_ff=128, num_heads=4,
                    dropout_rate=0.0)
        qt5 = t5
    nci = NCIT5(NCIDims(t5=t5, kary=KARY, max_output_length=M + 2),
                device=dev, dtype=dt)
    qtower = T5Model(qt5, device=dev, dtype=dt)
    return init_random_(nci, 0), init_random_(qtower, 0)


def cluster_size_stats(cidx_all, C, cap):
    sizes = np.bincount(cidx_all, minlength=C)
    nz = sizes[sizes > 0]
    return {"nonempty": int(len(nz)), "mean": round(float(nz.mean()), 1),
            "p99": int(np.percentile(nz, 99)), "max": int(nz.max()),
            "over_cap": int((nz > cap).sum())}


def hit_metrics(found):
    """(n, k) hits of the gt doc -> (recall over the k, MRR@10)."""
    pos = np.argmax(found, 1)
    hit = found.any(1)
    return (float(hit.mean()),
            float(np.where(hit & (pos < 10), 1.0 / (pos + 1), 0.0).mean()))


def run(NDOC, extras, device="cuda", ckpt=None, dtype="bf16", batch=None,
        nbatch=None, cap=None, bucket_kernel="v3", codebooks=None,
        keep=None):
    """One benchmark run; fills ``extras`` with the line's keys and
    returns (queries/s, baseline queries/s).

    ``codebooks``: RQ codebooks for the random-weight pipeline in place
    of the port's fit (the fit draws from a torch generator, so the JAX
    fit's codebooks give the JAX run's codes).  ``keep``: a dict that
    receives the server and the timed batches, for a caller's checks."""
    from .data import synth
    from .decode.beam import nci_beam_search, nci_beam_search_incremental
    from .eval.searcher import FineIndex, fine_rerank
    from .index.csr import pack_codes, unpack_codes
    from .ops import bucket as Bk
    from .ops import rq as rq_ops
    from .ops.mips import mips_topk
    from .serve import BucketServer
    from .utils.native import build_csr

    dev = resolve_device(device)
    log(f"device: {dev}")
    on_card = dev.type == "cuda"
    if not on_card:
        NDOC = min(NDOC, 20_000)
    if ckpt and codebooks is not None:
        raise ValueError("a bundle brings its own codebooks")
    if ckpt and not bundle_complete(ckpt):
        raise FileNotFoundError(
            f"{ckpt}: incomplete bundle (needs spec.json, tower_params.npz "
            f"and ckpts/nci/leaderboard.json)")
    counters = {"v3": Bk.bucket_scores_v3, "fused": Bk.bucket_scores_fused}

    if ckpt:
        spec = synth.load_spec(osp.join(ckpt, "spec.json"))
        own_corpus = NDOC == spec.ndoc
        if not own_corpus:
            # the trained bundle over a larger corpus of the same family:
            # the query language is compositional, and codes come from
            # the training codebooks
            spec = dataclasses.replace(spec, ndoc=NDOC)
        D, KARY, M, QLEN = spec.d, spec.kary, spec.levels, spec.qlen
    else:
        D = 768 if on_card else 64
        KARY, M, QLEN = 32, 4, 32
        spec = synth.SynthSpec(ndoc=NDOC, d=D, kary=KARY, levels=M, seed=0,
                               qlen=QLEN)
    BATCH = batch or (512 if on_card else 4)
    NBATCH = nbatch or (20 if on_card else 3)
    POOL = 1000 if on_card else 100
    # per-cluster row budget of the fine stage: raising it trades bucket
    # time for fine recall
    CAP = cap or (512 if on_card else 64)
    extras["cap"] = CAP
    dt = torch.bfloat16 if on_card else torch.float32
    corpus_int8 = dtype == "int8"
    extras["ndoc"] = NDOC
    extras["batch"] = BATCH
    extras["pipeline"] = "trained" if ckpt else "cidx_override"
    extras["corpus_dtype"] = ("int8" if corpus_int8
                              else "bf16" if on_card else "f32")

    # ---- dispatch-and-fetch floor -----------------------------------------
    xs = [torch.full((8, 8), float(i), device=dev) for i in range(6)]
    fetch1(xs[0] + 1)
    t0 = time.perf_counter()
    for i in range(5):
        fetch1(xs[i + 1] + 1)
    t_rpc = (time.perf_counter() - t0) / 5
    extras["rpc_floor_ms"] = round(t_rpc * 1e3, 2)
    log(f"rpc floor: {t_rpc * 1e3:.3f} ms")

    # ---- corpus: rows made on the device from small tables ----------------
    host = np.random.default_rng(0)
    t0 = time.time()
    tab = synth.make_tables(spec)
    draws = synth.make_draws(spec)
    fixed_cbs, fixed_shift = codebooks, None
    if ckpt:
        fixed_cbs = np.load(osp.join(ckpt, "codebooks.npy"))
        shift_p = osp.join(ckpt, "prefix_shift.npz")
        if osp.exists(shift_p):
            fixed_shift = synth.load_prefix_shift(shift_p)
    if ckpt and own_corpus:
        # the codes the bundle's NCI was trained on (a re-assign could
        # differ at the last level of a document alone in its prefix,
        # whose centred residual is rounding noise: ops.rq.assign)
        cbs_h, codes = fixed_cbs, np.load(osp.join(ckpt, "codes.npy"))
    else:
        cbs_h, codes = synth.fit_rq_codes(
            spec, tab, draws, codebooks=fixed_cbs, prefix_shift=fixed_shift,
            device=dev)
    log(f"corpus draws + RQ fit + assign: {time.time() - t0:.1f}s")
    cidx_all = pack_codes(codes, KARY).astype(np.int64)
    extras["cluster_sizes"] = cluster_size_stats(cidx_all, KARY ** M, CAP)
    log(f"cluster sizes: {extras['cluster_sizes']}")

    # ---- fine index: CSR + the sorted matrix made on the device -----------
    t0 = time.time()
    offsets, doc_ids = build_csr(codes, KARY)
    q_scale = None
    dt_corp = dt
    if corpus_int8:
        # symmetric global scale from the true maximum over every row
        # (index/build.py:quantize_int8); a sampled maximum could clip
        q_scale = 126.0 / synth.rows_abs_max(tab, draws, device=dev)
        extras["int8_scale"] = round(q_scale, 3)
        dt_corp = torch.int8
    semb = synth.fill_sorted_matrix(spec, tab, draws, doc_ids,
                                    n_pad_rows=CAP + 8, dtype=dt_corp,
                                    q_scale=q_scale, device=dev)
    index = FineIndex(torch.from_numpy(offsets).to(dev),
                      torch.from_numpy(doc_ids).to(dev), semb, M, KARY,
                      host_offsets=offsets, host_doc_ids=doc_ids)
    synchronize(dev)
    log(f"index built on the device: {time.time() - t0:.1f}s")

    # recall-check queries: perturbed documents, from their draws
    nq_r = 64
    rec_ids = host.integers(0, NDOC, nq_r)
    q_base = synth.gen_rows(synth.tables_to(tab, dev),
                            draws[rec_ids]).cpu().numpy()

    t0 = time.time()
    if ckpt:
        from .cli.main import load_config
        from .scripts.quality_full import load_nci, load_tower
        cfg = load_config(osp.join(ckpt, "cfg.json"))
        # the board inside the bundle, wherever the bundle was written
        cfg.ckpt_dir = osp.join(ckpt, "ckpts")
        nci = load_nci(cfg, dev, dt)
        qtower = load_tower(cfg, osp.join(ckpt, "tower_params.npz"), dev, dt)
    else:
        nci, qtower = random_models(D, KARY, M, on_card, dt, dev)
    synchronize(dev)
    log(f"params ready: {time.time() - t0:.1f}s")
    server = BucketServer(qtower, nci, index, num_beams=NBEAM, cap=CAP,
                          pool=POOL, inv_scale=1.0 / q_scale if q_scale
                          else 1.0, bucket_kernel=bucket_kernel, device=dev)

    # ---- the served kernel against its plain version -----------------------
    if on_card:
        g = 64
        cidx_s = torch.from_numpy(
            host.choice(cidx_all, size=g).astype(np.int32)).to(dev)
        q_s = torch.from_numpy(host.normal(size=(g, D)).astype(
            np.float32)).to(dev).to(server.q_dt)
        k_s, k_r = server.bucket(cidx_s, q_s)
        o_s, o_r = Bk.bucket_scores_fused_plain(semb, server.offsets_d,
                                                cidx_s, q_s, CAP)
        if not torch.equal(k_r, o_r):
            raise AssertionError("bucket kernel rows differ from the plain "
                                 "version")
        torch.testing.assert_close(k_s, o_s, rtol=1e-4, atol=1e-3)
        extras["kernel_matches_oracle"] = True
        log("bucket kernel == plain version on a device sample: OK")
    # the served path's launches are counted from here: the check's one
    # launch above is a comparison
    launches0 = {k: f.launches for k, f in counters.items()}

    # ---- recall against exact MIPS (cluster + cap truncation) -------------
    # queries are perturbed documents; two coarse stand-ins: a codebook
    # beam over the query embedding, and the coverage-optimal oracle (the
    # NBEAM clusters holding most of the exact top-100)
    t0 = time.time()
    q_emb = q_base + 0.5 * spec.eps * host.standard_normal(
        (nq_r, D)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    q_dev = torch.from_numpy(q_emb).to(dev).to(dt)
    # pad rows are zero and the true top-100 scores strongly positive, so
    # pads never rank
    _, erows = mips_topk(q_dev, semb, k=100)
    eids_h = doc_ids[np.clip(erows.cpu().numpy(), 0, len(doc_ids) - 1)]

    def cluster_recall(bcodes, key):
        _, fids, _ = fine_rerank(q_dev, torch.as_tensor(bcodes).to(dev),
                                 index.offsets, index.doc_ids, semb, KARY,
                                 CAP, 100)
        fids_h = fids.cpu().numpy()
        rec = np.mean([len(set(fids_h[i][fids_h[i] >= 0])
                           & set(eids_h[i])) / 100.0 for i in range(nq_r)])
        extras[key] = round(float(rec), 4)
        return rec

    shift_dev = (None if fixed_shift is None else
                 [torch.from_numpy(np.asarray(t, np.float32)).to(dev)
                  for t in fixed_shift])
    bcodes, _ = rq_ops.beam_search(
        torch.from_numpy(q_emb).to(dev), torch.from_numpy(cbs_h).to(dev),
        num_beams=NBEAM, dist_mode="l2", prefix_shift=shift_dev)
    rec_b = cluster_recall(bcodes, "recall100_beam_coarse")
    oracle = np.zeros((nq_r, NBEAM, M), np.int32)
    coverage = np.zeros(nq_r)
    for i in range(nq_r):
        cl = cidx_all[eids_h[i]]
        uniq, counts = np.unique(cl, return_counts=True)
        order = np.argsort(-counts)
        top = uniq[order][:NBEAM]
        coverage[i] = counts[order][:NBEAM].sum() / 100.0
        oc = unpack_codes(top.astype(np.int64), M, KARY)
        oracle[i, :len(top)] = oc
        if len(top) < NBEAM:
            oracle[i, len(top):] = oc[-1]
    extras["oracle_cluster_coverage"] = round(float(coverage.mean()), 4)
    rec_o = cluster_recall(oracle, "recall100_oracle_coarse")
    log(f"recall@100 vs exact MIPS: beam-coarse {rec_b:.4f} / "
        f"oracle-coarse {rec_o:.4f} (coverage bound {coverage.mean():.4f}, "
        f"{time.time() - t0:.1f}s)")

    # ---- the trained pipeline's quality (--ckpt) ---------------------------
    if ckpt:
        # dev utterances of sampled (indexed) docs through the whole
        # served path
        n_rq = max(BATCH, 256)
        gt_docs = host.integers(0, NDOC, n_rq)
        tok = synth.query_tokens(spec, draws[gt_docs],
                                 np.random.default_rng(123))
        ids_q = torch.from_numpy(tok.astype(np.int32)).to(dev)
        scores_, ids_, codes_, _, ndoc_ = server.query(
            ids_q, torch.ones_like(ids_q))
        eq = (codes_ == codes[gt_docs][:, None, :]).all(-1)
        extras["trained_coarse_hit@1"] = round(float(eq[:, 0].mean()), 4)
        extras["trained_coarse_hit@10"] = round(float(eq.any(1).mean()), 4)
        r100, mrr = hit_metrics(ids_[:, :100] == gt_docs[:, None])
        extras["trained_fine_recall@100"] = round(r100, 4)
        extras["trained_fine_mrr@10"] = round(hit_metrics(
            ids_ == gt_docs[:, None])[1], 4)
        # beam-major order of the same pool (bucket beam rank, then tower
        # score; eval.searcher.merge_pool)
        cand_codes = codes[np.clip(ids_, 0, None)]
        match_ = (cand_codes[:, :, None, :] == codes_[:, None, :, :]).all(-1)
        crank_ = np.where(match_.any(-1), match_.argmax(-1), NBEAM)
        crank_ = np.where(ids_ >= 0, crank_, NBEAM + 1)
        fsf_ = np.where(ids_ >= 0, scores_.astype(np.float64), 0.0)
        span_ = float(fsf_.max() - fsf_.min()) + 1.0
        bm_ord = np.argsort(crank_.astype(np.float64) * span_ - fsf_,
                            axis=1, kind="stable")
        ids_bm = np.take_along_axis(ids_, bm_ord, 1)
        r100_bm, _ = hit_metrics(ids_bm[:, :100] == gt_docs[:, None])
        extras["trained_fine_recall@100_beam_major"] = round(r100_bm, 4)
        extras["trained_fine_mrr@10_beam_major"] = round(hit_metrics(
            ids_bm == gt_docs[:, None])[1], 4)
        extras["trained_ndoc_per_query"] = round(float(ndoc_.mean()), 1)
        log(f"trained pipeline: coarse hit@10 "
            f"{extras['trained_coarse_hit@10']} fine recall@100 "
            f"{extras['trained_fine_recall@100']}")

    # ---- cold start ---------------------------------------------------------
    ids = torch.ones((BATCH, QLEN), dtype=torch.int32, device=dev)
    mask = torch.ones((BATCH, QLEN), dtype=torch.int32, device=dev)
    t0 = time.time()
    server.query(ids, mask)
    extras["cold_start_s"] = round(time.time() - t0, 1)
    log(f"first served batch: {extras['cold_start_s']}s")

    # ---- throughput ---------------------------------------------------------
    g = BATCH * NBEAM
    batches, ndoc_seen = [], []
    for i in range(NBATCH):
        if ckpt:
            # real token queries; the beam's own codes feed the bucket
            docs_i = host.integers(0, NDOC, BATCH)
            ids_i = torch.from_numpy(synth.query_tokens(
                spec, draws[docs_i], np.random.default_rng(1000 + i)
            ).astype(np.int32)).to(dev)
            batches.append((ids_i, mask, None))
        else:
            # a random beam's codes land in empty clusters; doc-weighted
            # clusters of the real (skewed) corpus drive the bucket stage
            # while the tower and the beam still run in full
            ids_i = torch.full((BATCH, QLEN), 1 + (i % 7), dtype=torch.int32,
                               device=dev)
            ci = cidx_all[host.integers(0, NDOC, size=g)]
            ndoc_seen.append((offsets[ci + 1] - offsets[ci])
                             .reshape(BATCH, NBEAM).sum(-1).mean())
            batches.append((ids_i, mask, torch.from_numpy(
                ci.astype(np.int32)).to(dev)))
    synchronize(dev)
    t0 = time.time()
    handles = [server.query_device(i, m, c) for i, m, c in batches]
    results = [server.finalize(h) for h in handles]
    dt_pipe = time.time() - t0
    qps = BATCH * NBATCH / dt_pipe
    log(f"{NBATCH} pipelined batches x {BATCH} queries in {dt_pipe:.3f}s "
        f"-> {qps:.1f} q/s")
    extras["ndoc_per_query"] = round(float(
        np.mean(ndoc_seen) if ndoc_seen else
        np.mean([r[4].mean() for r in results])), 1)

    n_seq = max(NBATCH // 2, 1)
    t0 = time.time()
    for i, m, c in batches[:n_seq]:
        server.finalize(server.query_device(i, m, c))
    extras["sequential_qps"] = round(BATCH * n_seq / (time.time() - t0), 1)

    # ---- the reference-style baseline on the same card --------------------
    # eval_batch_size 2, a cache-less beam (generation_utils.py:763
    # use_cache=False), the codes through the host between coarse and fine
    # (main_models.py:3915-), then the plain fine re-rank
    B_REF = 2
    ids2 = torch.ones((B_REF, QLEN), dtype=torch.int32, device=dev)
    mask2 = torch.ones((B_REF, QLEN), dtype=torch.int32, device=dev)

    @torch.inference_mode()
    def ref_serve_batch(ids_b, mask_b):
        codes_b = nci_beam_search(nci, ids_b, mask_b, NBEAM)[0]
        codes_h = codes_b.cpu().numpy()                 # the host hop
        qe = qtower.first_token_rep(ids_b, mask_b)
        if not ckpt:
            codes_h = unpack_codes(
                cidx_all[host.integers(0, NDOC, size=B_REF * NBEAM)],
                M, KARY).reshape(B_REF, NBEAM, M)
        _, fids, _ = fine_rerank(qe, torch.from_numpy(codes_h).to(dev),
                                 index.offsets, index.doc_ids, semb, KARY,
                                 CAP, POOL)
        return fids[:, :1].cpu().numpy()

    ref_serve_batch(ids2, mask2)
    n_ref = 6
    t0 = time.perf_counter()
    for _ in range(n_ref):
        ref_serve_batch(ids2, mask2)
    baseline_qps = B_REF * n_ref / (time.perf_counter() - t0)
    extras["baseline_qps_measured"] = round(baseline_qps, 1)
    extras["baseline_def"] = ("reference-style loop on the same card: batch "
                              "2, cache-less panel beam, host hop, plain "
                              "fine re-rank")
    log(f"measured reference-style baseline: {baseline_qps:.1f} q/s")

    # ---- one small batch's latency -----------------------------------------
    B_LAT = 8
    ids8 = torch.full((B_LAT, QLEN), 3, dtype=torch.int32, device=dev)
    mask8 = torch.ones((B_LAT, QLEN), dtype=torch.int32, device=dev)
    server.query(ids8, mask8)
    t0 = time.perf_counter()
    for _ in range(5):
        server.query(ids8, mask8)
    extras["latency_b8_ms"] = round((time.perf_counter() - t0) / 5 * 1e3, 1)

    # ---- stage split, each call synchronized -------------------------------
    def timed(fn, n=5):
        fn(0)
        synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i + 1)
            synchronize(dev)
        return (time.perf_counter() - t0) / n

    @torch.inference_mode()
    def qenc_fn(i):
        return qtower.first_token_rep(batches[i % NBATCH][0], mask)

    def beam_fn(i):
        return nci_beam_search_incremental(
            nci, batches[i % NBATCH][0], mask, NBEAM,
            level_tables=server.level_tables)[0]

    _, _, cidx0, q_rep0 = server.coarse(batches[0][0], mask)
    cidx_b = batches[0][2] if batches[0][2] is not None else cidx0

    def bucket_fn(i):
        return server.bucket(cidx_b, q_rep0)[0]

    stage = {"qenc_ms": round(timed(qenc_fn) * 1e3, 1),
             "beam_ms": round(timed(beam_fn) * 1e3, 1),
             "bucket_ms": round(timed(bucket_fn) * 1e3, 1),
             "rpc_floor_ms": extras["rpc_floor_ms"]}
    if on_card:
        # device ms from a torch.profiler trace (CUDA kernels only);
        # FLOPs of the matrix products FlopCounterMode counts
        from .utils import profiling as P
        for name, fn in (("qenc", qenc_fn), ("beam", beam_fn)):
            tr = P.traced_stage_seconds(fn, n=3, device=dev)
            stage[f"{name}_device_ms"] = round(tr.device_s * 1e3, 1)
            stage[f"{name}_mfu_pct"] = round(
                P.flops_of(fn, 0) / max(tr.device_s, 1e-9)
                / P.H100_SXM_BF16_DENSE_FLOPS * 100, 1)
    extras["stages"] = stage
    log(f"stages: {stage}")
    extras["bucket_launches"] = {k: f.launches - launches0[k]
                                 for k, f in counters.items()}
    if keep is not None:
        keep.update(server=server, batches=batches)
    return qps, baseline_qps


def result_line(qps, baseline_qps, extras):
    """The JSON line of a run (the JAX child's line)."""
    return {"metric": "serving_queries_per_sec_per_chip",
            "value": round(qps, 2), "unit": "queries/s/chip",
            "vs_baseline": round(qps / baseline_qps, 3), **extras}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ndoc", type=int, default=8_841_823)
    ap.add_argument("--ckpt", default=None,
                    help="a quality_full bundle: the trained pipeline")
    ap.add_argument("--dtype", choices=["bf16", "int8"], default="bf16",
                    help="corpus precision")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--nbatch", type=int, default=None)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--bucket_kernel", choices=["v3", "fused"],
                    default="v3")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    extras = {}
    qps, baseline_qps = run(args.ndoc, extras, device=args.device,
                            ckpt=args.ckpt, dtype=args.dtype,
                            batch=args.batch, nbatch=args.nbatch,
                            cap=args.cap, bucket_kernel=args.bucket_kernel)
    line = result_line(qps, baseline_qps, extras)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
