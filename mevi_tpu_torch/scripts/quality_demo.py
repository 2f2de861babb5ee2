"""End-to-end retrieval quality on synthetic data (port of
``scripts/quality_demo.py``): train the NCI seq2seq model and show the
constrained beam retrieving the right clusters through the serving path.

    python -m mevi_tpu_torch.scripts.quality_demo [--device cuda|cpu]

Pipeline, on ``--device``:
  1. a 3-level shared-sons corpus with leaf noise, unit-norm rows; RQ
     4 x 32 fitted (``ops.rq.rq_train``, 8 iterations) -> CSR fine index;
  2. queries name their document through 7 scattered info tokens (the
     doc's hierarchy labels and id digits, hashed into per-slot
     vocabularies) among fresh random fillers; train pairs for 100,000
     documents, 512 dev utterances of trained documents with fresh
     fillers and a perturbed document embedding;
  3. the NCI (T5 + PAWA, compact logits) trained on tokens -> RQ code
     (``train.trainer``, AdamW lr 3e-4, 100 warm-up steps);
  4. the tree-constrained beam of 10 -> coarse hit@1 / hit@10 on the dev
     set, then the in-cluster fine re-rank with the true embeddings ->
     recall@10.

Prints one JSON line (the JAX line's keys).  Every host draw comes from
one ``np.random.default_rng(0)`` in the JAX script's order, so corpus,
tokens and draws equal the JAX script's; the RQ fit and the initial
weights draw from torch generators (seeds 1 and 0), or are given
(``codebooks=``, ``init_params=``).  On the card: 200,000 documents,
d 768, NCI 6 + 3 at d_model 512, 8 heads, PAWA 2 layers, batch 256,
float32; on the CPU the JAX script's CPU branch (5,000 documents, d 64,
2 + 2 at d 64, batch 32, 60 steps).  Knobs: ``DEMO_NDOC``,
``DEMO_NTRAIN``, ``DEMO_STEPS`` (default 4,000 on the card).
``DEMO_FORCE_CPU`` is not read: ``--device cpu`` takes its place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device, synchronize

KARY, M = 32, 4
QLEN, NBEAM, CAP = 24, 10, 256
VOCAB = 2 + QLEN * KARY          # per-position projection buckets
SCALES = (1.0, 0.42, 0.18)
EPS = 0.06
N_INFO = 7
N_DEV = 512


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def geometry(on_card: bool):
    """(ndoc, ntrain, steps, batch, d) of the JAX script's branch."""
    ndoc = int(os.environ.get("DEMO_NDOC", 200_000 if on_card else 5_000))
    ntrain = int(os.environ.get("DEMO_NTRAIN",
                                100_000 if on_card else 2_000))
    steps = int(os.environ.get("DEMO_STEPS", 4000 if on_card else 60))
    return ndoc, ntrain, steps, (256 if on_card else 32), \
        (768 if on_card else 64)


class Language:
    """The query language of one corpus draw: info slots, salts and the
    documents' hierarchy labels."""

    def __init__(self, lv_lab, info_pos, salt):
        self.lv_lab, self.info_pos, self.salt = lv_lab, info_pos, salt

    def tokens(self, docs, rng):
        """(n, QLEN) int32 utterances of ``docs``: fresh fillers from
        ``rng``, the info slots set."""
        n = len(docs)
        tok = rng.integers(2, VOCAB, size=(n, QLEN)).astype(np.int32)
        lab = self.lv_lab
        info = np.stack([lab[0][docs], lab[1][docs], lab[2][docs],
                         docs % KARY, (docs // KARY) % KARY,
                         (docs // KARY ** 2) % KARY,
                         (docs // KARY ** 3) % KARY])
        for j, p in enumerate(self.info_pos):
            tok[:, p] = 2 + int(p) * KARY + (info[j] * self.salt[j]) % KARY
        return tok


def make_corpus(host, ndoc, d):
    """(unit rows (ndoc, d) float32, hierarchy labels): the JAX script's
    draws from ``host``, in its order."""
    lv_ctrs = [host.normal(size=(KARY, d)).astype(np.float32) * s
               for s in SCALES]
    lv_lab = [host.integers(0, KARY, ndoc) for _ in SCALES]
    emb = sum(c[l] for c, l in zip(lv_ctrs, lv_lab)) \
        + EPS * host.standard_normal((ndoc, d)).astype(np.float32)
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    return emb, lv_lab


def make_draws(host, emb, lv_lab, ntrain):
    """The query language and the train / dev draws, in the JAX script's
    order: (language, train docs, dev docs, dev tokens, dev vectors)."""
    d = emb.shape[1]
    lang = Language(lv_lab, host.choice(QLEN, size=N_INFO, replace=False),
                    host.integers(1, 1 << 30, size=N_INFO))
    train_docs = host.integers(0, len(emb), ntrain)
    dev_docs = train_docs[host.integers(0, ntrain, N_DEV)]
    q_dev = lang.tokens(dev_docs, host)
    dev_vecs = emb[dev_docs] + 0.5 * EPS * host.standard_normal(
        (N_DEV, d)).astype(np.float32)
    dev_vecs /= np.linalg.norm(dev_vecs, axis=1, keepdims=True)
    return lang, train_docs, dev_docs, q_dev, dev_vecs


def nci_dims(on_card: bool):
    from ..models.nci import NCIDims
    from ..models.t5 import T5Dims
    if on_card:
        t5 = T5Dims(vocab_size=VOCAB, num_layers=6, num_decoder_layers=3,
                    d_model=512, d_kv=64, d_ff=2048, num_heads=8,
                    dropout_rate=0.0)
        adaptor = dict(adaptor_layer_num=2, adaptor_num_heads=8)
    else:
        t5 = T5Dims(vocab_size=VOCAB, num_layers=2, num_decoder_layers=2,
                    d_model=64, d_kv=16, d_ff=128, num_heads=4,
                    dropout_rate=0.0)
        adaptor = dict(adaptor_layer_num=1, adaptor_num_heads=4)
    return NCIDims(t5=t5, kary=KARY, max_output_length=M + 2, **adaptor)


def run(device="cuda", codebooks=None, init_params=None, keep=None):
    """The demo; returns its line.  ``codebooks``: the RQ (M, K, d) to
    assign with (fitted when None); ``init_params``: flattened flax
    parameters of the NCI's initial weights (seeded when None); ``keep``:
    a dict that receives the corpus, codes, the first train batch, the
    dev tokens and the dev beam codes."""
    from ..config import TrainConfig
    from ..decode.beam import nci_beam_search_incremental
    from ..eval.searcher import build_fine_index, fine_rerank
    from ..models.nci import NCIT5
    from ..ops import rq as rq_ops
    from ..train import trainer as T
    from ..weights import init_random_, load_flax_params

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    ndoc, ntrain, steps, batch, d = geometry(on_card)
    host = np.random.default_rng(0)
    t0 = time.time()
    emb, lv_lab = make_corpus(host, ndoc, d)
    log(f"corpus {ndoc}x{d}: {time.time() - t0:.1f}s")

    t0 = time.time()
    emb_d = torch.from_numpy(emb).to(dev)
    if codebooks is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        cbs = rq_ops.rq_train(emb_d[:min(ndoc, 300_000)], levels=M, kary=KARY,
                              iters=8, generator=gen, device=dev)[0]
    else:
        cbs = torch.tensor(np.asarray(codebooks, np.float32), device=dev)
    codes = rq_ops.assign(emb_d, cbs, "rq", "l2").cpu().numpy()
    fine = build_fine_index(codes, emb_d, KARY, device=dev)
    synchronize(dev)
    log(f"RQ fit+assign+index: {time.time() - t0:.1f}s")

    lang, train_docs, dev_docs, q_dev, dev_vecs = make_draws(
        host, emb, lv_lab, ntrain)
    y_train = codes[train_docs]
    keep = {} if keep is None else keep
    keep.update(emb=emb, codes=codes, q_dev=q_dev)

    model = NCIT5(nci_dims(on_card), device=dev)
    if init_params is None:
        init_random_(model, 0)
    else:
        load_flax_params(model, init_params)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=100,
                       train_batch_size=batch)
    state = T.init_state(model, T.make_optimizer(tcfg, model,
                                                 total_steps=steps))
    step = T.make_nci_train_step(model, T.NCIStepConfig())
    mask = torch.ones((batch, QLEN), dtype=torch.int32, device=dev)
    t0 = time.time()
    loss0 = loss = None
    for i in range(steps):
        sel = host.integers(0, ntrain, batch)
        # fresh fillers an utterance: the model can key only on the info
        # tokens (whole-sequence memorization scores zero on dev)
        b = {"query_ids": torch.from_numpy(
                 lang.tokens(train_docs[sel], host)).to(dev),
             "query_mask": mask,
             "codes": torch.from_numpy(y_train[sel]).to(dev)}
        state, metrics = step(state, b)
        if i == 0:
            loss0 = float(metrics["loss"])
            keep["first_batch"] = {k: v.cpu().numpy() for k, v in b.items()}
        if (i + 1) % max(steps // 10, 1) == 0:
            loss = float(metrics["loss"])
            log(f"step {i + 1}/{steps} loss {loss:.4f}")
    synchronize(dev)
    train_s = time.time() - t0
    log(f"trained {steps} steps x {batch}: {train_s:.1f}s "
        f"({steps * batch / train_s:.0f} ex/s)")

    model.eval()
    with torch.inference_mode():
        ids = torch.from_numpy(q_dev).to(dev)
        codes_dev, _, _ = nci_beam_search_incremental(
            model, ids, torch.ones_like(ids), NBEAM)
        codes_dev = codes_dev.cpu().numpy()
        keep["codes_dev"] = codes_dev
        gt = codes[dev_docs]
        hit1 = float(np.mean((codes_dev[:, 0, :] == gt).all(-1)))
        hit10 = float(np.mean([(codes_dev[i] == gt[i]).all(-1).any()
                               for i in range(N_DEV)]))
        _, fids, _ = fine_rerank(
            torch.from_numpy(dev_vecs).to(dev, fine.sorted_emb.dtype),
            torch.from_numpy(codes_dev).to(dev), fine.offsets, fine.doc_ids,
            fine.sorted_emb, KARY, CAP, 10)
    fids = fids.cpu().numpy()
    rec10 = float(np.mean([dev_docs[i] in set(fids[i].tolist())
                           for i in range(N_DEV)]))
    return {"coarse_hit@1": round(hit1, 4), "coarse_hit@10": round(hit10, 4),
            "fine_recall@10": round(rec10, 4), "steps": steps,
            "batch": batch,
            "examples_per_s": round(steps * batch / train_s, 1),
            "loss_first": round(loss0, 4), "loss_last": round(loss, 4),
            "ndoc": ndoc, "n_train": ntrain}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
