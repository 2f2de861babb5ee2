"""The multi-device dry run (counterpart of ``__graft_entry__.
dryrun_multichip``): one data-parallel NCI training step, the
corpus-sharded retrieval collectives (``sharded_mips_topk``,
``sharded_fine_rerank``), the sharded server and one EMA joint step, at
the JAX dry run's tiny shapes, in ``world`` ranks of one host.

    python -m mevi_tpu_torch.parallel.dryrun --world 4 --corpus 2 \\
        --device cpu|cuda|cuda:0 [--backend gloo|nccl]

``--device cuda`` puts rank r on ``cuda:r``; ``cuda:0`` puts every rank on
one card (over gloo: NCCL refuses two ranks on one card).  Rank 0
prints ``dryrun_multichip OK on 4 ranks (mesh data=2 corpus=2, ...)``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import TrainConfig
from ..eval.searcher import build_fine_index, sharded_fine_rerank
from ..models.nci import NCIDims, NCIT5
from ..models.t5 import T5Dims, T5Model
from ..models.twin_tower import Tower
from ..ops import rq as rq_ops
from ..ops.mips import sharded_mips_topk
from ..serve import ShardedBucketServer
from ..train import joint as J
from ..train import trainer as T
from ..weights import flax_names, init_random_
from .mesh import data_slice, launch_local, make_mesh, shard_rows

KARY, M = 8, 3


def dryrun_rank(device, corpus: int):
    """One rank's dry run; returns (NCI step loss, joint step loss)."""
    mesh = make_mesh(corpus=corpus, device=device)
    dev = mesh.device
    t5 = T5Dims(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                num_layers=2, num_decoder_layers=2, dropout_rate=0.0)
    dims = NCIDims(t5=t5, kary=KARY, max_output_length=M + 2,
                   adaptor_layer_num=1, adaptor_num_heads=4, adaptor_d_ff=64)
    # the same seeded weights on every rank
    model = init_random_(NCIT5(dims, device=dev), 0)

    # ---- data-parallel NCI step: 4 rows a data rank --------------------
    batch = 4 * mesh.data
    ids = np.ones((batch, 16), np.int32)
    codes = np.tile(np.arange(M, dtype=np.int32), (batch, 1)) % KARY
    local = {"query_ids": data_slice(ids, mesh),
             "query_mask": data_slice(ids, mesh),
             "codes": data_slice(codes, mesh)}
    opt = T.make_optimizer(TrainConfig(warmup_steps=1), model, total_steps=10)
    state = T.init_state(model, opt)
    state, metrics = T.make_nci_train_step(model, mesh=mesh)(state, local)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"NCI step loss {loss}")

    # ---- corpus-sharded retrieval --------------------------------------
    rng = np.random.default_rng(0)
    nd, d = 64 * corpus, 32
    emb = rng.normal(size=(nd, d)).astype(np.float32)
    queries = torch.from_numpy(data_slice(
        rng.normal(size=(batch, d)).astype(np.float32), mesh)).to(dev)
    scores, _ = sharded_mips_topk(queries, shard_rows(emb, mesh), 8, mesh,
                                  n_rows=nd, chunk=32)
    if not torch.isfinite(scores).all():
        raise AssertionError("sharded_mips_topk: non-finite scores")
    doc_codes = rng.integers(0, KARY, size=(nd, M)).astype(np.int32)
    fine = build_fine_index(doc_codes, emb, KARY, device=dev)
    fine = fine._replace(sorted_emb=shard_rows(fine.sorted_emb, mesh))
    beams = torch.from_numpy(data_slice(
        rng.integers(0, KARY, size=(batch, 3, M)).astype(np.int32),
        mesh)).to(dev)
    _, fi, _ = sharded_fine_rerank(queries, beams, fine, mesh, cap=16,
                                   pool=8, device=dev)
    if fi.shape != (batch // mesh.data, 8):
        raise AssertionError(f"sharded_fine_rerank: ids {tuple(fi.shape)}")

    # ---- sharded server ------------------------------------------------
    qtower = init_random_(T5Model(t5, device=dev), 1)
    server = ShardedBucketServer(qtower, model, mesh, fine, num_beams=3,
                                 cap=16, pool=8)
    qi = torch.from_numpy(local["query_ids"]).to(dev)
    _, si, _, sb = server(qi, qi)
    if si.shape != (batch // mesh.data, 8) or not torch.isfinite(sb).all():
        raise AssertionError("sharded server: bad outputs")

    # ---- EMA joint step (NCI + tower + codebooks) ----------------------
    codebooks = torch.from_numpy(
        rng.normal(size=(M, KARY, t5.d_model)).astype(np.float32)).to(dev)
    jmodel = J.JointModel(model, Tower("t5", qtower), codebooks)
    labels = J.joint_param_labels(flax_names(jmodel).values())
    labels["codebooks"] = "frozen"
    jopt = T.make_optimizer(TrainConfig(warmup_steps=1), jmodel,
                            total_steps=10, labels=labels)
    jbatch = dict(local, pos_doc_ids=local["query_ids"],
                  pos_doc_mask=local["query_mask"])
    jstep = J.make_joint_train_step_ema(
        jmodel, J.JointStepConfig(pq_loss="label"), mesh=mesh)
    _, _, jm = jstep(T.init_state(jmodel, jopt), rq_ops.ema_init(codebooks),
                     jbatch, torch.Generator().manual_seed(2))
    joint = float(jm["loss"])
    if not np.isfinite(joint):
        raise AssertionError(f"joint step loss {joint}")
    return loss, joint


def dryrun(world: int, corpus: int, device: str = "cuda",
           backend: str = "gloo") -> str:
    """Run the dry run in ``world`` local ranks; returns rank 0's line."""
    if world % corpus:
        raise ValueError(f"corpus={corpus} does not divide world={world}")
    loss, joint = launch_local(dryrun_rank, world, backend, device,
                               corpus)[0]
    return (f"dryrun_multichip OK on {world} ranks (mesh data="
            f"{world // corpus} corpus={corpus}, loss={loss:.4f}, "
            f"joint_loss={joint:.4f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--corpus", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    print(dryrun(args.world, args.corpus, args.device, args.backend),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
