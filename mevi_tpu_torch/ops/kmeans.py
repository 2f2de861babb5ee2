"""Batched k-means on the device (port of ``mevi_tpu.ops.kmeans``).

Full-batch Lloyd iterations replace the reference's rank-0 CPU
MiniBatchKMeans (``MEVI/pq.py:550-598``):

* assign: one (chunk, d) x (d, K) product per row chunk + argmax,
* update: a one-hot (K, chunk) x (chunk, d) product per chunk,
* k-means++ seeding by D² sampling (greedy over a few candidates),
* empty clusters restart from a contiguous random slice of rows.

Products accumulate and return float32 whatever the input type, as the
JAX package's ``preferred_element_type=float32``: each chunk is upcast
first (products of bf16 values are exact in float32).  Float32 products
need TF32 off, PyTorch's default (``Precision.HIGHEST`` in JAX).
Random draws come from an explicit ``torch.Generator`` on the data's
device; they keep the JAX draws' semantics but not their values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import as_device_tensor, resolve_device


def _sim(x: torch.Tensor, c: torch.Tensor, dist_mode: str) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) float32 similarity; higher = closer.

    'ip': inner product; 'l2': -||x-c||^2 expanded as 2 x.c - ||c||^2
    (- ||x||^2 dropped: constant per row, argmax unchanged)."""
    cf = c.float()
    ip = x.float() @ cf.T
    if dist_mode == "ip":
        return ip
    return 2.0 * ip - cf.square().sum(-1)[None, :]


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  dist_mode: str = "l2", chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment, chunked over rows.  int32 (n,)."""
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    for s in range(0, n, chunk):
        out[s:s + chunk] = _sim(x[s:s + chunk], centroids,
                                dist_mode).argmax(-1)
    return out


def kmeans_stats(x: torch.Tensor, assign: torch.Tensor, k: int,
                 chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (sums (k, d) f32, counts (k,) f32) via one-hot
    products, chunked."""
    n, d = x.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        onehot = torch.nn.functional.one_hot(
            assign[s:s + chunk].long(), k).float()            # (c, k)
        sums += onehot.T @ x[s:s + chunk].float()
        counts += onehot.sum(0)
    return sums, counts


def kmeans_plusplus_init(x: torch.Tensor, k: int,
                         generator: torch.Generator, dist_mode: str = "l2",
                         candidates: int = 8) -> torch.Tensor:
    """k-means++ seeding with D² sampling (sklearn-style, greedy over
    ``candidates`` draws per round).  O(k · n · d): fine for k <= 256.
    Seeds by squared L2 distance in both ``dist_mode``s, as the JAX
    package does.  Candidate rows are gathered directly (the JAX
    package's one-hot product selects the same rows)."""
    n, d = x.shape
    xf = x.float()
    first = xf[torch.randint(0, n, (1,), generator=generator,
                             device=x.device)]
    centroids = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centroids[0] = first[0]
    d2 = (xf - first).square().sum(-1)
    for i in range(1, k):
        # sample candidates ∝ d2, keep the one that lowers the total
        # potential most
        idx = torch.multinomial(d2.clamp_min(1e-20), candidates,
                                replacement=True, generator=generator)
        cand = xf[idx]                                        # (c, d)
        cand_d2 = torch.stack([torch.minimum((xf - cand[j]).square().sum(-1),
                                             d2)
                               for j in range(candidates)])   # (c, n)
        best = cand_d2.sum(-1).argmin()
        centroids[i] = cand[best]
        d2 = cand_d2[best]
    return centroids.to(x.dtype)


def kmeans_fit(x, k: int, iters: int = 25,
               generator: Optional[torch.Generator] = None,
               dist_mode: str = "l2", chunk: int = 65536,
               init_centroids=None, init_sample: int = 262144,
               stats: Optional[dict] = None, device="cuda",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-batch Lloyd k-means.  Returns (centroids (k, d) in x's
    dtype, assign (n,) int32).

    k-means++ runs on a subsample of 8 contiguous random chunks of
    ``init_sample`` rows in all, then Lloyd runs on every row.  An empty
    cluster restarts at a row of a contiguous random slice of k rows.
    ``stats``, when given, receives ``lloyd_iters`` and ``restarts``
    (empty clusters restarted, summed over iterations).
    """
    dev = resolve_device(device)
    x = as_device_tensor(x, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n = x.shape[0]
    if n < k:
        raise ValueError(f"k-means of {n} rows into {k} clusters")
    if init_centroids is None:
        if n > init_sample:
            n_chunks = 8
            clen = init_sample // n_chunks
            starts = torch.randint(0, n - clen, (n_chunks,),
                                   generator=generator, device=dev).tolist()
            seed_x = torch.cat([x[s:s + clen] for s in starts])
        else:
            seed_x = x
        centroids = kmeans_plusplus_init(seed_x, k, generator, dist_mode)
    else:
        centroids = as_device_tensor(init_centroids, dev)
    restarts = torch.zeros((), dtype=torch.int64, device=dev)
    span = torch.arange(k, device=dev)
    for _ in range(iters):
        assign = kmeans_assign(x, centroids, dist_mode, chunk)
        sums, counts = kmeans_stats(x, assign, k, chunk)
        new = sums / counts.clamp_min(1.0)[:, None]
        start = torch.randint(0, max(n - k, 1), (1,), generator=generator,
                              device=dev)
        empty = counts < 0.5
        new = torch.where(empty[:, None], x[start + span].float(), new)
        restarts += empty.sum()
        centroids = new.to(x.dtype)
    if stats is not None:
        stats.update(lloyd_iters=iters, restarts=int(restarts))
    return centroids, kmeans_assign(x, centroids, dist_mode, chunk)
