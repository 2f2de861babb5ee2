"""Hierarchical k-means document ids, the non-RQ NCI id space (port of
``mevi_tpu.index.hierarchical``).

* :func:`hierarchical_kmeans_ids` builds the ids with the NCI scheme:
  recursively split into ``k`` clusters (``ops.kmeans`` on the device)
  until a node holds <= ``c`` docs, then append each doc's position
  within its leaf;
* :func:`prefix_cluster_docs` mirrors ``prepare_clus``
  (``dataprocess/msmarco_passage/prepare_origin.py:12-28``): for a layer
  ``l``, every id prefix up to length ``l`` maps to the docs below it,
  docs whose full id is a strict prefix of the key appended last;
* the ids feed :func:`mevi_tpu_torch.decode.trie.build_trie`.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from ..decode.trie import build_trie
from ..ops.kmeans import kmeans_fit


def hierarchical_kmeans_ids(emb, k: int = 30, c: int = 30, seed: int = 42,
                            iters: int = 10, device="cuda",
                            ) -> List[List[int]]:
    """Variable-length hierarchical ids (NCI ``k{k}_c{c}`` scheme), codes
    in [0, max(k, c)).  ``emb`` (n, d), an array or a tensor, is held on
    ``device`` in float32; one generator seeded with ``seed`` draws every
    node's k-means in turn."""
    dev = resolve_device(device)
    x_all = as_device_tensor(emb, dev).float()
    n = x_all.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids: List[List[int]] = [[] for _ in range(n)]
    stack: List[Tuple[np.ndarray, List[int]]] = [
        (np.arange(n, dtype=np.int64), [])]
    while stack:
        rows, prefix = stack.pop()
        if len(rows) <= c:
            for pos, r in enumerate(rows):
                ids[int(r)] = prefix + [pos]
            continue
        x = x_all[torch.from_numpy(rows).to(dev)]
        _, assign = kmeans_fit(x, k, iters=iters, generator=gen, device=dev)
        assign = assign.cpu().numpy()
        for ci in range(k):
            members = rows[assign == ci]
            if len(members):
                stack.append((members, prefix + [ci]))
    return ids


def prefix_cluster_docs(ids: Sequence[Sequence[int]], layer: int,
                        ) -> Dict[Tuple[int, ...], List[int]]:
    """``prepare_clus`` semantics for one layer: every prefix key
    (length <= layer) maps to the docs whose id starts with it; a doc
    whose full id equals a strict prefix of another key is appended to
    that key's list."""
    full: Dict[Tuple[int, ...], int] = {}
    cluster: Dict[Tuple[int, ...], List[int]] = defaultdict(list)
    for d, seq in enumerate(ids):
        key = tuple(seq)[:layer]
        cluster[key].append(d)
        full[tuple(seq)] = d
    out: Dict[Tuple[int, ...], List[int]] = defaultdict(list)
    for key, docs in cluster.items():
        for j in range(1, len(key) + 1):
            out[key[:j]].extend(docs)
            if j != len(key) and key[:j] in full:
                out[key].append(full[key[:j]])
    for key, docs in out.items():
        if len(set(docs)) != len(docs):
            raise ValueError(f"prefix {key} lists a doc twice")
    return dict(out)


def ids_to_padded(ids: Sequence[Sequence[int]],
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(codes (n, max_len) int32 padded with -1, lengths (n,) int32)."""
    n = len(ids)
    lens = np.asarray([len(s) for s in ids], np.int32)
    out = np.full((n, int(lens.max())), -1, np.int32)
    for i, s in enumerate(ids):
        out[i, :len(s)] = s
    return out, lens


def save_hier_artifacts(output_dir: str, ids: Sequence[Sequence[int]],
                        layers: Sequence[int], kary: int) -> None:
    """Write the reference-shaped pickles and the trie tables."""
    os.makedirs(output_dir, exist_ok=True)
    codes, lens = ids_to_padded(ids)
    np.save(osp.join(output_dir, "hier_codes.npy"), codes)
    np.save(osp.join(output_dir, "hier_lengths.npy"), lens)
    child, terminal = build_trie(ids, kary)
    np.savez(osp.join(output_dir, "hier_trie.npz"), child=child,
             terminal=terminal)
    for layer in layers:
        mapping = prefix_cluster_docs(ids, layer)
        with open(osp.join(output_dir,
                           f"doc_cluster_layer{layer}.pkl"), "wb") as fw:
            pickle.dump({k: [str(d) for d in v]
                         for k, v in mapping.items()}, fw)
