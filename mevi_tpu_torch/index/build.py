"""End-to-end index build: embed corpus -> train RQ -> CSR fine index
(port of ``mevi_tpu.index.build``; the mesh-sharded representation
function comes with slice E).

* ``embed_corpus`` == ``gen_doc_embedding`` (``main_models.py:3077-3180``):
  batched encoder forwards into one host array;
* ``build_rq_index`` == ``pq.initialize`` + ``gen_pq_doc_cluster``
  (``pq.py:440-486``, ``main_models.py:3182-3220``): k-means per residual
  level on the device, then the CSR layout and the cluster-sorted
  serving matrix, gathered on the device;
* ``doc_topk_codes`` == ``gen_pq_doc_topk`` (``main_models.py:3222-3270``)
  by the codebook beam search;
* ``reconstruct_leaf_centroids``: the lazy ``gen_all_reconstruct``
  (3272-3309).

Artifacts go through :class:`~mevi_tpu_torch.train.checkpoints.ArtifactCache`
under the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from ..config import MEVIConfig
from ..eval.searcher import FineIndex, build_fine_index
from ..index.csr import unpack_codes
from ..ops import rq as rq_ops
from ..parallel.mesh import data_slice, gather_rows, pad_to
from ..train.checkpoints import ArtifactCache

_CHUNK = 1 << 20


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (bf16, which numpy lacks, as float32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def embed_corpus(
    rep_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    tokens: np.ndarray,
    masks: np.ndarray,
    batch_size: int = 1024,
    out_dtype=np.float32,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cuda",
) -> np.ndarray:
    """Embed a tokenized corpus with a representation function
    ``rep_fn(ids, mask) -> (b, d)`` on ``device`` (such as
    ``T5Model.first_token_rep``); ids and masks travel as int32.  The
    last batch is ragged (the JAX package pads it to one static shape)."""
    dev = resolve_device(device)
    n = len(tokens)
    out = None
    for s in range(0, n, batch_size):
        ids = np.asarray(tokens[s:s + batch_size], np.int32)
        mk = np.asarray(masks[s:s + batch_size], np.int32)
        with torch.inference_mode():
            emb = _host(rep_fn(torch.from_numpy(ids).to(dev),
                               torch.from_numpy(mk).to(dev)))
        if out is None:
            out = np.empty((n, emb.shape[-1]), out_dtype)
        out[s:s + len(ids)] = emb
        if progress:
            progress(s + len(ids), n)
    return out


def make_sharded_rep_fn(rep_fn, mesh):
    """``rep_fn`` over the mesh's data axis (multi-device corpus
    embedding): every rank is called with the same batch, encodes its
    data slice of it and gets the whole batch's reps back by an
    all-gather over the data group.  A batch that does not divide
    ``data`` is padded (repeating its last row) and trimmed after.
    ``embed_corpus(..., rep_fn=...)`` takes it as it takes ``rep_fn``."""
    def f(ids, mask):
        n = ids.shape[0]
        pad = pad_to(n, mesh.data) - n
        if pad:
            ids = torch.cat([ids, ids[-1:].expand(pad, -1)])
            mask = torch.cat([mask, mask[-1:].expand(pad, -1)])
        reps = rep_fn(data_slice(ids, mesh), data_slice(mask, mesh))
        return gather_rows(reps.contiguous(), mesh)[:n]
    return f


@dataclasses.dataclass
class RQIndexArtifacts:
    codebooks: np.ndarray     # (M, K, d)
    codes: np.ndarray         # (n, M)
    fine: FineIndex
    # per-level conditioning tables (cfg.rq.center_levels): part of the
    # quantizer, every later assign must subtract them (ops/rq.assign)
    prefix_shift: Optional[list] = None


def build_rq_index(cfg: MEVIConfig, emb: Union[np.ndarray, torch.Tensor],
                   seed: int = 42, iters: int = 25, serving_dtype=None,
                   cache: Optional[ArtifactCache] = None,
                   level_stats: Optional[list] = None, device="cuda",
                   ) -> RQIndexArtifacts:
    """Train RQ codebooks on the embeddings (a host array or a tensor,
    moved to ``device`` once) and lay out the fine index there.
    ``level_stats``: see :func:`mevi_tpu_torch.ops.rq.rq_train`."""
    dev = resolve_device(device)
    rq = cfg.rq
    center = rq.pq_type == "rq" and rq.center_levels
    M = rq.subvector_num
    akey = cfg.artifact_key("rq_index", len(emb), iters, seed,
                            "hrq" if center else "")
    x = as_device_tensor(emb, dev)
    prefix_shift = None
    if cache is not None and cache.has(akey, "codebooks.npy"):
        codebooks = cache.load_array(akey, "codebooks.npy")
        codes = cache.load_array(akey, "codes.npy")
        if center and cache.has(akey, "prefix_shift_1.npy"):
            prefix_shift = [cache.load_array(akey, f"prefix_shift_{i}.npy")
                            for i in range(1, M)]
    else:
        out = rq_ops.rq_train(
            x, levels=M, kary=rq.kary, iters=iters,
            generator=torch.Generator(device=dev).manual_seed(seed),
            dist_mode=rq.dist_mode, pq_type=rq.pq_type,
            center_levels=center, level_stats=level_stats, device=dev)
        if center:
            prefix_shift = [_host(t) for t in out[2]]
        codebooks, codes = _host(out[0]), _host(out[1])
        if cache is not None:
            cache.save_array(akey, "codebooks.npy", codebooks)
            cache.save_array(akey, "codes.npy", codes)
            for i, t in enumerate(prefix_shift or []):
                cache.save_array(akey, f"prefix_shift_{i + 1}.npy", t)
    fine = build_fine_index(codes, x, rq.kary, dtype=serving_dtype,
                            device=dev)
    return RQIndexArtifacts(codebooks, codes, fine, prefix_shift)


def _batches(emb, batch: int, dev: torch.device):
    for s in range(0, len(emb), batch):
        yield s, as_device_tensor(emb[s:s + batch], dev)


def assign_with_codebooks(cfg: MEVIConfig, emb, codebooks: np.ndarray,
                          batch: int = 262144, prefix_shift=None,
                          device="cuda") -> np.ndarray:
    """Assign codes with existing codebooks (e.g. mapping a sampled-corpus
    RQ back to the full corpus, ``gen_sampled_to_full.py:25-99``).
    ``prefix_shift``: the tables of a ``center_levels`` quantizer."""
    dev = resolve_device(device)
    cbs = as_device_tensor(codebooks, dev)
    shift = None if prefix_shift is None else \
        [as_device_tensor(t, dev) for t in prefix_shift]
    return np.concatenate([
        rq_ops.assign(x, cbs, cfg.rq.pq_type, cfg.rq.dist_mode,
                      prefix_shift=shift).cpu().numpy()
        for _, x in _batches(emb, batch, dev)])


def doc_topk_codes(cfg: MEVIConfig, emb, codebooks: np.ndarray, topk: int,
                   batch: int = 65536, device="cuda") -> np.ndarray:
    """Per-doc top-k codes (n, topk, M) by the codebook beam search
    (``get_topk_document_mapping``, ``pq.py:715-741``)."""
    dev = resolve_device(device)
    cbs = as_device_tensor(codebooks, dev)
    return np.concatenate([
        rq_ops.beam_search(x, cbs, num_beams=topk, pq_type=cfg.rq.pq_type,
                           dist_mode=cfg.rq.dist_mode,
                           score_mode=cfg.rq.rq_topk_score)[0].cpu().numpy()
        for _, x in _batches(emb, batch, dev)])


def doc_topic_proba(cfg: MEVIConfig, emb, codebooks: np.ndarray,
                    codes: np.ndarray, batch: int = 262144,
                    device="cuda") -> np.ndarray:
    """Per-doc probability of its own code under the codebook softmax,
    the 'topic model' doc-side score (``gen_doc2index_mapping``,
    ``main_models.py:3311-3371``): product over levels of
    softmax(level scores)[assigned code]."""
    dev = resolve_device(device)
    cbs = as_device_tensor(codebooks, dev)
    outs = []
    for s, x in _batches(emb, batch, dev):
        _, logits = rq_ops.assign_with_logits(x, cbs, cfg.rq.pq_type,
                                              cfg.rq.dist_mode)
        own = torch.gather(torch.softmax(logits, -1), -1, as_device_tensor(
            np.asarray(codes[s:s + batch]), dev).long()[:, :, None])[..., 0]
        outs.append(own.prod(-1).cpu().numpy())
    return np.concatenate(outs)


def topic_model_scores(query_proba, doc_proba, qd_scores,
                       topic_score_ratio: float):
    """Inference score fusion when the topic model is on
    (``get_inference_scores``, ``main_models.py:3539-3552``):
    ``query_proba * (r * doc_proba + (1 - r) * qd_scores)``."""
    return query_proba * (topic_score_ratio * doc_proba
                          + (1.0 - topic_score_ratio) * qd_scores)


def reconstruct_leaf_centroids(cfg: MEVIConfig, codebooks: np.ndarray,
                               cluster_indices: np.ndarray,
                               device="cuda") -> np.ndarray:
    """Reconstructed centroid of given leaf clusters (the lazy
    ``gen_all_reconstruct``: 32^4 x 768 float32 is 3.2 GB, so only what
    a query touches is made)."""
    dev = resolve_device(device)
    codes = unpack_codes(np.asarray(cluster_indices),
                         cfg.rq.subvector_num, cfg.rq.kary)
    return _host(rq_ops.reconstruct(as_device_tensor(codes, dev),
                                    as_device_tensor(codebooks, dev),
                                    cfg.rq.pq_type))


def quantize_int8(emb: Union[np.ndarray, torch.Tensor]
                  ) -> Tuple[Union[np.ndarray, torch.Tensor], float]:
    """Symmetric global-scale int8 quantization of an embedding matrix.

    Returns (int8 matrix, scale) with ``v_int8 = round(scale * v)`` and
    ``scale = 126 / max|v|`` from the true global max (one chunked pass).
    Calibrated scores fold ``1/scale`` into the query rows
    (``BucketServer(inv_scale=...)``).  A torch tensor is quantized on
    its own device, chunk by chunk, so a corpus on the card never takes
    a float32 copy of itself.
    """
    if isinstance(emb, torch.Tensor):
        s_max = 0.0
        for s in range(0, emb.shape[0], _CHUNK):
            s_max = max(s_max, float(emb[s:s + _CHUNK].float().abs().max()))
        scale = 126.0 / max(s_max, 1e-12)
        out = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
        for s in range(0, emb.shape[0], _CHUNK):
            out[s:s + _CHUNK] = torch.round(
                emb[s:s + _CHUNK].float() * scale).clamp(-127, 127).to(
                    torch.int8)
        return out, scale
    s_max = 0.0
    for s in range(0, len(emb), _CHUNK):
        s_max = max(s_max, float(np.max(np.abs(
            np.asarray(emb[s:s + _CHUNK], np.float32)))))
    scale = 126.0 / max(s_max, 1e-12)
    out = np.clip(np.round(emb.astype(np.float32) * scale),
                  -127, 127).astype(np.int8)
    return out, scale
