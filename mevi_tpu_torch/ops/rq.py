"""Residual quantization (RQ) and PQ on the device (port of
``mevi_tpu.ops.rq``).

* training: per-level k-means over residuals (``pq.py:582-594``) with
  :mod:`.kmeans`;
* assignment: per-level nearest centroid + residual subtraction
  (``pq.py:337-369`` / ``pq.py:281-305``);
* reconstruction: sum of selected centroids over levels (``pq.py:768-784``);
* codebook beam search over the code space (``pq.py:613-713``);
* Hungarian codebook alignment across refits (``pq.py:600-611``);
* the EMA codebook update of joint training (``pq.py:371-433``), its
  dead-code restart drawing rows from a ``torch.Generator``.

Codebooks are a dense (M, K, d) tensor; codes are int32 (n, M).  Row
passes over a corpus are chunked so no (n, d) float32 copy of a bf16
corpus is ever made; the residual is one buffer in the corpus' dtype,
updated in place level by level.  Sums over per-prefix segments use
``index_add_``, whose order of summation on the card is not fixed.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device, synchronize
from .kmeans import _sim, kmeans_fit
from .topk import topk_stable

_CHUNK = 65536


class RQCodebook(NamedTuple):
    """RQ/PQ codebooks plus geometry."""
    codebooks: torch.Tensor   # (M, K, d): d = emb for rq, emb // M for pq
    pq_type: str = "rq"
    dist_mode: str = "l2"

    @property
    def levels(self) -> int:
        return self.codebooks.shape[0]

    @property
    def kary(self) -> int:
        return self.codebooks.shape[1]


def full_sim(x: torch.Tensor, cb: torch.Tensor, dist_mode: str
             ) -> torch.Tensor:
    """(n, d) x (K, d) -> (n, K) float32; for 'l2' the complete
    -||x-c||^2 (``pq.py:124-131``), unlike ``kmeans._sim``."""
    s = _sim(x, cb, dist_mode)
    if dist_mode == "l2":
        s = s - x.float().square().sum(-1, keepdim=True)
    return s


def _unit(x: torch.Tensor) -> torch.Tensor:
    """Rows over their norms (+1e-12), computed in float32 and stored in
    x's dtype, as ``rq_train`` normalizes the last level."""
    xf = x.float()
    return (xf / (xf.norm(dim=-1, keepdim=True) + 1e-12)).to(x.dtype)


def _minus(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x - rows`` computed in float32 and stored in x's dtype, as
    ``rq_train`` updates its residual."""
    return (x.float() - rows.float()).to(x.dtype)


# --------------------------------------------------------------------------
# assignment / logits
# --------------------------------------------------------------------------

def assign(emb: torch.Tensor, codebooks: torch.Tensor, pq_type: str = "rq",
           dist_mode: str = "l2", prefix_shift=None) -> torch.Tensor:
    """Codes (n, M) int32.  ``prefix_shift`` (rq only): the M-1
    per-level conditioning tables of a ``center_levels`` quantizer
    (level i's table is (K^i, d), keyed by the packed prefix of levels
    0..i-1 and subtracted from the residual before level i)."""
    return assign_with_logits(emb, codebooks, pq_type, dist_mode,
                              prefix_shift)[0]


def assign_with_logits(emb: torch.Tensor, codebooks: torch.Tensor,
                       pq_type: str = "rq", dist_mode: str = "l2",
                       prefix_shift=None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes (n, M) int32 and per-level similarity logits (n, M, K) f32
    (``forward_rq``/``forward_pq``, ``pq.py:319-369``).  Residual
    updates and the last level's normalization round as ``rq_train``'s
    do, so a bf16 corpus is assigned the codes it was trained to (the
    JAX package rounds the shift tables to the corpus dtype first; in
    float32 the two agree)."""
    M, K, d = codebooks.shape
    n = emb.shape[0]
    codes, logits = [], []
    if pq_type != "rq":
        sub = emb.reshape(n, M, d)
        for m in range(M):
            logit = full_sim(sub[:, m], codebooks[m], dist_mode)
            codes.append(logit.argmax(-1))
            logits.append(logit)
        return torch.stack(codes, 1).int(), torch.stack(logits, 1)
    shifted = prefix_shift is not None and M > 1
    if shifted and len(prefix_shift) != M - 1:
        raise ValueError("prefix_shift: one table per level 1..M-1")
    resid = emb
    pref = None
    for i in range(M):
        if shifted and i > 0:
            resid = _minus(resid, prefix_shift[i - 1][pref.long()])
        # spherical last level (center_levels contract): quantize the
        # centered residual's direction
        x = _unit(resid) if shifted and i == M - 1 else resid
        logit = full_sim(x, codebooks[i], dist_mode)
        idx = logit.argmax(-1)
        codes.append(idx)
        logits.append(logit)
        if i < M - 1:
            resid = _minus(resid, codebooks[i][idx])
            if shifted:
                pref = idx if pref is None else pref * K + idx
    return torch.stack(codes, 1).int(), torch.stack(logits, 1)


def reconstruct(codes: torch.Tensor, codebooks: torch.Tensor,
                pq_type: str = "rq", prefix_shift=None) -> torch.Tensor:
    """(n, M) codes -> (n, emb) vectors (``pq.py:768-784``); the
    ``prefix_shift`` tables of a ``center_levels`` quantizer are added
    back."""
    M, K, d = codebooks.shape
    codes = codes.long()
    picked = torch.stack([codebooks[m][codes[:, m]] for m in range(M)], 1)
    if pq_type != "rq":
        return picked.reshape(codes.shape[0], M * d)
    out = picked.sum(1)
    if prefix_shift is not None and M > 1:
        pref = codes[:, 0]
        for i in range(1, M):
            out = out + prefix_shift[i - 1][pref].to(out.dtype)
            pref = pref * K + codes[:, i]
    return out


def reconstruction_mse(emb: torch.Tensor, codes: torch.Tensor,
                       codebooks: torch.Tensor, pq_type: str = "rq",
                       chunk: int = _CHUNK, prefix_shift=None
                       ) -> torch.Tensor:
    """Mean squared residual after reconstruction (a 0-d float32
    tensor), chunked so the (n, M, d) picked centroids never exist.

    ``prefix_shift``: the tables of a ``center_levels`` quantizer, added
    back by :func:`reconstruct`; the JAX package's function takes none
    and measures such a quantizer without them."""
    n, d = emb.shape
    total = torch.zeros((), dtype=torch.float32, device=emb.device)
    for s in range(0, n, chunk):
        rec = reconstruct(codes[s:s + chunk], codebooks, pq_type,
                          prefix_shift)
        total += (emb[s:s + chunk].float() - rec.float()).square().sum()
    return total / (n * d)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _minus_rows(x: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                out: Optional[torch.Tensor] = None,
                chunk: int = _CHUNK) -> torch.Tensor:
    """:func:`_minus` of ``table[idx]``, chunk by chunk, into ``out``
    (which may be ``x``)."""
    out = torch.empty_like(x) if out is None else out
    for s in range(0, x.shape[0], chunk):
        out[s:s + chunk] = _minus(x[s:s + chunk],
                                  table[idx[s:s + chunk].long()])
    return out


def _segment_mean(x: torch.Tensor, seg: torch.Tensor, num: int,
                  chunk: int = _CHUNK) -> torch.Tensor:
    """Per-segment float32 mean of the rows of ``x`` (zero for an empty
    segment); ``x`` may be (n, d) or (n,)."""
    sums = torch.zeros((num,) + x.shape[1:], dtype=torch.float32,
                       device=x.device)
    cnt = torch.zeros((num,), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        i = seg[s:s + chunk].long()
        sums.index_add_(0, i, x[s:s + chunk].float())
        cnt.index_add_(0, i, torch.ones_like(i, dtype=torch.float32))
    cnt = cnt.clamp_min(1.0)
    return sums / (cnt[:, None] if x.dim() == 2 else cnt)


def _argmax_full_sim(x, cb, dist_mode, chunk=_CHUNK):
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        out[s:s + chunk] = full_sim(x[s:s + chunk], cb, dist_mode).argmax(-1)
    return out


def rq_train(emb, levels: int, kary: int, iters: int = 25,
             generator: Optional[torch.Generator] = None,
             dist_mode: str = "l2", pq_type: str = "rq", chunk: int = _CHUNK,
             init_codebooks=None, center_levels: bool = False,
             level_stats: Optional[list] = None, device="cuda"):
    """Train codebooks with per-level k-means over residuals
    (``unsupervised_update_codebook_manually``, ``pq.py:550-598``):
    level i fits k-means on the residual after levels < i (rq) or on the
    i-th subvector (pq).  Returns (codebooks (M, K, d) in emb's dtype,
    codes (n, M) int32).

    ``center_levels`` (rq only): per-level by-residual conditioning.
    Each level i >= 1 gains a shift table ((kary^i, d) float32, the
    per-prefix residual mean, zero for unseen prefixes) subtracted
    before that level's k-means at fit and assign time, and the last
    level is fitted on unit directions, its centroids rescaled to the
    mean raw radius of their members (``assign(prefix_shift=...)``
    replicates the rule).  Returns (codebooks, codes, prefix_shift
    list) then.  Norms and radii are float32 sums here.

    ``level_stats``, when given, receives one dict per level: ``level``,
    ``seconds`` (device synchronised), ``lloyd_iters``, ``restarts``.
    """
    dev = resolve_device(device)
    emb = as_device_tensor(emb, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if init_codebooks is not None:
        init_codebooks = as_device_tensor(init_codebooks, dev)
    n, emb_size = emb.shape
    cbs: List[torch.Tensor] = []
    codes: List[torch.Tensor] = []
    shifts: List[torch.Tensor] = []
    rq = pq_type == "rq"
    center = center_levels and rq
    if center and kary ** (levels - 1) > (1 << 20):
        raise ValueError("center_levels: too many prefixes to segment")
    d = emb_size if rq else emb_size // levels
    resid = emb
    pref = None
    for i in range(levels):
        t0 = time.perf_counter()
        init_c = None if init_codebooks is None else init_codebooks[i]
        st: dict = {}
        kw = dict(iters=iters, generator=generator, dist_mode=dist_mode,
                  chunk=chunk, init_centroids=init_c, stats=st, device=dev)
        if not rq:
            cb, a = kmeans_fit(emb[:, i * d:(i + 1) * d], kary, **kw)
        else:
            if center and i >= 1:
                shift = _segment_mean(resid, pref, kary ** i, chunk)
                shifts.append(shift)
                resid = _minus_rows(resid, shift, pref, out=resid,
                                    chunk=chunk)
            if center and i == levels - 1 and levels > 1:
                # spherical last level: the centered residual's norm
                # varies by orders of magnitude across prefixes, so fit
                # on unit directions (the residual is not needed after)
                norms = torch.cat([resid[s:s + chunk].float().norm(dim=-1)
                                   for s in range(0, n, chunk)])
                for s in range(0, n, chunk):
                    resid[s:s + chunk] = _unit(resid[s:s + chunk])
                cb, a0 = kmeans_fit(resid, kary, **kw)
                rad = _segment_mean(norms, a0, kary, chunk)
                cb = (_unit(cb.float()) * rad[:, None]).to(cb.dtype)
                a = _argmax_full_sim(resid, cb, dist_mode, chunk)
            else:
                cb, a = kmeans_fit(resid, kary, **kw)
            if i != levels - 1:
                resid = _minus_rows(resid, cb, a,
                                    out=None if i == 0 else resid,
                                    chunk=chunk)
                if center:
                    pref = a if pref is None else pref * kary + a
        cbs.append(cb)
        codes.append(a)
        if level_stats is not None:
            synchronize(dev)
            level_stats.append(dict(level=i, seconds=time.perf_counter() - t0,
                                    **st))
    out = torch.stack(cbs), torch.stack(codes, 1).int()
    if center:
        return out[0], out[1], shifts
    return out


def opq_train(emb, levels: int, kary: int, iters: int = 15,
              inner_iters: int = 5,
              generator: Optional[torch.Generator] = None,
              dist_mode: str = "l2", device="cuda",
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OPQ by alternation (the reference's faiss ``OPQ{M},PQ{M}x{b}``,
    ``pq.py:179-198``): PQ k-means on rotated data, then the orthogonal
    Procrustes rotation ``R = U V^T`` from the SVD of ``X^T X_hat`` (on
    the host, float64).  Returns numpy (rotation (d, d), codebooks
    (M, K, d/M), codes (n, M)); assign new vectors with
    ``assign(x @ R.T, codebooks, 'pq')``."""
    dev = resolve_device(device)
    emb = as_device_tensor(emb, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = emb.shape[1]
    R = torch.eye(d, dtype=torch.float32, device=dev)
    codebooks = codes = None
    for it in range(iters):
        rotated = (emb.float() @ R.T).to(emb.dtype)
        codebooks, codes = rq_train(rotated, levels, kary, iters=inner_iters,
                                    generator=generator, dist_mode=dist_mode,
                                    pq_type="pq", init_codebooks=codebooks,
                                    device=dev)
        if it == iters - 1:
            break
        rec = reconstruct(codes, codebooks, "pq")
        m = emb.float().cpu().numpy().T @ rec.float().cpu().numpy()
        u, _, vt = np.linalg.svd(m.astype(np.float64))
        R = torch.from_numpy((u @ vt).T).float().to(dev)
    return (R.cpu().numpy(), codebooks.float().cpu().numpy(),
            codes.cpu().numpy())


def align_codebooks(old: np.ndarray, new: np.ndarray,
                    dist_mode: str = "l2") -> np.ndarray:
    """Permute ``new`` so each centroid matches its closest predecessor
    (Hungarian assignment, ``pq.py:600-611``).  Host-side: K <= 256."""
    from scipy.optimize import linear_sum_assignment
    out = np.empty_like(new)
    for lvl in range(new.shape[0]):
        o = old[lvl].astype(np.float64)
        c = new[lvl].astype(np.float64)
        if dist_mode == "ip":
            scores = c @ o.T                       # (cur, ori)
        else:
            scores = -((c[:, None, :] - o[None, :, :]) ** 2).sum(-1)
        cid, oid = linear_sum_assignment(scores, maximize=True)
        out[lvl][oid] = c[cid]
    return out


# --------------------------------------------------------------------------
# EMA codebook update (pq.py:371-433)
# --------------------------------------------------------------------------

class EMAState(NamedTuple):
    cluster_size: torch.Tensor   # (M, K) float32
    embed_sum: torch.Tensor      # (M, K, d) float32


def ema_init(codebooks: torch.Tensor) -> EMAState:
    M, K, _ = codebooks.shape
    return EMAState(torch.zeros((M, K), dtype=torch.float32,
                                device=codebooks.device),
                    codebooks.detach().float().clone())


@torch.no_grad()
def ema_update(state: EMAState, codebooks: torch.Tensor,
               vectors: torch.Tensor, codes: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               decay: float = 0.99, eps: float = 1e-5, restart: bool = True,
               ) -> Tuple[EMAState, torch.Tensor]:
    """One EMA step from a batch of (vectors, codes); returns (state,
    new codebooks in ``codebooks``' dtype).

    Every level accumulates the full vector, not the residual (the
    reference expands vectors across levels, ``pq.py:375-377``).  With
    ``restart``, a centroid whose decayed count falls below 1 restarts
    at a row drawn from ``generator`` (on the vectors' device), its count
    set to 1."""
    M, K, _ = codebooks.shape
    v = vectors.detach().float()
    onehot = torch.nn.functional.one_hot(codes.long(), K).float()  # (n,M,K)
    counts = onehot.sum(0)
    sums = torch.einsum("nmk,nd->mkd", onehot, v)
    new_size = state.cluster_size * decay + counts * (1 - decay)
    new_sum = state.embed_sum * decay + sums * (1 - decay)
    if restart:
        rows = torch.randint(0, v.shape[0], (M, K), generator=generator,
                             device=v.device)
        used = new_size >= 1.0
        new_sum = torch.where(used[..., None], new_sum, v[rows])
        new_size = torch.where(used, new_size, torch.ones_like(new_size))
    tot = new_size.sum(1, keepdim=True)
    norm = tot * (new_size + eps) / (tot + K * eps)
    new_codebooks = (new_sum / norm[..., None]).to(codebooks.dtype)
    return EMAState(new_size, new_sum), new_codebooks


# --------------------------------------------------------------------------
# codebook beam search (pq.py:613-713)
# --------------------------------------------------------------------------

def _take(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x (n, B, ...) rows picked per query by beam_idx (n, B')."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(beam_idx.shape + x.shape[2:]))


def beam_search(emb: torch.Tensor, codebooks: torch.Tensor, num_beams: int,
                pq_type: str = "rq", dist_mode: str = "l2",
                score_mode: str = "prod",
                prefix_shift: Optional[Sequence[torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``num_beams`` code sequences per embedding: per level a
    softmax over centroid similarities, multiplied into the running beam
    score ('prod', ``pq.py:663-667``), top beams kept (stable: ties keep
    the lower position, as ``lax.top_k``), the chosen centroid
    subtracted from each beam's residual.  Returns (codes (n, B, M)
    int32, scores (n, B) float32).  ``prefix_shift``: as in
    :func:`assign`, so beam top-1 equals the conditioned assignment."""
    M, K, d = codebooks.shape
    n = emb.shape[0]
    B = num_beams
    rq = pq_type == "rq"
    sim0 = full_sim(emb if rq else emb[:, :d], codebooks[0], dist_mode)
    scores, idx0 = topk_stable(torch.softmax(sim0, -1), min(B, K))
    if B > K:  # degenerate; pad (the reference expands instead)
        scores = torch.nn.functional.pad(scores, (0, B - K))
        idx0 = torch.nn.functional.pad(idx0, (0, B - K))
    codes = idx0[:, :, None].int()
    if rq:
        resid = _minus(emb[:, None, :], codebooks[0][idx0])
    pref = idx0 if prefix_shift is not None else None
    for lvl in range(1, M):
        cb = codebooks[lvl]
        if rq:
            r = resid
            if prefix_shift is not None:
                r = _minus(r, prefix_shift[lvl - 1][pref])
                if lvl == M - 1:
                    r = _unit(r)        # spherical last level
            sim = full_sim(r.reshape(n * B, -1), cb,
                           dist_mode).reshape(n, B, K)
        else:
            sub = emb[:, lvl * d:(lvl + 1) * d]
            sim = full_sim(sub, cb, dist_mode)[:, None, :].expand(n, B, K)
        p = torch.softmax(sim, -1)
        cand = scores[:, :, None] * p if score_mode == "prod" else p
        scores, pos = topk_stable(cand.reshape(n, B * K), B)
        beam_idx = pos // K
        code_idx = pos % K
        codes = torch.cat([_take(codes, beam_idx), code_idx[:, :, None].int()],
                          -1)
        if rq and lvl != M - 1:
            resid = _take(resid, beam_idx)
            if prefix_shift is not None:
                resid = _minus(resid, prefix_shift[lvl - 1][
                    torch.gather(pref, 1, beam_idx)])
            resid = _minus(resid, cb[code_idx])
        if pref is not None and lvl != M - 1:
            pref = torch.gather(pref, 1, beam_idx) * K + code_idx
    return codes, scores
