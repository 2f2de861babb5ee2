"""The comparison that decides ``correct``: what the timed path served,
for a sample of its queries drawn from the seed, against the plain
reference in float32 (TF32 off).

The numbers compared, each against the cell's limit:

* ``tower_err``: the largest ``|q - q_ref| / |q_ref|`` over the sample,
  the served query embedding (read at the tower's output) against the
  reference tower on the same tokens;
* ``beam_err``: the largest gap between a served beam score and the
  reference's score of the same code sequence (teacher-forced: the
  reference follows the beam's own prefixes);
* ``beam_gap``: the largest amount by which a last-level extension of a
  served hypothesis's parent that the beam dropped scores, in the
  reference, above the worst hypothesis it kept;
* ``pool_err``: the largest gap between a served pool score and the
  reference's score of that document, over ``|q|``, with the served
  embedding (its error is ``tower_err``'s);
* ``pool_gap``: the largest amount by which a document the served pool
  missed scores above the worst one it kept, over ``|q|``;
* ``pool_faults``: queries whose pool holds a document outside its
  windows (or more often than the windows hold it), the wrong number of
  documents, or scores out of order (limit 0).

A request that failed or never came back counts in ``failed``, and any
makes the run not correct.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import data, lookup, weights
from .reference import fine, nci
from .reference.common import F32, Precision, tf32_off

NAMES = ("tower_err", "beam_err", "beam_gap", "pool_err", "pool_gap",
         "pool_faults")
BLOCK = 64          # queries a reference pass


@dataclasses.dataclass
class Sample:
    """What the timed path served for ``n`` sampled queries, on the host:
    inputs (ids, mask (n, L), cidx (n, nb)) and outputs (q (n, d) float32,
    codes (n, nb, M), beam_scores (n, nb), pool_ids, pool_scores (n, k))."""
    ids: torch.Tensor
    mask: torch.Tensor
    cidx: torch.Tensor
    q: torch.Tensor
    codes: torch.Tensor
    beam_scores: torch.Tensor
    pool_ids: np.ndarray
    pool_scores: np.ndarray

    @staticmethod
    def concat(parts):
        f = dataclasses.fields(Sample)
        return Sample(*[
            (np.concatenate if isinstance(getattr(parts[0], x.name),
                                          np.ndarray) else torch.cat)(
                [getattr(p, x.name) for p in parts]) for x in f])


class Reference:
    """The reference's weights (float32 copies of the seed's bf16 values)
    and the corpus membership, built after the program's state is freed."""

    def __init__(self, cfg, corpus: data.Corpus, seed: int, device):
        tf32_off()
        self.cfg, self.corpus, self.device = cfg, corpus, device
        self.tower_c, self.nci_c = cfg["tower"], cfg["nci"]
        self.W_tower = weights.as_f32(weights.make(
            tower_specs(cfg), seed, weights.TOWER_STREAM, device,
            weights.dtype_of(cfg)))
        self.W_nci = weights.as_f32(weights.make(
            nci.specs(self.nci_c), seed, weights.NCI_STREAM, device,
            weights.dtype_of(cfg)))
        ix = cfg["index"]
        self.members = fine.Membership(corpus.cluster,
                                       ix["kary"] ** ix["levels"])
        self.row_dtype = weights.dtype_of(cfg)

    def rows_of(self, docs):
        return data.gen_rows(self.corpus, self.corpus.draws[docs]).to(
            self.row_dtype).float()

    def tower(self, ids, mask, P=F32):
        c = self.tower_c
        return lookup.reference(c["family"]).rep(self.W_tower, c, ids, mask,
                                                 P)

    def windows(self, cidx):
        s = self.cfg["serving"]
        return self.members.windows(cidx, s["cap"],
                                    self.cfg["index"]["window_align"])


def tower_specs(cfg):
    c = cfg["tower"]
    return lookup.reference(c["family"]).tower_specs(c)


def readings(ref: Reference, sm: Sample) -> Dict[str, float]:
    """The compared numbers for a sample (see the module's list)."""
    dev = ref.device
    s = ref.cfg["serving"]
    out = dict.fromkeys(NAMES, 0.0)
    for a in range(0, sm.ids.shape[0], BLOCK):
        ids = sm.ids[a:a + BLOCK].to(dev)
        mask = sm.mask[a:a + BLOCK].to(dev)
        q = sm.q[a:a + BLOCK].to(dev).float()
        q_ref = ref.tower(ids, mask)
        err = (torch.linalg.vector_norm(q - q_ref, dim=1)
               / torch.linalg.vector_norm(q_ref, dim=1))
        out["tower_err"] = max(out["tower_err"], float(err.max()))

        codes = sm.codes[a:a + BLOCK].to(dev)
        logp = nci.level_logp(ref.W_nci, ref.nci_c, ids, mask, codes)
        norm, ext = nci.path_scores(logp, codes, s["length_penalty"])
        served = sm.beam_scores[a:a + BLOCK].to(dev).float()
        out["beam_err"] = max(out["beam_err"],
                              float((served - norm).abs().max()))
        out["beam_gap"] = max(out["beam_gap"], beam_gap(codes, ext))

        docs = ref.windows(sm.cidx[a:a + BLOCK])
        scores = fine.window_scores(docs, q, ref.rows_of)
        qn = torch.linalg.vector_norm(q, dim=1).cpu().numpy()
        d_h = docs.reshape(docs.shape[0], -1).cpu().numpy()
        s_h = scores.reshape(docs.shape[0], -1).cpu().numpy()
        for i in range(d_h.shape[0]):
            f, e, g = fine.pool_readings(
                sm.pool_ids[a + i], sm.pool_scores[a + i], d_h[i], s_h[i],
                float(qn[i]), s["pool"])
            out["pool_faults"] += f
            out["pool_err"] = max(out["pool_err"], e)
            out["pool_gap"] = max(out["pool_gap"], g)
    return out


def beam_gap(codes, ext) -> float:
    """``ext`` (b, H, K): reference scores of every last-level extension
    of each hypothesis's parent; the kept hypotheses are ``codes``."""
    b, H, M = codes.shape
    K = ext.shape[-1]
    parent = codes[..., :M - 1]
    last = codes[..., M - 1].long()
    # candidates: each distinct parent's K extensions
    same = (parent[:, :, None, :] == parent[:, None, :, :]).all(-1)
    first = ~torch.tril(same, -1).any(-1)                 # (b, H)
    kept = torch.zeros((b, H, K), dtype=torch.bool, device=codes.device)
    for j in range(H):
        # hypothesis j marks its last code on the first hypothesis with
        # the same parent
        owner = same[:, j, :].float().argmax(-1)           # (b,)
        kept[torch.arange(b), owner, last[:, j]] = True
    cand = first[..., None].expand(b, H, K)
    kept_s = torch.where(kept & cand, ext, torch.full_like(ext, float("inf")))
    drop_s = torch.where(~kept & cand, ext,
                         torch.full_like(ext, float("-inf")))
    worst_kept = kept_s.reshape(b, -1).min(-1).values
    best_drop = drop_s.reshape(b, -1).max(-1).values
    return float((best_drop - worst_kept).clamp(min=0).max())


def control_sample(ref: Reference, sm: Sample, kind: str = "fp8") -> Sample:
    """The control: the reference in the nearest precision below the
    configuration's, put in the program's place on the same inputs and,
    for the beam, the same hypotheses (its scores along them, and its own
    choice of the last code among each parent's extensions)."""
    P = Precision(kind)
    s = ref.cfg["serving"]
    parts = []
    for a in range(0, sm.ids.shape[0], BLOCK):
        ids = sm.ids[a:a + BLOCK].to(ref.device)
        mask = sm.mask[a:a + BLOCK].to(ref.device)
        q = ref.tower(ids, mask, P)
        codes = sm.codes[a:a + BLOCK].to(ref.device)
        logp = nci.level_logp(ref.W_nci, ref.nci_c, ids, mask, codes, P)
        _, ext = nci.path_scores(logp, codes, s["length_penalty"])
        codes = control_choice(codes, ext)
        logp = nci.level_logp(ref.W_nci, ref.nci_c, ids, mask, codes, P)
        norm, _ = nci.path_scores(logp, codes, s["length_penalty"])
        docs = ref.windows(sm.cidx[a:a + BLOCK])
        scores = fine.window_scores(docs, q, ref.rows_of, P)
        pid, psc = fine.pool_topk(docs, scores, s["pool"])
        parts.append(Sample(sm.ids[a:a + BLOCK], sm.mask[a:a + BLOCK],
                            sm.cidx[a:a + BLOCK], q.cpu(), codes.cpu(),
                            norm.cpu(), pid, psc))
    return Sample.concat(parts)


def control_choice(codes, ext):
    """The hypotheses with each last code replaced by the control's own
    choice: the best ``H`` extensions of the served parents by the
    control's scores (a parent shared by several hypotheses counted
    once).  Keeps the served order of the parents."""
    b, H, M = codes.shape
    K = ext.shape[-1]
    parent = codes[..., :M - 1]
    same = (parent[:, :, None, :] == parent[:, None, :, :]).all(-1)
    first = ~torch.tril(same, -1).any(-1)
    s = torch.where(first[..., None], ext, torch.full_like(ext, float("-inf")))
    top = torch.sort(s.reshape(b, -1), dim=1, descending=True,
                     stable=True).indices[:, :H]
    par = torch.gather(parent, 1, (top // K)[..., None].expand(b, H, M - 1))
    return torch.cat([par, (top % K)[..., None].to(codes.dtype)], -1)


def judge(numbers: Dict[str, float], limits: Optional[Dict[str, float]],
          failed: int):
    """(correct, checks): each number beside its limit."""
    checks = {}
    ok = failed == 0 and limits is not None
    for k in NAMES:
        v = numbers.get(k)
        lim = None if limits is None else limits.get(k)
        v_out = v if v is None or np.isfinite(v) else 1e30
        checks[k] = {"value": v_out, "limit": lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, checks
