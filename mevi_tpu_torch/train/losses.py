"""Training losses (port of ``mevi_tpu.train.losses``).

Everything operates on the NCI model's compact logits (batch, L,
kary+1); see :mod:`mevi_tpu_torch.models.nci`.  Reference:

* NCI cross-entropy over code tokens + EOS with -100 ignore
  (``modeling_t5.py:1435,1758``),
* R-drop family (``modeling_t5.py:1703-1752``): two stochastic forwards
  of the same batch; 'KL' symmetric KL on logits, 'L2' on probs,
  'Contrast' in-batch contrastive over decoder hidden states,
* PQ distillation family (``main_models.py:2050-2138``): per-level NCI
  logits vs codebook similarity logits, 'ce', 'kl', 'mse', 'dot',
  'cosine', plus the sample/batch-negative contrastive and margin
  variants,
* RQ reconstruction loss over per-level residual stacks
  (``pq.py:743-766``),
* the twin-tower co-loss lives in :mod:`mevi_tpu_torch.models.twin_tower`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.topk import topk_stable


def nci_ce_loss(compact_logits: torch.Tensor, compact_labels: torch.Tensor,
                loss_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; labels use -100 for ignore.
    ``loss_weight``: optional per-position weights, normalized by the
    count of valid positions (sum / num_valid), as in the reference."""
    valid = compact_labels >= 0
    labels = compact_labels.clamp(min=0).long()
    logp = torch.log_softmax(compact_logits.float(), -1)
    nll = -logp.gather(-1, labels[..., None])[..., 0] * valid
    if loss_weight is not None:
        nll = nll * loss_weight
    return nll.sum() / valid.sum().clamp(min=1)


# --------------------------------------------------------------------------
# R-drop
# --------------------------------------------------------------------------

def rdrop_kl(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """Symmetric KL summed over tokens / seq-len (the reference's
    p_loss.sum()/2/sl convention)."""
    sl = logits_a.shape[1]
    la = torch.log_softmax(logits_a.float(), -1)
    lb = torch.log_softmax(logits_b.float(), -1)
    p_loss = (lb.exp() * (lb - la)).sum()
    q_loss = (la.exp() * (la - lb)).sum()
    return (p_loss + q_loss) / 2.0 / sl


def rdrop_l2(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    pa = torch.softmax(logits_a.float(), -1)
    pb = torch.softmax(logits_b.float(), -1)
    return ((pa - pb) ** 2).mean()


def rdrop_contrast(dec_hidden_a: torch.Tensor,
                   dec_hidden_b: torch.Tensor) -> torch.Tensor:
    """'Contrast' R-drop: per position, in-batch contrastive between the
    two stochastic decoder states, with the diagonal masked and target =
    the twin copy's row."""
    seq = torch.cat([dec_hidden_a, dec_hidden_b], 0)
    bz = seq.shape[0]
    half = bz // 2
    neg1 = seq.transpose(0, 1).float()                      # (sl, bz, d)
    logits = torch.einsum("sbd,scd->sbc", neg1, neg1)
    logits = logits + torch.eye(bz, device=seq.device)[None] * -1e9
    # the reference applies softmax and then CE-with-logits: a double
    # softmax (modeling_t5.py:1742-1746), copied on purpose
    probs = torch.softmax(logits, -1)
    targets = torch.cat([torch.arange(half, bz), torch.arange(0, half)]
                        ).to(seq.device)
    logp = torch.log_softmax(probs, -1)
    picked = logp[:, torch.arange(bz, device=seq.device), targets]
    return -picked.mean()


# --------------------------------------------------------------------------
# PQ distillation (main_models.py:2050-2138)
# --------------------------------------------------------------------------

def soft_assign(logits: torch.Tensor, tau: float = 1.0,
                hard_topk: int = 0) -> torch.Tensor:
    """``get_softmax`` without gumbel noise: softmax with temperature,
    and with ``hard_topk`` the straight-through hard top-k (forward the
    k-hot average, backward the softmax's gradient)."""
    assign = torch.softmax(logits.float() / tau, -1)
    if hard_topk > 0:
        _, idx = topk_stable(assign, hard_topk)
        hard = F.one_hot(idx.long(), assign.shape[-1]).to(
            assign.dtype).sum(-2) / hard_topk
        assign = (hard - assign).detach() + assign
    return assign


def _rel_entr(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.rel_entr``: p log(p/q) where both are
    positive, 0 where p == 0 <= q, inf elsewhere (same gradients)."""
    both = (p > 0) & (q > 0)
    one_zero = (p == 0) & (q >= 0)
    sp = torch.where(both, p, torch.ones_like(p))
    sq = torch.where(both, q, torch.ones_like(q))
    val = sp * torch.log(sp) - sp * torch.log(sq)
    return torch.where(both, val, torch.where(
        one_zero, torch.zeros_like(p), torch.full_like(p, float("inf"))))


def pq_distill_loss(nci_logits: torch.Tensor, pq_logits: torch.Tensor,
                    kind: str = "ce", tau: float = 1.0,
                    negative: str = "none", negative_loss: str = "cont",
                    margin: float = 1.0, hard_topk: int = 0) -> torch.Tensor:
    """Distill the codebook-similarity distribution into/from NCI logits.

    nci_logits: (b, M, K); pq_logits: (b or b*g, M, K); with
    ``negative='sample'`` pq rows are grouped per query (positive first),
    with 'batch' all rows are shared negatives, 'none' compares
    positives elementwise.  Matches ``compute_pq_loss``."""
    b = nci_logits.shape[0]
    if kind == "ce":
        # -stopgrad(softmax(nci/tau)) . log_softmax(pq/tau)
        nci_sm = soft_assign(nci_logits, tau, hard_topk).detach()

        def pair_loss(nci_a, pq):
            pq_lsm = torch.log_softmax(pq.float() / tau, -1)
            return (-nci_a * pq_lsm).sum(-1)                 # (..., M)
    else:
        nci_sm = soft_assign(nci_logits, tau, hard_topk)

        def pair_loss(nci_a, pq):
            pq_a = soft_assign(pq, tau, hard_topk)
            if kind == "kl":
                l = (_rel_entr(pq_a, nci_a + 1e-12)
                     + _rel_entr(nci_a, pq_a + 1e-12)) / 2
            elif kind == "mse":
                l = (pq_a - nci_a) ** 2
            elif kind == "dot":
                l = -pq_a * nci_a
            elif kind == "cosine":
                l = -(pq_a / pq_a.norm(dim=-1, keepdim=True)) \
                    * (nci_a / nci_a.norm(dim=-1, keepdim=True))
            else:
                raise ValueError(kind)
            return l.sum(-1)

    if negative == "none":
        pq_pos = pq_logits.reshape(b, -1, *pq_logits.shape[1:])[:, 0]
        return pair_loss(nci_sm, pq_pos).mean()

    # grouped variants: (b, g, M, K) pairs
    if negative == "sample":
        pq = pq_logits.reshape(b, -1, *pq_logits.shape[1:])
        targets = torch.zeros(b, dtype=torch.long, device=pq.device)
    else:  # 'batch': every row vs all rows
        pq = pq_logits[None].expand(b, *pq_logits.shape)
        group = pq_logits.shape[0] // b
        targets = torch.arange(b, device=pq.device) * group
    per = pair_loss(nci_sm[:, None], pq).mean(-1)           # (b, g)
    if negative_loss == "cont":
        # smaller distillation distance should win: CE over -distance
        logp = torch.log_softmax(-per, -1)
        return -logp.gather(1, targets[:, None]).mean()
    pos = per.gather(1, targets[:, None])
    neg = (per.sum(-1, keepdim=True) - pos) / (per.shape[1] - 1)
    return (pos - neg.clamp(max=margin) + margin).mean()


def rq_reconstruction_loss(emb: torch.Tensor, codes: torch.Tensor,
                           codebooks: torch.Tensor) -> torch.Tensor:
    """Stacked per-level residual MSE (``pq.py:743-766``, rq branch):
    level i's residual is emb - sum(centroids up to i)."""
    M = codebooks.shape[0]
    picked = torch.stack([codebooks[m][codes[:, m].long()]
                          for m in range(M)], 1)              # (n, M, d)
    diffs = emb[:, None, :].float() - picked.cumsum(1).float()
    return (diffs ** 2).mean()
