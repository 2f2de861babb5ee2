"""Twin-tower dense encoder (port of ``mevi_tpu.models.twin_tower``; the
reference's DocumentEncoder, ``MEVI/document_encoder.py``).

* T5 family (T5-ANCE): representation = decoder token-0 hidden state
  with a single zero decoder input,
* BERT family (coCondenser / AR2-ERNIE): CLS hidden state,
* DeepSeek-V2 family (a decoder LLM as the query tower, as RepLLaMA):
  the final norm's output at the last real token (port only; serving
  only, no training path),
* in-batch-negative contrastive loss with the reference's target layout:
  with p_reps grouped per query (1 positive + n negatives),
  ``target_i = i * (n_p // n_q)``; with ``axis_name`` the reps are
  gathered over that mesh axis first (negatives_x_device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import gather_rows
from .bert import BertDims, BertEncoderModel
from .deepseek_v2 import DeepseekV2Dims, DeepseekV2Model
from .t5 import T5Dims, T5Model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Tower(NamedTuple):
    family: str          # 't5' | 'bert' | 'deepseek_v2'
    module: nn.Module    # T5Model | BertEncoderModel | DeepseekV2Model

    def rep(self, input_ids, attention_mask, token_type_ids=None
            ) -> torch.Tensor:
        if self.family == "t5":
            return self.module.first_token_rep(input_ids, attention_mask)
        if self.family == "deepseek_v2":
            return self.module.last_token_rep(input_ids, attention_mask)
        return self.module.cls_rep(input_ids, attention_mask,
                                   token_type_ids)


def make_tower(family: str, dims=None, device="cuda",
               dtype=torch.float32) -> Tower:
    """``dtype``: the parameters' dtype (``dims.dtype`` is the compute
    dtype)."""
    if family == "t5":
        dims = dims or T5Dims(num_decoder_layers=12)  # t5-ance: full dec
        return Tower("t5", T5Model(dims, device=device, dtype=dtype))
    if family == "deepseek_v2":
        return Tower(family, DeepseekV2Model(dims or DeepseekV2Dims(),
                                             device=device, dtype=dtype))
    dims = dims or BertDims()
    return Tower("bert", BertEncoderModel(dims, device=device, dtype=dtype))


def tower_from_config(enc_cfg, device="cuda", dtype=torch.float32,
                      remat: bool = False) -> Tower:
    """Tower built from a :class:`mevi_tpu_torch.config.EncoderConfig`
    (dropout 0, as the JAX package builds it); ``enc_cfg.dtype`` is the
    compute dtype of either family (the JAX package's BERT tower ignores
    it and computes in float32), ``dtype`` the parameters'.  ``remat``:
    recompute each T5 block in the backward (the BERT family has no
    remat).  The ``deepseek_v2`` family computes in its parameters'
    dtype and takes ``d_model``, ``num_layers``, ``num_heads``, ``d_ff``
    (the dense layer's width), ``vocab_size`` and ``layer_norm_epsilon``
    from the config's fields, its other widths from ``enc_cfg.deepseek_v2``
    (HF config keys), which may not contradict the fields."""
    if enc_cfg.family == "deepseek_v2":
        if remat:
            raise ValueError("deepseek_v2 towers have no training path")
        fields = dict(hidden_size=enc_cfg.d_model,
                      num_hidden_layers=enc_cfg.num_layers,
                      num_attention_heads=enc_cfg.num_heads,
                      intermediate_size=enc_cfg.d_ff,
                      vocab_size=enc_cfg.vocab_size,
                      rms_norm_eps=enc_cfg.layer_norm_epsilon)
        hf = dict(enc_cfg.deepseek_v2 or {})
        clash = sorted(k for k, v in fields.items() if hf.get(k, v) != v)
        if clash:
            raise ValueError(f"deepseek_v2 keys {clash} contradict the "
                             "encoder config's fields")
        dims = DeepseekV2Dims.from_config({**hf, **fields})
        return Tower("deepseek_v2", DeepseekV2Model(dims, device=device,
                                                    dtype=dtype))
    if enc_cfg.family == "t5":
        dims = T5Dims(
            d_model=enc_cfg.d_model, num_layers=enc_cfg.num_layers,
            # T5-ANCE is a full t5-base: decoder depth == encoder depth
            num_decoder_layers=enc_cfg.num_layers,
            num_heads=enc_cfg.num_heads,
            d_kv=enc_cfg.d_model // enc_cfg.num_heads, d_ff=enc_cfg.d_ff,
            vocab_size=enc_cfg.t5_vocab_size, dropout_rate=0.0,
            remat=remat, dtype=_DTYPES[enc_cfg.dtype])
        return Tower("t5", T5Model(dims, device=device, dtype=dtype))
    dims = BertDims(
        vocab_size=enc_cfg.vocab_size, d_model=enc_cfg.d_model,
        num_layers=enc_cfg.num_layers, num_heads=enc_cfg.num_heads,
        d_ff=enc_cfg.d_ff,
        max_position_embeddings=enc_cfg.max_position_embeddings,
        type_vocab_size=enc_cfg.type_vocab_size, dropout_rate=0.0,
        dtype=_DTYPES[enc_cfg.dtype])
    return Tower("bert", BertEncoderModel(dims, device=device, dtype=dtype))


def similarity(q_reps: torch.Tensor, p_reps: torch.Tensor,
               bmm: bool = False) -> torch.Tensor:
    """``compute_similarity`` (``document_encoder.py:128-132``), float32
    products with float32 output."""
    if bmm:
        return (q_reps * p_reps).sum(-1)
    return q_reps.float() @ p_reps.float().transpose(-1, -2)


def contrastive_loss(q_reps: torch.Tensor, p_reps: torch.Tensor,
                     axis_name: Optional[str] = None, mesh=None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch-negative CE loss; p_reps rows are grouped per query:
    [q0_pos, q0_neg..., q1_pos, ...].  Returns (loss, scores).

    With ``axis_name`` (an axis of ``mesh``, a
    :class:`~mevi_tpu_torch.parallel.mesh.Mesh`), q_reps and p_reps are
    all-gathered over that axis first (negatives_x_device,
    ``document_encoder.py:74-76``): every rank computes the loss of the
    gathered batch, and the gather's backward sums each rank's block
    over the ranks (the transpose of ``lax.all_gather``)."""
    if axis_name is not None:
        if mesh is None:
            raise ValueError("axis_name needs the mesh that holds it")
        q_reps = gather_rows(q_reps, mesh, axis_name)
        p_reps = gather_rows(p_reps, mesh, axis_name)
    scores = similarity(q_reps, p_reps)
    nq = q_reps.shape[0]
    group = p_reps.shape[0] // nq
    targets = torch.arange(nq, device=scores.device) * group
    logprobs = torch.log_softmax(scores, dim=-1)
    loss = -logprobs.gather(1, targets[:, None]).mean()
    return loss, scores


def grouped_contrastive_loss(q_reps: torch.Tensor,
                             p_reps: torch.Tensor) -> torch.Tensor:
    """Per-query candidate groups: q (nq, d), p (nq, g, d), positive at
    slot 0 (the in-cluster hard-negative loss)."""
    scores = torch.einsum("qd,qgd->qg", q_reps.float(), p_reps.float())
    return -torch.log_softmax(scores, dim=-1)[:, 0].mean()
