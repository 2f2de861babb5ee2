"""Checkpoint converters: HF / reference torch state dicts -> the port's
module state dicts (port of ``mevi_tpu.models.convert``).

Covers the reference's model zoo (``document_encoder.py:134-198``,
``main.py:191-264``):

* HF ``T5Model`` / ``T5ForConditionalGeneration`` (T5-ANCE, docT5query),
* HF ``BertModel`` / ``ErnieModel`` (coCondenser, AR2),
* AR2 DPR-style dicts with ``ctx_model.`` / ``question_model.``
  prefixes (``document_encoder.py:156-178``),
* reference NCI Lightning checkpoints (the T5 mapping plus the NCI
  extras: decode embeddings, the PAWA adaptor, ``adaptor_linear``),
* HF ``DeepseekV2ForCausalLM`` (DeepSeek-V2-Lite as a query tower; the
  routed experts stacked, the port's layout).

HF ``Linear`` weights are already ``(out, in)``, the port's layout, so
the tensors go over as they are (no flax detour): only names change,
plus ``adaptor_linear.weight`` transposed into the ``(d_in, d*V)``
``adaptor_kernel`` and the adaptor memory vector reshaped to
``(1, 1, d)``.  PAWA keeps the reference's packed ``in_proj_weight``
``(3d, d)``, the layout of the port's ``TorchMultiheadAttention``.  The
result equals ``weights.flax_to_state_dict`` of the JAX converters'
output bit for bit.  Inputs are ``{name: tensor or array}``; outputs are
``{name: torch.Tensor}`` on the host, for ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

SD = Mapping[str, object]
Out = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    """A host tensor (contiguous) from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _attn(sd: SD, src: str, dst: str, cross: bool = False,
          with_bias_table: bool = False) -> Out:
    hf = "EncDecAttention" if cross else "SelfAttention"
    out = {f"{dst}.{n}.weight": _t(sd[f"{src}.{hf}.{n}.weight"])
           for n in ("q", "k", "v", "o")}
    if with_bias_table:
        out[f"{dst}.relative_attention_bias.weight"] = _t(
            sd[f"{src}.{hf}.relative_attention_bias.weight"])
    return out


def _ff(sd: SD, src: str, dst: str, gated: bool) -> Out:
    names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
    return {f"{dst}.{n}.weight": _t(sd[f"{src}.{n}.weight"]) for n in names}


def convert_t5_stack(sd: SD, side: str, num_layers: int,
                     gated: bool = False, prefix: str = None) -> Out:
    """HF T5 ``encoder`` / ``decoder`` stack -> ``T5Stack`` state dict
    entries under ``prefix`` (default ``side``)."""
    dst = side if prefix is None else prefix
    is_dec = side == "decoder" or side == "ori_decoder"
    out: Out = {}
    for i in range(num_layers):
        p, q = f"{side}.block.{i}", f"{dst}.blocks.{i}"
        out.update(_attn(sd, f"{p}.layer.0", f"{q}.self_attn",
                         with_bias_table=(i == 0)))
        out[f"{q}.self_norm.weight"] = _t(sd[f"{p}.layer.0.layer_norm.weight"])
        ff_layer = 1
        if is_dec:
            out.update(_attn(sd, f"{p}.layer.1", f"{q}.cross_attn",
                             cross=True))
            out[f"{q}.cross_norm.weight"] = _t(
                sd[f"{p}.layer.1.layer_norm.weight"])
            ff_layer = 2
        out.update(_ff(sd, f"{p}.layer.{ff_layer}.DenseReluDense",
                       f"{q}.ff", gated))
        out[f"{q}.ff_norm.weight"] = _t(
            sd[f"{p}.layer.{ff_layer}.layer_norm.weight"])
    out[f"{dst}.final_norm.weight"] = _t(sd[f"{side}.final_layer_norm.weight"])
    return out


def convert_t5_model(sd: SD, num_layers: int, num_decoder_layers: int,
                     gated: bool = False) -> Out:
    """HF ``T5Model`` -> the port's ``T5Model`` state dict."""
    return {"shared.weight": _t(sd["shared.weight"]),
            **convert_t5_stack(sd, "encoder", num_layers, gated),
            **convert_t5_stack(sd, "decoder", num_decoder_layers, gated)}


def convert_t5_encoder_model(sd: SD, num_layers: int,
                             gated: bool = False) -> Out:
    """HF ``T5EncoderModel`` -> the port's ``T5EncoderModel``."""
    return {"shared.weight": _t(sd["shared.weight"]),
            **convert_t5_stack(sd, "encoder", num_layers, gated)}


# --------------------------------------------------------------------------
# PAWA adaptor (torch nn.TransformerDecoder layout)
# --------------------------------------------------------------------------

def _ln(sd: SD, src: str, dst: str) -> Out:
    # HF uses LayerNorm.{weight,bias}, old checkpoints LayerNorm.{gamma,beta}
    for w, b in ((f"{src}.weight", f"{src}.bias"),
                 (f"{src}.gamma", f"{src}.beta")):
        if w in sd:
            return {f"{dst}.weight": _t(sd[w]), f"{dst}.bias": _t(sd[b])}
    raise KeyError(src)


def _dense(sd: SD, src: str, dst: str) -> Out:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _mha(sd: SD, src: str, dst: str) -> Out:
    return {f"{dst}.in_proj_weight": _t(sd[f"{src}.in_proj_weight"]),
            f"{dst}.in_proj_bias": _t(sd[f"{src}.in_proj_bias"]),
            **_dense(sd, f"{src}.out_proj", f"{dst}.out_proj")}


def convert_pawa(sd: SD, num_layers: int, prefix: str = "",
                 dst: str = "") -> Out:
    """torch ``nn.TransformerDecoder`` layers -> ``PawaAdaptor`` layer
    entries.  ``prefix`` points at the decoder ('adaptor.' in reference
    NCI checkpoints); ``dst`` is the adaptor's place in the target
    module ('pawa.' in ``NCIT5``).  The memory vector is the caller's."""
    out: Out = {}
    for i in range(num_layers):
        p, q = f"{prefix}layers.{i}", f"{dst}layers.{i}"
        out.update(_mha(sd, f"{p}.self_attn", f"{q}.self_attn"))
        out.update(_mha(sd, f"{p}.multihead_attn", f"{q}.cross_attn"))
        for n in ("norm1", "norm2", "norm3"):
            out.update(_ln(sd, f"{p}.{n}", f"{q}.{n}"))
        for n in ("linear1", "linear2"):
            out.update(_dense(sd, f"{p}.{n}", f"{q}.{n}"))
    return out


def convert_nci_checkpoint(sd: SD, num_layers: int,
                           num_decoder_layers: int,
                           adaptor_layers: int = 4,
                           reserve_decoder: bool = False,
                           gated: bool = False) -> Out:
    """Reference NCI Lightning checkpoint ('model.' prefix stripped) ->
    the port's ``NCIT5`` state dict."""
    out = {"shared.weight": _t(sd["shared.weight"]),
           **convert_t5_stack(sd, "encoder", num_layers, gated),
           **convert_t5_stack(sd, "decoder", num_decoder_layers, gated),
           "decode_embeddings.weight": _t(sd["decode_embeddings.weight"])}
    if "adaptor_linear.weight" in sd:
        out.update(convert_pawa(sd, adaptor_layers, prefix="adaptor.",
                                dst="pawa."))
        out["pawa.memory_embedding"] = _t(
            sd["adaptor_embeddings"]).reshape(1, 1, -1)
        out["adaptor_kernel"] = _t(sd["adaptor_linear.weight"]).T.contiguous()
    if reserve_decoder:
        out.update(convert_t5_stack(sd, "ori_decoder", 12, gated))
    return out


# --------------------------------------------------------------------------
# BERT / ERNIE
# --------------------------------------------------------------------------

def convert_bert_model(sd: SD, num_layers: int) -> Out:
    """HF ``BertModel`` / ``ErnieModel`` -> the port's
    ``BertEncoderModel`` state dict (an ERNIE dict with its prefix
    stripped by the caller)."""
    e = "embeddings"
    out = {f"{e}.word.weight": _t(sd[f"{e}.word_embeddings.weight"]),
           f"{e}.position.weight": _t(sd[f"{e}.position_embeddings.weight"]),
           f"{e}.token_type.weight": _t(
               sd[f"{e}.token_type_embeddings.weight"]),
           **_ln(sd, f"{e}.LayerNorm", f"{e}.norm")}
    for i in range(num_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}"
        for n in ("query", "key", "value"):
            out.update(_dense(sd, f"{p}.attention.self.{n}",
                              f"{q}.attn.{n}"))
        out.update(_dense(sd, f"{p}.attention.output.dense", f"{q}.attn.out"))
        out.update(_ln(sd, f"{p}.attention.output.LayerNorm",
                       f"{q}.attn.norm"))
        out.update(_dense(sd, f"{p}.intermediate.dense",
                          f"{q}.ff_intermediate"))
        out.update(_dense(sd, f"{p}.output.dense", f"{q}.ff_out"))
        out.update(_ln(sd, f"{p}.output.LayerNorm", f"{q}.ff_norm"))
    return out


# --------------------------------------------------------------------------
# DeepSeek-V2 (a decoder LLM as the query tower)
# --------------------------------------------------------------------------

_MLA = ("q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm", "kv_b_proj",
        "o_proj")
_SWIGLU = ("gate_proj", "up_proj", "down_proj")


def convert_deepseek_v2(sd: SD, num_layers: int) -> Out:
    """HF ``DeepseekV2ForCausalLM`` / ``DeepseekV2Model`` -> the port's
    ``DeepseekV2Model`` over its first ``num_layers`` layers (a pipeline
    stage; the final norm kept, the LM head dropped).  Each MoE layer's
    ``mlp.experts.{e}.{gate,up,down}_proj.weight`` are stacked over ``e``
    into ``mlp.experts.{gate,up,down}_proj``; a layer is an MoE layer when
    the checkpoint holds its ``mlp.gate.weight``."""
    pre = "model." if "model.embed_tokens.weight" in sd else ""
    out: Out = {"embed_tokens.weight": _t(sd[f"{pre}embed_tokens.weight"]),
                "norm.weight": _t(sd[f"{pre}norm.weight"])}
    for i in range(num_layers):
        p, q = f"{pre}layers.{i}.", f"layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            out[f"{q}{n}.weight"] = _t(sd[f"{p}{n}.weight"])
        for n in _MLA:
            out[f"{q}self_attn.{n}.weight"] = _t(
                sd[f"{p}self_attn.{n}.weight"])
        m, qm = f"{p}mlp.", f"{q}mlp."
        if f"{m}gate.weight" not in sd:
            for n in _SWIGLU:
                out[f"{qm}{n}.weight"] = _t(sd[f"{m}{n}.weight"])
            continue
        out[f"{qm}gate.weight"] = _t(sd[f"{m}gate.weight"])
        n_exp = 0
        while f"{m}experts.{n_exp}.gate_proj.weight" in sd:
            n_exp += 1
        for n in _SWIGLU:
            out[f"{qm}experts.{n}"] = torch.stack(
                [_t(sd[f"{m}experts.{e}.{n}.weight"]) for e in range(n_exp)])
            out[f"{qm}shared_experts.{n}.weight"] = _t(
                sd[f"{m}shared_experts.{n}.weight"])
    return out


def split_ar2_checkpoint(sd: SD) -> Dict[str, Dict[str, object]]:
    """AR2/DPR dict with ``ctx_model.`` / ``question_model.`` prefixes ->
    two plain BERT state dicts (``document_encoder.py:160-178``)."""
    towers = {"ctx_model.": {}, "question_model.": {}}
    for k, v in sd.items():
        for prefix, bucket in towers.items():
            if k.startswith(prefix):
                bucket[k[len(prefix):]] = v
    return {"passage": towers["ctx_model."],
            "query": towers["question_model."]}


def convert_tower(sd: SD, family: str, num_layers: int) -> Out:
    """A twin tower's state dict (T5 12 + 12, BERT, or the first
    ``num_layers`` of DeepSeek-V2) from an HF dict."""
    if family == "t5":
        return convert_t5_model(sd, num_layers, num_layers)
    if family == "deepseek_v2":
        return convert_deepseek_v2(sd, num_layers)
    return convert_bert_model(sd, num_layers)


def init_nci_from_pretrained_t5(nci_sd: SD, t5_sd: SD, num_layers: int,
                                gated: bool = False) -> Out:
    """Graft a pretrained T5's shared embedding and encoder into an NCI
    state dict (``--pretrain_encoder``, ``main_models.py:1390-1397``:
    only ``shared.`` / ``encoder.`` weights copy over; the decode side
    stays as it is)."""
    out = {k: _t(v) for k, v in nci_sd.items()
           if not k.startswith(("shared.", "encoder."))}
    out["shared.weight"] = _t(t5_sd["shared.weight"])
    out.update(convert_t5_stack(t5_sd, "encoder", num_layers, gated))
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file's tensors, on the host (the ``model_dict``
    / ``state_dict`` / ``model`` entry of a wrapper dict when present).
    Reference ``.pkl`` / Lightning files hold more than tensors, so the
    file is unpickled in full: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: _t(v) for k, v in obj.items() if hasattr(v, "shape")}


def hf_module_state_dict(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}
