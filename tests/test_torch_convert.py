"""Port parity: ``mevi_tpu_torch.models.convert`` against
``mevi_tpu.models.convert``.  Every converted state dict equals the
port's weight bridge (``weights.flax_to_state_dict``) applied to the JAX
converter's flax params, bit for bit, and loads strictly into the
port's module.  Inputs: HF ``T5Model`` / ``BertModel`` state dicts from
``transformers`` configs at random init (no download), and a
reference-layout NCI dict with PAWA built from numpy."""

import numpy as np
import pytest
import torch
from flax import traverse_util

from mevi_tpu.models import convert as jconv
from mevi_tpu_torch.models import convert as tconv
from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
from mevi_tpu_torch.models.nci import NCIDims, NCIT5
from mevi_tpu_torch.models.t5 import T5Dims, T5EncoderModel, T5Model
from mevi_tpu_torch.weights import flax_to_state_dict

transformers = pytest.importorskip("transformers")

D, H, FF, V = 32, 4, 64, 96


def bridged(params):
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    return flax_to_state_dict(flat)


def assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def np_sd(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def hf_t5():
    torch.manual_seed(0)
    cfg = transformers.T5Config(vocab_size=V, d_model=D, d_kv=8, d_ff=FF,
                                num_heads=H, num_layers=2,
                                num_decoder_layers=1, dropout_rate=0.0,
                                feed_forward_proj="relu")
    return transformers.T5Model(cfg).eval().state_dict()


@pytest.fixture(scope="module")
def hf_t5_gated():
    torch.manual_seed(1)
    cfg = transformers.T5Config(vocab_size=V, d_model=D, d_kv=8, d_ff=FF,
                                num_heads=H, num_layers=1,
                                num_decoder_layers=1, dropout_rate=0.0,
                                feed_forward_proj="gated-gelu")
    return transformers.T5Model(cfg).eval().state_dict()


def t5_dims(**kw):
    return T5Dims(vocab_size=V, d_model=D, d_kv=8, d_ff=FF, num_heads=H,
                  **kw)


def test_convert_t5_model(hf_t5):
    got = tconv.convert_t5_model(hf_t5, 2, 1)
    assert_bit_equal(got, bridged(jconv.convert_t5_model(np_sd(hf_t5), 2,
                                                         1)))
    # numpy inputs give the same tensors
    assert_bit_equal(tconv.convert_t5_model(np_sd(hf_t5), 2, 1), got)
    T5Model(t5_dims(num_layers=2, num_decoder_layers=1),
            device="cpu").load_state_dict(got, strict=True)


def test_convert_t5_gated_and_encoder(hf_t5_gated):
    got = tconv.convert_t5_model(hf_t5_gated, 1, 1, gated=True)
    assert_bit_equal(got, bridged(jconv.convert_t5_model(
        np_sd(hf_t5_gated), 1, 1, gated=True)))
    enc = tconv.convert_t5_encoder_model(hf_t5_gated, 1, gated=True)
    assert_bit_equal(enc, bridged(jconv.convert_t5_encoder_model(
        np_sd(hf_t5_gated), 1, gated=True)))
    T5EncoderModel(t5_dims(num_layers=1, gated_act=True),
                   device="cpu").load_state_dict(enc, strict=True)


@pytest.mark.parametrize("old_ln_names", [False, True])
def test_convert_bert_model(old_ln_names):
    torch.manual_seed(2)
    cfg = transformers.BertConfig(vocab_size=V, hidden_size=D,
                                  num_hidden_layers=2, num_attention_heads=H,
                                  intermediate_size=FF,
                                  max_position_embeddings=16)
    sd = transformers.BertModel(cfg, add_pooling_layer=False).state_dict()
    if old_ln_names:      # LayerNorm.{gamma,beta} of old checkpoints
        sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
               .replace("LayerNorm.bias", "LayerNorm.beta"): v
              for k, v in sd.items()}
    got = tconv.convert_bert_model(sd, 2)
    assert_bit_equal(got, bridged(jconv.convert_bert_model(np_sd(sd), 2)))
    BertEncoderModel(BertDims(vocab_size=V, d_model=D, num_layers=2,
                              num_heads=H, d_ff=FF,
                              max_position_embeddings=16),
                     device="cpu").load_state_dict(got, strict=True)


def reference_nci(hf_sd, kary, L, adaptor_layers, seed=3):
    """A reference Lightning NCI dict ('model.' prefix on): the T5 part
    from HF, decode embeddings, the torch TransformerDecoder adaptor and
    ``adaptor_linear`` from numpy."""
    rng = np.random.default_rng(seed)
    V_dec = kary * L + 2
    sd = {f"model.{k}": v.numpy() for k, v in hf_sd.items()}

    def put(name, *shape):
        sd[f"model.{name}"] = rng.normal(size=shape).astype(np.float32)
    put("decode_embeddings.weight", V_dec, D)
    put("adaptor_linear.weight", D * V_dec, D)
    put("adaptor_embeddings", D)
    for i in range(adaptor_layers):
        p = f"adaptor.layers.{i}"
        for att in ("self_attn", "multihead_attn"):
            put(f"{p}.{att}.in_proj_weight", 3 * D, D)
            put(f"{p}.{att}.in_proj_bias", 3 * D)
            put(f"{p}.{att}.out_proj.weight", D, D)
            put(f"{p}.{att}.out_proj.bias", D)
        for n in ("norm1", "norm2", "norm3"):
            put(f"{p}.{n}.weight", D)
            put(f"{p}.{n}.bias", D)
        put(f"{p}.linear1.weight", FF, D)
        put(f"{p}.linear1.bias", FF)
        put(f"{p}.linear2.weight", D, FF)
        put(f"{p}.linear2.bias", D)
    return sd


def test_convert_nci_checkpoint_with_pawa(hf_t5, tmp_path):
    """A reference checkpoint file -> load_torch_state_dict -> the
    converter, bit-equal to JAX's, loadable strictly into the port's
    NCIT5 (PAWA's packed in_proj as the reference stores it)."""
    kary, L = 3, 4
    ref = reference_nci(hf_t5, kary, L, 2)
    path = str(tmp_path / "nci.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in ref.items()}, "epoch": 3}, path)
    sd = tconv.load_torch_state_dict(path)
    jsd = jconv.load_torch_state_dict(path)
    assert set(sd) == set(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k])
    sd = {k[len("model."):]: v for k, v in sd.items()}
    jsd = {k[len("model."):]: v for k, v in jsd.items()}
    got = tconv.convert_nci_checkpoint(sd, 2, 1, 2)
    assert_bit_equal(got, bridged(jconv.convert_nci_checkpoint(jsd, 2, 1,
                                                               2)))
    dims = NCIDims(t5=t5_dims(num_layers=2, num_decoder_layers=1),
                   kary=kary, max_output_length=L, adaptor_layer_num=2,
                   adaptor_num_heads=H, adaptor_d_ff=FF)
    NCIT5(dims, device="cpu").load_state_dict(got, strict=True)


def test_reserve_decoder_loads_into_the_port(hf_t5):
    """``reserve_decoder``: the frozen 12-layer tower decoder is an HF
    decoder stack (self, cross, FF).  The JAX converter reads it as an
    encoder stack (no cross-attention, the FF at layer.1); the port reads
    it as the decoder it is, and the result loads strictly."""
    torch.manual_seed(4)
    cfg = transformers.T5Config(vocab_size=V, d_model=D, d_kv=8, d_ff=FF,
                                num_heads=H, num_layers=2,
                                num_decoder_layers=12, dropout_rate=0.0,
                                feed_forward_proj="relu")
    tower = transformers.T5Model(cfg).state_dict()
    sd = {k[len("model."):]: torch.from_numpy(v)
          for k, v in reference_nci(hf_t5, 3, 4, 1).items()}
    sd.update({k.replace("decoder.", "ori_decoder.", 1): v
               for k, v in tower.items() if k.startswith("decoder.")})
    got = tconv.convert_nci_checkpoint(sd, 2, 1, 1, reserve_decoder=True)
    dims = NCIDims(t5=t5_dims(num_layers=2, num_decoder_layers=1), kary=3,
                   max_output_length=4, adaptor_layer_num=1,
                   adaptor_num_heads=H, adaptor_d_ff=FF,
                   reserve_decoder=True)
    NCIT5(dims, device="cpu").load_state_dict(got, strict=True)
    assert torch.equal(got["ori_decoder.blocks.11.cross_attn.q.weight"],
                       tower["decoder.block.11.layer.1.EncDecAttention.q"
                             ".weight"])


def test_split_ar2_and_pretrained_graft(hf_t5):
    sd = {"ctx_model.a.weight": torch.ones(2),
          "question_model.a.weight": torch.zeros(2), "other": torch.ones(1)}
    got = tconv.split_ar2_checkpoint(sd)
    want = jconv.split_ar2_checkpoint({k: v.numpy() for k, v in sd.items()})
    assert set(got["passage"]) == set(want["passage"]) == {"a.weight"}
    assert set(got["query"]) == set(want["query"]) == {"a.weight"}
    assert torch.equal(got["query"]["a.weight"], torch.zeros(2))
    # --pretrain_encoder: shared + encoder from the T5, the rest kept
    dims = NCIDims(t5=t5_dims(num_layers=2, num_decoder_layers=1), kary=3,
                   max_output_length=4, adaptor_layer_num=1,
                   adaptor_num_heads=H, adaptor_d_ff=FF)
    nci = NCIT5(dims, device="cpu")
    grafted = tconv.init_nci_from_pretrained_t5(nci.state_dict(), hf_t5, 2)
    nci.load_state_dict(grafted, strict=True)
    enc = tconv.convert_t5_stack(hf_t5, "encoder", 2)
    for k, v in enc.items():
        assert torch.equal(nci.state_dict()[k], v)
    assert torch.equal(nci.shared.weight, hf_t5["shared.weight"])
    assert torch.equal(grafted["decode_embeddings.weight"],
                       nci.decode_embeddings.weight)
