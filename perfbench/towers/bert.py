"""The BERT query tower (AR2): a post-LayerNorm encoder, the
representation the CLS (token 0) state (``cls_rep``)."""

from perfbench import counts

TINY = {"family": "bert", "rep": "cls_rep", "vocab_size": 120,
        "d_model": 64, "num_layers": 2, "num_heads": 4, "d_ff": 128,
        "max_position_embeddings": 16, "type_vocab_size": 4,
        "layer_norm_epsilon": 1e-12, "initializer_range": 0.02}


def build(c, W, dev, dtype):
    from mevi_tpu_torch.models.bert import BertDims, BertEncoderModel
    tower = BertEncoderModel(BertDims(
        vocab_size=c["vocab_size"], d_model=c["d_model"],
        num_layers=c["num_layers"], num_heads=c["num_heads"],
        d_ff=c["d_ff"], max_position_embeddings=c["max_position_embeddings"],
        type_vocab_size=c["type_vocab_size"],
        layer_norm_epsilon=c["layer_norm_epsilon"], dropout_rate=0.0,
        dtype=dtype), device=dev, dtype=dtype)
    tower.load_state_dict(W)
    return tower.cls_rep


def flops(lengths, c):
    return sum(c["num_layers"] * counts.encoder_layer_flops(
        int(l), c["d_model"], c["d_ff"]) for l in lengths)
