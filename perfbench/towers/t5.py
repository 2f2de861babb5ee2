"""The T5 query tower (T5-ANCE): T5 v1.0 encoder and decoder, the
representation the decoder's state at its start token
(``first_token_rep``).  Its relative-attention buckets, their maximum
distance and its norm's epsilon are the configuration's ``tower``
keys."""

from perfbench import counts

TINY = {"family": "t5", "rep": "first_token_rep", "vocab_size": 128,
        "d_model": 64, "d_kv": 16, "d_ff": 128, "num_heads": 4,
        "num_layers": 2, "num_decoder_layers": 2,
        "relative_attention_num_buckets": 32,
        "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-06}


def build(c, W, dev, dtype):
    from mevi_tpu_torch.models.t5 import T5Dims, T5Model
    tower = T5Model(T5Dims(
        vocab_size=c["vocab_size"], d_model=c["d_model"], d_kv=c["d_kv"],
        d_ff=c["d_ff"], num_heads=c["num_heads"],
        num_layers=c["num_layers"],
        num_decoder_layers=c["num_decoder_layers"],
        relative_attention_num_buckets=c["relative_attention_num_buckets"],
        relative_attention_max_distance=c["relative_attention_max_distance"],
        layer_norm_epsilon=c["layer_norm_epsilon"], dropout_rate=0.0,
        dtype=dtype), device=dev, dtype=dtype)
    tower.load_state_dict(W)
    return tower.first_token_rep


def flops(lengths, c):
    d, ff = c["d_model"], c["d_ff"]
    enc = counts.t5_encoder_flops(lengths, c)
    # the start token: self-attn q,k,v,o; cross q,o; feed-forward; cross
    # k,v over l states and attention over them (and over itself)
    row = 8 * d * d + 4 * d * d + 4 * d * ff + 4 * d
    dec = sum(c["num_decoder_layers"] * (row + 4 * int(l) * d * d
                                         + 4 * int(l) * d)
              for l in lengths)
    return enc + dec
