"""Unconstrained T5 generation with a KV cache, the docT5query QG path
(port of ``mevi_tpu.decode.generate``).

The reference generates 10 pseudo-queries per passage with HF sampling
generate (``dataprocess/msmarco_passage/doc2query.py:73-83``: pure
multinomial sampling, ``num_return_sequences=n``).  Here the JAX
package's ``lax.scan`` is a Python loop over ``T5Stack.decode_step``
with preallocated per-layer KV caches and cross-attention K/V computed
once; sampling (temperature / top-k / top-p) or greedy.

The LM head follows t5-base tied-embedding semantics: logits =
(hidden * d_model**-0.5) @ shared_embedding^T, in float32.  Sampling
draws from a caller-supplied ``torch.Generator`` (its stream is not the
JAX package's ``jax.random`` one, so sampled tokens differ from it;
greedy decoding is token for token the same).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import as_device_tensor, resolve_device
from ..models.t5 import T5Model, extend_mask


def _lm_logits(model: T5Model, hidden_t: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (b, d) hidden -> (b, V) float32 logits."""
    scaled = hidden_t * (model.dims.d_model ** -0.5)
    return F.linear(scaled.float(), model.shared.weight.float())


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float
                   ) -> torch.Tensor:
    """HF top_k_top_p_filtering semantics: filtered ids get -1e9."""
    neg = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep ids whose exclusive cumulative probability is <= top_p;
        # the threshold is the smallest kept logit
        keep = (cum - probs) <= top_p
        kth = torch.where(keep, sorted_logits,
                          torch.full_like(sorted_logits, float("inf"))
                          ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, neg, logits)
    return logits


def _device_generator(generator: Optional[torch.Generator],
                      dev: torch.device) -> torch.Generator:
    """A generator on ``dev`` seeded from the caller's (or seed 0)."""
    if generator is not None and generator.device == dev:
        return generator
    seed = 0 if generator is None else int(
        torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=dev).manual_seed(seed)


@torch.inference_mode()
def generate(model: T5Model, input_ids, attention_mask,
             generator: Optional[torch.Generator] = None,
             max_length: int = 64, num_return_sequences: int = 1,
             do_sample: bool = True, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, eos_id: int = 1,
             pad_id: int = 0, device="cuda") -> torch.Tensor:
    """Sample or greedy-decode ``num_return_sequences`` sequences per
    input row.  Returns (b * nret, max_length) int32 token ids on
    ``device``; after a row's EOS only ``pad_id`` follows.  The loop stops
    early once every row has ended (the remaining columns are pad, as the
    JAX package's full-length scan writes them)."""
    dev = resolve_device(device)
    nret = num_return_sequences
    ids = as_device_tensor(input_ids, dev)
    mask = as_device_tensor(attention_mask, dev)
    enc = model.encode(ids, mask).repeat_interleave(nret, 0)
    mask = mask.repeat_interleave(nret, 0)
    b = enc.shape[0]
    cross_kvs = model.decoder.project_cross_kvs(enc)
    cache = model.decoder.init_cache(b, max_length, enc.dtype)
    enc_mask = extend_mask(mask)
    gen = _device_generator(generator, dev) if do_sample else None

    tokens = torch.full((b, max_length + 1), pad_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = 0                                  # decoder start
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(max_length):
        embed_t = model.shared(tokens[:, t:t + 1].long())
        hidden_t, cache = model.decoder.decode_step(embed_t, t, cache,
                                                    cross_kvs, enc_mask)
        logits = _lm_logits(model, hidden_t[:, 0, :])
        if do_sample:
            logits = _filter_logits(logits / temperature, top_k, top_p)
            nxt = torch.multinomial(torch.softmax(logits, -1), 1,
                                    generator=gen)[:, 0]
        else:
            nxt = logits.argmax(-1)
        nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
        finished = finished | (nxt == eos_id)
        tokens[:, t + 1] = nxt.to(torch.int32)
        if bool(finished.all()):
            break
    return tokens[:, 1:]
