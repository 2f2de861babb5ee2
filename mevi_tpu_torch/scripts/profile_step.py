"""The per-step decode cost taken apart (port of
``scripts/profile_step.py``), at the serving shapes (T5-base NCI 12 + 6,
d 768, bf16, batch ``B`` = 512 x 10 beams: R = 5,120 rows):

  matmul_calib   5 x 30 (R, 768) x (768, 768) matmuls with tanh (the
                 per-op floor, and the rate the card reaches on them)
  dec_only       5 decoder steps, no PAWA, no head
  dec_head       + the level-table head (no PAWA)
  full           decoder + PAWA + head (the serving step)

Each variant runs as a loop of 5 iterations, enqueued back to back and
synchronized once, timed by CUDA events; the decode variants subtract
the shared prologue (encoder + cross K/V), timed alone.

    python -m mevi_tpu_torch.scripts.profile_step [--device cuda|cpu]

Prints one line a variant, then one JSON line.  On the CPU the model is
tiny (2 + 2 layers, d 32, batch 4, float32) and the host clock times it.
The JAX script scans its 5 iterations inside one program (``lax.scan``);
here they are 5 eager iterations, and the JAX compilation cache has no
counterpart.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..models.t5 import extend_mask
from .profile_beam import KARY, M, NB, QLEN, default_batch, serving_nci

ITERS = 5


def _time_ms(fn, dev):
    """ms of one call of ``fn`` (5 calls after one warm-up call)."""
    from ..utils.profiling import sequential_pipelined_ms
    return sequential_pipelined_ms(lambda i: fn(), iters=ITERS,
                                   device=dev)[1]


def profile(device="cuda", B=None):
    dev = resolve_device(device)
    B = B or default_batch(dev, card=512)
    R = B * NB
    ids = torch.ones((B, QLEN), dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    out = {"device": str(dev), "batch": B, "rows": R, "iters": ITERS,
           "variants": {}}

    # ---- calibration: plain matmuls --------------------------------------
    d = 768 if dev.type == "cuda" else 32
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    Ws = torch.ones((30, d, d), dtype=dt, device=dev) * 0.01
    x0 = torch.ones((R, d), dtype=dt, device=dev)

    def matmul_loop():
        x = x0
        for _ in range(ITERS):
            for i in range(30):
                x = torch.tanh(x @ Ws[i])
        return x
    t = _time_ms(matmul_loop, dev)
    tflops = ITERS * 30 * 2 * R * d * d / (t / 1e3) / 1e12
    out["variants"]["matmul_calib"] = {"ms": t, "tflop_s": tflops}
    print(f"calib: {ITERS} x 30 (R={R},{d})x({d},{d}) matmuls: {t:.1f} ms "
          f"({tflops:.1f} TFLOP/s)", flush=True)

    for name, use_pawa, head in (("dec_only", False, False),
                                 ("dec_head", False, True),
                                 ("full", True, True)):
        model = serving_nci(dev, use_pawa=use_pawa)
        tables = model.head_level_tables()

        @torch.inference_mode()
        def prologue():
            enc = model.encode(ids, mask)
            return model.project_cross_kvs(enc)

        @torch.inference_mode()
        def steps():
            kvs = prologue()
            dec_cache, pawa_cache, pawa_mem = model.init_decode_state(R)
            tok = torch.zeros((R, 1), dtype=torch.int32, device=dev)
            total = 0.0
            for t in range(M + 1):
                if head:
                    logits, dec_cache, pawa_cache = model.decode_logits_step(
                        tok, t, dec_cache, pawa_cache, kvs, pawa_mem, mask,
                        beams=NB, level_tables=tables)
                else:
                    h, dec_cache = model.decoder.decode_step(
                        model.decode_embeddings(tok.long()), t, dec_cache,
                        kvs, extend_mask(mask), beams=NB)
                    logits = h[:, 0, :KARY]
                nxt = logits[:, :KARY].argmax(-1).to(torch.int32)
                tok = nxt[:, None] + t * KARY + 2
                total = total + logits.float().sum()
            return total

        tp = _time_ms(prologue, dev)
        ts = _time_ms(steps, dev)
        row = {"prologue_ms": tp, "ms": ts, "steps_only_ms": ts - tp,
               "ms_a_step": (ts - tp) / (M + 1)}
        out["variants"][name] = row
        print(f"{name}: enc-prologue {tp:.1f} ms; {M + 1} steps {ts:.1f} ms "
              f"(steps-only {ts - tp:.1f} ms, {(ts - tp) / (M + 1):.1f} "
              f"ms/step)", flush=True)
        del model
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = profile(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
