"""Synthetic hierarchical corpus and query language (port of
``mevi_tpu.data.synth``): the corpus ``bench.py`` serves and
``scripts/quality_full.py`` trains on.

* **corpus**: a 3-level shared-sons hierarchy (per-level Zipf skew) plus
  a leaf-noise pool; a document is 4 small ints (h1, h2, h3, pool row),
  so corpus-scale matrices are made on the device from MB-scale tables,
  never on the host.  Rows are unit-norm: max inner product is nearest
  L2, the objective of the L2-fit RQ index.
* **query language**: a query names its document through info tokens
  (the 3 hierarchy choices and the pool row in base-kary digits) at
  spec-fixed positions among fresh random filler tokens.

The host parts (``SynthSpec``, ``make_tables``, ``make_draws``,
``info_positions``, ``query_tokens``, the spec files) are the JAX
package's numpy, byte for byte: one seed gives the same tables, draws
and tokens in both packages.  The device parts run in torch.  The RQ fit
draws from a ``torch.Generator``, so its codebooks are not the JAX
package's; its cache therefore lives under a base of its own
(``mevi_tpu_torch_synth`` in the temporary directory), never under the
JAX package's ``/tmp/mevi_synth``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from .. import as_device_tensor, resolve_device
from ..ops import rq as rq_ops


def default_cache_base() -> str:
    return os.path.join(tempfile.gettempdir(), "mevi_tpu_torch_synth")


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """Deterministic description of a synthetic corpus + query language.

    Everything (tables, draws, tokens) is derived from ``seed``; two
    processes with the same spec reconstruct identical corpora.
    """
    ndoc: int = 1_000_000
    d: int = 768
    kary: int = 32                 # RQ centroids/level AND digit base
    levels: int = 4                # RQ levels (M)
    pool_n: int = 32 ** 3          # leaf-noise pool rows (3 digits)
    scales: Tuple[float, ...] = (1.0, 0.42, 0.18)
    zipf: Tuple[float, ...] = (1.1, 0.8, 0.5)
    eps: float = 0.06              # leaf-noise per-component std
    seed: int = 0
    qlen: int = 32                 # query tokens
    n_filler_vocab: int = 256
    info_dropout: float = 0.0      # P(info token replaced by filler)

    @property
    def n_info(self) -> int:
        return 3 + self._row_digits

    @property
    def _row_digits(self) -> int:
        n, k = 1, self.kary
        while k ** n < self.pool_n:
            n += 1
        return n

    @property
    def vocab_size(self) -> int:
        """0 = pad/start; 1 = unused; then per-slot info regions, then
        fillers; rounded up to a multiple of 128."""
        v = 2 + self.n_info * self.kary + self.n_filler_vocab
        return v + (-v) % 128

    def cache_dir(self, base: Optional[str] = None) -> str:
        key = hashlib.sha1(json.dumps(
            dataclasses.asdict(self), sort_keys=True).encode()).hexdigest()
        return os.path.join(base or default_cache_base(), key[:16])


def make_tables(spec: SynthSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(ctrs (3, kary, d) f32, pool (pool_n, d) f32) on the host, ~MBs;
    move them to the device once and generate rows there."""
    host = np.random.default_rng(spec.seed)
    ctrs = np.stack([
        host.normal(size=(spec.kary, spec.d)).astype(np.float32) * s
        for s in spec.scales])
    pool = (host.standard_normal((spec.pool_n, spec.d))
            * spec.eps).astype(np.float32)
    return ctrs, pool


def make_draws(spec: SynthSpec) -> np.ndarray:
    """(ndoc, 4) int32 [h1, h2, h3, pool_row] with per-level Zipf skew."""
    host = np.random.default_rng(spec.seed + 1)
    draws = np.empty((spec.ndoc, 4), np.int32)
    for j, a in enumerate(spec.zipf):
        p = 1.0 / np.arange(1, spec.kary + 1) ** a
        draws[:, j] = host.choice(spec.kary, size=spec.ndoc, p=p / p.sum())
    draws[:, 3] = host.integers(0, spec.pool_n, spec.ndoc)
    return draws


def tables_to(tables, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (ctrs, pool) tables as float32 tensors on ``device``."""
    return tuple(as_device_tensor(t, device).float() for t in tables)


def gen_rows(tables, draws) -> torch.Tensor:
    """(ctrs (3, K, d), pool) x (n, 4) draws -> (n, d) unit-norm float32
    rows, on the tables' device."""
    ctrs, pool = tables
    dr = as_device_tensor(draws, ctrs.device).long()
    v = (ctrs[0][dr[:, 0]] + ctrs[1][dr[:, 1]] + ctrs[2][dr[:, 2]]
         + pool[dr[:, 3]])
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def fit_rq_codes(spec: SynthSpec, tables, draws: np.ndarray,
                 cache_base: Optional[str] = None,
                 fit_sample: int = 500_000, iters: int = 8,
                 codebooks: Optional[np.ndarray] = None,
                 center_levels: bool = False, prefix_shift=None,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fit RQ (levels x kary) on a sample and assign every doc, on
    ``device``.  Returns (codebooks (M, K, d) f32, codes (ndoc, M) int32)
    as numpy, cached as npy under the spec's cache dir (under
    ``cache_base``, by default the port's own base).  With
    ``center_levels`` the conditioning tables are saved next to the
    codebooks as ``prefix_shift.npz`` (keys l1..l{M-1}); the
    ``codebooks=`` re-assign path takes them back as ``prefix_shift=``.

    The sample rows are the JAX package's (``seed + 7``); the fit draws
    from a ``torch.Generator`` seeded ``seed + 11``; docs are assigned in
    chunks of 2^19 rows with ``ops.rq.assign``.  ``codebooks``: skip the
    fit and assign with these (a trained bundle served over a larger
    corpus of the same family).
    """
    dev = resolve_device(device)
    tables = tables_to(tables, dev)
    cdir = spec.cache_dir(cache_base)
    if center_levels and codebooks is None:
        cdir += "_hrq"
    if codebooks is not None:
        h = hashlib.sha1(np.ascontiguousarray(codebooks))
        for t in prefix_shift or ():
            h.update(np.ascontiguousarray(t))
        cdir += "_cb" + h.hexdigest()[:8]
    cbs_p = os.path.join(cdir, "codebooks.npy")
    codes_p = os.path.join(cdir, "codes.npy")
    if os.path.exists(cbs_p) and os.path.exists(codes_p):
        return np.load(cbs_p), np.load(codes_p)
    shift = (None if prefix_shift is None else
             [as_device_tensor(t, dev).float() for t in prefix_shift])
    if codebooks is not None:
        cbs = as_device_tensor(codebooks, dev).float()
    else:
        fit_rng = np.random.default_rng(spec.seed + 7)
        nfit = min(spec.ndoc, fit_sample)
        sample = gen_rows(tables, draws[fit_rng.choice(
            spec.ndoc, size=nfit, replace=False)])
        gen = torch.Generator(device=dev).manual_seed(spec.seed + 11)
        out = rq_ops.rq_train(sample, spec.levels, spec.kary, iters=iters,
                              generator=gen, center_levels=center_levels,
                              device=dev)
        cbs = out[0].float()
        if center_levels:
            shift = [t.float() for t in out[2]]
        del sample, out
    codes = np.empty((spec.ndoc, spec.levels), np.int32)
    ch = 1 << 19
    for s in range(0, spec.ndoc, ch):
        codes[s:s + ch] = rq_ops.assign(
            gen_rows(tables, draws[s:s + ch]), cbs, "rq", "l2",
            prefix_shift=shift).cpu().numpy()
    cbs_h = cbs.cpu().numpy()
    os.makedirs(cdir, exist_ok=True)
    if center_levels and codebooks is None:
        np.savez(os.path.join(cdir, "prefix_shift.npz"),
                 **{f"l{i + 1}": t.cpu().numpy()
                    for i, t in enumerate(shift)})
    np.save(cbs_p, cbs_h)
    np.save(codes_p, codes)
    return cbs_h, codes


def load_prefix_shift(path: str):
    """Load a prefix_shift.npz (keys l1..l{M-1}) back into the ordered
    per-level list ``assign(prefix_shift=...)`` expects."""
    z = np.load(path)
    return [z[f"l{i + 1}"] for i in range(len(z.files))]


def info_positions(spec: SynthSpec) -> np.ndarray:
    """Spec-fixed scatter of the info slots across the query."""
    host = np.random.default_rng(spec.seed + 3)
    return np.sort(host.choice(spec.qlen, size=spec.n_info,
                               replace=False))


def query_tokens(spec: SynthSpec, draws_rows: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """Tokenize utterances for docs given their (n, 4) draws.

    Filler tokens are fresh per call; info tokens are deterministic.
    ``info_dropout`` > 0 replaces each info token by a random filler with
    that probability.  Returns (n, qlen) int32.
    """
    n = len(draws_rows)
    filler_lo = 2 + spec.n_info * spec.kary
    tok = rng.integers(filler_lo, filler_lo + spec.n_filler_vocab,
                       size=(n, spec.qlen)).astype(np.int32)
    h = draws_rows[:, :3].T
    row = draws_rows[:, 3].astype(np.int64)
    digits = []
    r = row.copy()
    for _ in range(spec._row_digits):
        digits.append(r % spec.kary)
        r //= spec.kary
    info = np.stack(list(h) + digits)          # (n_info, n)
    pos = info_positions(spec)
    for j, p in enumerate(pos):
        tok[:, p] = 2 + j * spec.kary + info[j]
    if spec.info_dropout > 0:
        drop = rng.random((n, len(pos))) < spec.info_dropout
        repl = rng.integers(filler_lo, filler_lo + spec.n_filler_vocab,
                            size=(n, len(pos))).astype(np.int32)
        for j, p in enumerate(pos):
            tok[:, p] = np.where(drop[:, j], repl[:, j], tok[:, p])
    return tok


def quantize_rows(rows: torch.Tensor, q_scale: float) -> torch.Tensor:
    """``clip(round(rows * q_scale), -127, 127)`` as int8 (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(rows * q_scale), -127, 127).to(torch.int8)


def fill_sorted_matrix(spec: SynthSpec, tables, draws: np.ndarray,
                       doc_ids: np.ndarray, n_pad_rows: int, dtype,
                       q_scale: Optional[float] = None, chunk: int = 1 << 16,
                       device="cuda") -> torch.Tensor:
    """The cluster-sorted (CSR-permuted) embedding matrix made on
    ``device``: one preallocated ``(ndoc + n_pad_rows rounded up to 8,
    d)`` buffer of ``dtype``, zero past the corpus, written in place one
    chunk of rows at a time (the last chunk may be short).

    ``doc_ids``: CSR row -> original doc id.  ``q_scale``: when set, the
    rows are ``round(row * q_scale)`` clipped to int8's range.
    """
    dev = resolve_device(device)
    tables = tables_to(tables, dev)
    ndoc = len(doc_ids)
    n_pad = ndoc + n_pad_rows
    n_pad += (-n_pad) % 8
    buf = torch.zeros((n_pad, spec.d), dtype=dtype, device=dev)
    dr_sorted = as_device_tensor(np.asarray(draws)[np.asarray(doc_ids)], dev)
    for s in range(0, ndoc, chunk):
        row = gen_rows(tables, dr_sorted[s:s + chunk])
        if q_scale is not None:
            row = quantize_rows(row, q_scale)
        buf[s:s + row.shape[0]] = row.to(dtype)
    return buf


def rows_abs_max(tables, draws: np.ndarray, chunk: int = 1 << 18,
                 device="cuda") -> float:
    """The largest |component| over every generated row, in one chunked
    pass on ``device`` (the int8 scale of ``bench.py``: ``126 / max``)."""
    dev = resolve_device(device)
    tables = tables_to(tables, dev)
    dr = as_device_tensor(draws, dev)
    m = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, dr.shape[0], chunk):
        m = torch.maximum(m, gen_rows(tables, dr[s:s + chunk]).abs().max())
    return float(m)


def save_spec(spec: SynthSpec, path: str) -> None:
    with open(path, "w") as fw:
        json.dump(dataclasses.asdict(spec), fw, indent=1)


def load_spec(path: str) -> SynthSpec:
    with open(path) as fr:
        return SynthSpec(**json.load(fr))
