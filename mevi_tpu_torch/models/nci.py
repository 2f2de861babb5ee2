"""NCI seq2seq model (port of ``mevi_tpu.models.nci``): T5 with a
position-sliced code vocabulary and the PAWA adaptive LM head.

Decode vocab ``V = kary * max_output_length + 2`` (0 pad/start, 1 eos,
code c of level i at ``2 + i*kary + c``).  Logits are compact,
``(…, kary + 1)`` with columns ``[level-t codes..., EOS]``, and the PAWA
weight delta enters through per-level slabs of the adaptor kernel, so
the ``(d, V)`` per-position weight is never materialized.

Training side: :func:`make_labels`, :func:`compact_labels` and
:func:`compact_to_full_logits`; ``NCIT5.forward`` in ``train()`` mode
applies the T5 and PAWA dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .. import frozen_eval, resolve_device
from .pawa import PawaAdaptor, PawaDims
from .t5 import T5Dims, T5Stack, causal_mask, extend_mask

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class NCIDims:
    t5: T5Dims = dataclasses.field(default_factory=T5Dims)
    kary: int = 32
    max_output_length: int = 6
    adaptor_layer_num: int = 4
    adaptor_num_heads: int = 8
    adaptor_d_ff: int = 2048
    use_pawa: bool = True
    reserve_decoder: bool = False     # frozen 12-layer tower decoder
    tie_decode_embedding: bool = True

    @property
    def decode_vocab_size(self) -> int:
        return self.kary * self.max_output_length + 2

    @property
    def code_len(self) -> int:
        return self.max_output_length - 2

    @property
    def compact_width(self) -> int:
        return self.kary + 1

    def pawa_dims(self) -> PawaDims:
        return PawaDims(d_model=self.t5.d_model,
                        num_heads=self.adaptor_num_heads,
                        d_ff=self.adaptor_d_ff,
                        num_layers=self.adaptor_layer_num,
                        dropout_rate=self.t5.dropout_rate)


def codes_to_tokens(codes: torch.Tensor, kary: int) -> torch.Tensor:
    """(…, M) codes -> decode-vocab token ids (position offset + 2)."""
    offs = torch.arange(codes.shape[-1], dtype=codes.dtype,
                        device=codes.device) * kary
    return codes + offs + 2


def tokens_to_codes(tokens: torch.Tensor, kary: int) -> torch.Tensor:
    """Inverse of :func:`codes_to_tokens`."""
    offs = torch.arange(tokens.shape[-1], dtype=tokens.dtype,
                        device=tokens.device) * kary
    return (tokens - 2 - offs).clamp(min=0)


def make_labels(codes: torch.Tensor, kary: int, max_output_length: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes (b, M) -> (labels (b, L), decoder_input_ids (b, L)), int32:
    labels = [code tokens..., eos, pad]; inputs = the shift right with
    start token 0."""
    b = codes.shape[0]
    toks = codes_to_tokens(codes.to(torch.int32), kary)
    eos = torch.ones((b, 1), dtype=torch.int32, device=codes.device)
    labels = torch.cat([toks, eos, eos - 1], 1)
    inputs = torch.cat([eos - 1, toks, eos], 1)
    if labels.shape[1] != max_output_length:
        raise ValueError(f"codes of {codes.shape[1]} levels do not fill "
                         f"max_output_length {max_output_length}")
    return labels, inputs


def compact_labels(codes: torch.Tensor, dims: "NCIDims") -> torch.Tensor:
    """Labels in compact-column space, (b, L) int32: position t < M is
    the code (column index), position M is ``kary`` (the EOS column) and
    position M+1 is -100 (ignored: the padded slot)."""
    b = codes.shape[0]
    col = torch.full((b, 1), dims.kary, dtype=torch.int32,
                     device=codes.device)
    return torch.cat([codes.to(torch.int32), col, col * 0 - 100], 1)


def compact_to_full_logits(compact: torch.Tensor, dims: "NCIDims",
                           fill: float = NEG) -> torch.Tensor:
    """Expand (b, L, kary+1) compact logits to the reference's
    full-vocab masked layout (b, L, V), for parity checks."""
    b, L, _ = compact.shape
    K = dims.kary
    full = torch.full((b, L, dims.decode_vocab_size), fill,
                      dtype=compact.dtype, device=compact.device)
    for t in range(L):
        full[:, t, 2 + t * K:2 + (t + 1) * K] = compact[:, t, :K]
    full[:, :, 1] = compact[:, :, K]
    return full


def _last_position_mask(K: int, device) -> torch.Tensor:
    """Added at the final position: only EOS may score."""
    m = torch.zeros(K + 1, dtype=torch.float32, device=device)
    m[:K] = NEG
    return m


class NCIT5(nn.Module):
    def __init__(self, dims: NCIDims, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.dims = dims
        t5 = dims.t5
        kw = dict(device=dev, dtype=dtype)
        self.shared = nn.Embedding(t5.vocab_size, t5.d_model, **kw)
        self.encoder = T5Stack(t5, t5.num_layers, False, **kw)
        self.decode_embeddings = nn.Embedding(dims.decode_vocab_size,
                                              t5.d_model, **kw)
        self.decoder = T5Stack(t5, t5.num_decoder_layers, True, **kw)
        if dims.use_pawa:
            self.pawa = PawaAdaptor(dims.pawa_dims(), device=dev,
                                    dtype=dtype)
            # (d_in, d*V), only ever used through per-level slabs
            self.adaptor_kernel = nn.Parameter(torch.empty(
                t5.d_model, t5.d_model * dims.decode_vocab_size, **kw))
            nn.init.normal_(self.adaptor_kernel, 0.0, t5.d_model ** -0.5)
        if not dims.tie_decode_embedding:
            self.untied_head = nn.Parameter(torch.randn(
                dims.decode_vocab_size, t5.d_model, **kw))
        if dims.reserve_decoder:
            self.ori_decoder = T5Stack(t5, 12, True, **kw)
        frozen_eval(self)

    # -- encoder ---------------------------------------------------------

    def encode(self, input_ids, attention_mask=None):
        return self.encoder(self.shared(input_ids.long()),
                            self_mask=extend_mask(attention_mask))

    def build_memory(self, enc_hidden, attention_mask=None):
        """Returns (memory, memory_mask, ori_dec_hidden); with
        ``reserve_decoder`` the memory is the encoder states plus the
        frozen tower decoder's token-0 state."""
        ori_hidden = None
        memory, mem_mask = enc_hidden, attention_mask
        if self.dims.reserve_decoder:
            b = enc_hidden.shape[0]
            zero = torch.zeros((b, 1), dtype=torch.long,
                               device=enc_hidden.device)
            ori_hidden = self.ori_decoder(
                self.shared(zero), self_mask=None, enc_hidden=enc_hidden,
                enc_mask=extend_mask(attention_mask))
            memory = torch.cat([enc_hidden, ori_hidden], 1)
            if attention_mask is not None:
                mem_mask = torch.cat(
                    [attention_mask, torch.ones_like(attention_mask[:, :1])],
                    1)
        return memory, mem_mask, ori_hidden

    # -- decode side -----------------------------------------------------

    def _head_matrix(self):
        if self.dims.tie_decode_embedding:
            return self.decode_embeddings.weight
        return self.untied_head

    def head_level_tables(self):
        """Per-level packed LM-head tables, built once per params.
        Level t's columns are [level-t codes (K), EOS]:

          W_lvl: (L, K+1, d)          tied-head rows
          A_lvl: (L, d_in, d*(K+1))   PAWA weight-delta slabs (or None)
        """
        d = self.dims
        K, L = d.kary, d.max_output_length
        W = self._head_matrix()
        W_lvl = torch.stack([
            torch.cat([W[2 + t * K:2 + (t + 1) * K], W[1:2]], 0)
            for t in range(L)])
        A_lvl = None
        if d.use_pawa:
            dm = d.t5.d_model
            A = self.adaptor_kernel.reshape(dm, dm, d.decode_vocab_size)
            A_lvl = torch.stack([
                torch.cat([A[:, :, 2 + t * K:2 + (t + 1) * K], A[:, :, 1:2]],
                          -1).reshape(dm, dm * (K + 1))
                for t in range(L)])
        return W_lvl, A_lvl

    def pawa_prefix_tables(self, level_tables=None,
                           max_entries: int = 1 << 17):
        """Per-prefix PAWA tables for the serving beam.

        PAWA's input is only the decode-token embeddings, so its hidden
        state at position t is a function of the code prefix
        (c0..c_{t-1}).  For every level 1 <= t <= M-2 (the net still runs
        at t = M-1 to write the entry the EOS step attends):

          T[t]  (K^t, dm*(K+1)): the logits-delta slab ``H_t @ A_t``, so
                the step's adaptor matmul becomes a row gather;
          KV[p] the cache entry the net would write at position p, a
                tuple over layers of ``(k, v)`` of shape (K^p, h, dk)
                (rows-major: a row gather of every leaf is the entry).

        Plus ``delta0`` (dm*(K+1),) and ``e0`` (the 1-row entry) for the
        universal start position.  One K^(M-2)-row panel run and one
        matmul a level, once per params.  Raises ``ValueError`` when
        ``kary^(M-2) > max_entries``: partial coverage is not supported
        (the beam would lack entries at its live steps), and the caller
        serves through the plain beam instead.
        """
        d = self.dims
        if not d.use_pawa:
            raise ValueError("pawa_prefix_tables: the model has no PAWA")
        K, M = d.kary, d.code_len
        A_lvl = (self.head_level_tables() if level_tables is None
                 else level_tables)[1]
        t_top = 0
        while t_top < M - 2 and K ** (t_top + 1) <= max_entries:
            t_top += 1
        if t_top < M - 2:
            raise ValueError(
                f"pawa_prefix_tables: kary^{M - 2} = {K ** (M - 2)} "
                f"exceeds max_entries={max_entries}; partial prefix "
                "tables are unsupported — use the plain beam path "
                "(pawa_tables=None)")
        # every K^t_top prefix as tokens [start, tok(c0), ...]; a lower
        # level's rows are the slice whose later codes are all 0
        n = K ** t_top
        dev = self.decode_embeddings.weight.device
        idx = torch.arange(n, device=dev)
        codes = torch.stack([(idx // K ** (t_top - 1 - lvl)) % K
                             for lvl in range(t_top)], 1) if t_top else \
            torch.zeros((n, 0), dtype=torch.long, device=dev)
        seqs = torch.cat([torch.zeros((n, 1), dtype=torch.long, device=dev),
                          codes_to_tokens(codes, K)], 1)
        h_all, kvs = self.pawa.panel_with_kvs(self.decode_embeddings(seqs))
        nl = kvs.shape[0]
        out = {"T": {}, "KV": {}}
        for t in range(1, t_top + 1):
            rows = (torch.arange(K ** t, device=dev) * K ** (t_top - t)
                    if t < t_top else slice(None))
            out["T"][t] = h_all[rows, t] @ A_lvl[t]
            out["KV"][t] = tuple(
                (kvs[i, 0, rows, t].contiguous(),
                 kvs[i, 1, rows, t].contiguous()) for i in range(nl))
        out["delta0"] = (h_all[:1, 0] @ A_lvl[0])[0]
        out["e0"] = tuple((kvs[i, 0, :1, 0].contiguous(),
                           kvs[i, 1, :1, 0].contiguous()) for i in range(nl))
        return out

    def project_cross_kvs(self, memory):
        """Per-layer decoder cross-attention (k, v), once per query."""
        return self.decoder.project_cross_kvs(memory)

    def _level_logits(self, seq_t, h_t, W_t, A_t):
        """[codes, EOS] logits for one position: seq_t (b, d), h_t (b, d)
        or None.  The PAWA delta is one (b, d) x (d, d*(K+1)) matmul
        contracted with seq_t."""
        K = self.dims.kary
        logits = seq_t @ W_t.T                         # (b, K+1)
        if h_t is not None and A_t is not None:
            tmp = (h_t @ A_t).reshape(-1, self.dims.t5.d_model, K + 1)
            logits = logits + torch.einsum("bdk,bd->bk", tmp, seq_t)
        return logits

    def _decoder_panel(self, decoder_input_ids, memory, memory_mask,
                       cross_kvs):
        L = decoder_input_ids.shape[1]
        dec_embeds = self.decode_embeddings(decoder_input_ids.long())
        dec_hidden = self.decoder(
            dec_embeds, self_mask=causal_mask(L, dec_embeds.device),
            enc_hidden=memory, enc_mask=extend_mask(memory_mask),
            cross_kvs=cross_kvs)
        return dec_embeds, dec_hidden

    def compact_logits(self, decoder_input_ids, memory, memory_mask=None,
                       cross_kvs=None):
        """Compact logits (b, L, kary+1) + decoder hidden (b, L, d)."""
        d = self.dims
        K = d.kary
        L = decoder_input_ids.shape[1]
        dec_embeds, dec_hidden = self._decoder_panel(
            decoder_input_ids, memory, memory_mask, cross_kvs)
        seq = dec_hidden * (d.t5.d_model ** -0.5)
        W_lvl, A_lvl = self.head_level_tables()
        logits = torch.einsum("bld,lkd->blk", seq, W_lvl[:L])
        if d.use_pawa:
            h_a = self.pawa(dec_embeds)
            dm = d.t5.d_model
            b = seq.shape[0]
            tmp = torch.einsum("bli,lix->blx", h_a, A_lvl[:L])
            logits = logits + torch.einsum(
                "bldk,bld->blk", tmp.reshape(b, L, dm, K + 1), seq)
        pos_mask = torch.zeros(L, K + 1, device=logits.device)
        pos_mask[L - 1] = _last_position_mask(K, logits.device)
        return logits + pos_mask[None], dec_hidden

    def compact_logits_at(self, decoder_input_ids, t: int, memory,
                          memory_mask=None, cross_kvs=None,
                          level_tables=None):
        """Compact logits for one position ``t`` of the panel
        (the panel beam's step).  Returns (logits (b, kary+1),
        dec_hidden (b, L, d))."""
        d = self.dims
        K = d.kary
        L = decoder_input_ids.shape[1]
        dec_embeds, dec_hidden = self._decoder_panel(
            decoder_input_ids, memory, memory_mask, cross_kvs)
        seq_t = dec_hidden[:, t] * (d.t5.d_model ** -0.5)
        h_t = self.pawa(dec_embeds)[:, t] if d.use_pawa else None
        W_t, A_t = self._tables_at(t, level_tables)
        logits = self._level_logits(seq_t, h_t, W_t, A_t)
        if t == L - 1:
            logits = logits + _last_position_mask(K, logits.device)[None]
        return logits, dec_hidden

    def _tables_at(self, t, level_tables):
        if level_tables is None:
            level_tables = self.head_level_tables()
        W_lvl, A_lvl = level_tables
        return W_lvl[t], (None if A_lvl is None else A_lvl[t])

    def init_decode_state(self, batch: int, dtype=None):
        """(decoder cache, PAWA cache, PAWA memory constants) for the
        dynamic-``t`` step over a batch of ``batch`` rows."""
        L = self.dims.max_output_length
        dec_cache = self.decoder.init_cache(batch, L, dtype)
        pawa_cache = pawa_mem = None
        if self.dims.use_pawa:
            pawa_cache = self.pawa.init_cache(batch, L, dtype)
            pawa_mem = self.pawa.precompute_mem_kvs(dtype)
        return dec_cache, pawa_cache, pawa_mem

    def decode_logits_step(self, tok_t, t, dec_cache, pawa_cache, cross_kvs,
                           pawa_mem, memory_mask=None, beams: int = 1,
                           level_tables=None):
        """Single-token decode at position ``t`` (int or 0-d tensor)
        through the preallocated caches of :meth:`init_decode_state`,
        written in place.  With ``beams > 1``, ``cross_kvs`` /
        ``memory_mask`` are per query (``b // beams`` rows).
        ``level_tables``: the full ``head_level_tables()`` output.
        Returns (compact logits (b, kary+1), dec_cache, pawa_cache)."""
        d = self.dims
        K, L = d.kary, d.max_output_length
        embed_t = self.decode_embeddings(tok_t.long())
        hidden_t, dec_cache = self.decoder.decode_step(
            embed_t, t, dec_cache, cross_kvs, extend_mask(memory_mask),
            beams=beams)
        seq_t = hidden_t[:, 0, :] * (d.t5.d_model ** -0.5)
        h_t = None
        if d.use_pawa:
            h_t, pawa_cache = self.pawa.decode_step(embed_t, t, pawa_cache,
                                                    pawa_mem)
            h_t = h_t[:, 0, :]
        W_t, A_t = self._tables_at(t, level_tables)
        logits = self._level_logits(seq_t, h_t, W_t, A_t)
        last = torch.as_tensor(t, device=logits.device) == L - 1
        logits = logits + torch.where(
            last, _last_position_mask(K, logits.device),
            torch.zeros(K + 1, device=logits.device))[None]
        return logits, dec_cache, pawa_cache

    def decode_logits_step_unrolled(self, tok_t, t: int, dec_entries,
                                    pawa_entries, cross_kvs,
                                    memory_mask=None, beams: int = 1,
                                    level_tables=None,
                                    pawa_mem: Optional[list] = None,
                                    delta_slab=None):
        """Single-token decode at python-int ``t`` over per-position
        entry lists (see ``T5Stack.decode_step_unrolled``).
        ``level_tables``: the full ``head_level_tables()`` output.
        ``delta_slab``: precomputed PAWA logits-delta rows from
        :meth:`pawa_prefix_tables`, (b, dm*(K+1)) gathered by prefix or
        (dm*(K+1),) for the universal position 0; when given, the PAWA
        net and its (rows, dm) x (dm, dm*(K+1)) matmul are skipped.
        Returns (compact logits (b, kary+1), new dec entry, new pawa
        entry or None)."""
        d = self.dims
        K, L = d.kary, d.max_output_length
        dm = d.t5.d_model
        embed_t = self.decode_embeddings(tok_t.long())
        hidden_t, dec_e = self.decoder.decode_step_unrolled(
            embed_t, t, dec_entries, cross_kvs, extend_mask(memory_mask),
            beams=beams)
        seq_t = hidden_t[:, 0, :] * (dm ** -0.5)
        h_t, pawa_e = None, None
        if d.use_pawa and delta_slab is None:
            h_t, pawa_e = self.pawa.decode_step_unrolled(
                embed_t, t, pawa_entries, pawa_mem)
            h_t = h_t[:, 0, :]
        W_t, A_t = self._tables_at(t, level_tables)
        logits = self._level_logits(seq_t, h_t, W_t, A_t)
        if delta_slab is not None:
            if delta_slab.dim() == 1:          # universal start position
                logits = logits + seq_t @ delta_slab.reshape(
                    dm, K + 1).to(seq_t.dtype)
            else:
                tmp = delta_slab.reshape(-1, dm, K + 1).to(seq_t.dtype)
                logits = logits + torch.einsum("bdk,bd->bk", tmp, seq_t)
        if t == L - 1:
            logits = logits + _last_position_mask(K, logits.device)[None]
        return logits, dec_e, pawa_e

    def forward(self, input_ids, attention_mask, decoder_input_ids):
        """Returns (compact_logits, enc_hidden, dec_hidden, ori_hidden)."""
        enc_hidden = self.encode(input_ids, attention_mask)
        memory, mem_mask, ori_hidden = self.build_memory(enc_hidden,
                                                         attention_mask)
        logits, dec_hidden = self.compact_logits(decoder_input_ids, memory,
                                                 mem_mask)
        return logits, enc_hidden, dec_hidden, ori_hidden
