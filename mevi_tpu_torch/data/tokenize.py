"""Host-side tokenization producing the reference's memmap formats
(port of ``mevi_tpu.data.tokenize``).

The reference tokenizes the corpus with HF fast tokenizers
(``dataprocess/msmarco_passage/prepare_passage_tokenized.py:50-156``):
``ance`` = t5-base over ``"Title: {t} Text: {c}"``; ``ar2`` =
bert-base-uncased over (title, text) pairs.  Tokenization stays on the
host (offline prep); ``transformers`` is imported only inside
:func:`get_tokenizer`.

Environments without cached HF tokenizer files fail LOUDLY
unless ``allow_hash_fallback=True``, which swaps in the deterministic
:class:`HashTokenizer` stub (tests / smoke runs only — its ids carry no
linguistic meaning).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_TOK_NAMES = {
    "ance": "t5-base",
    "cocondenser": "bert-base-uncased",
    "ar2": "bert-base-uncased",
}
# the stub's id range: the word table of the family each tokenizer feeds
# (t5-base's 32128 rows, bert-base-uncased's 30522)
_HASH_VOCAB = {"t5-base": 32128, "bert-base-uncased": 30522}


class HashTokenizer:
    """Deterministic stand-in exposing the HF call surface used here:
    ``__call__`` / ``batch_encode_plus`` -> {input_ids, attention_mask}
    and ``batch_decode``.  Ids are stable FNV-1a hashes of lowercased
    whitespace words mapped into [num_special, vocab)."""

    def __init__(self, vocab_size: int = 32128, eos_id: int = 1,
                 pad_id: int = 0):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.sep_token = "[SEP]"
        self.is_hash = True
        # word -> id memo (a corpus repeats its words); bounded
        self._ids_of = {}

    @staticmethod
    def _hash(word: str) -> int:
        h = 1469598103934665603
        for b in word.encode("utf-8"):
            h = ((h ^ b) * 1099511628211) & ((1 << 64) - 1)
        return h

    _MEMO_WORDS = 1 << 20

    def _ids(self, text: str) -> List[int]:
        lo, hi = 2, self.vocab_size
        memo, out = self._ids_of, []
        for w in text.split():
            i = memo.get(w)
            if i is None:
                i = lo + self._hash(w.lower()) % (hi - lo)
                if len(memo) < self._MEMO_WORDS:
                    memo[w] = i
            out.append(i)
        return out

    def __call__(self, texts, text_pair=None, max_length: int = 128,
                 truncation: bool = True, padding: str = "max_length",
                 add_special_tokens: bool = True,
                 return_tensors: str = "np", **kw):
        if isinstance(texts, str):
            texts = [texts]
        if text_pair is not None and isinstance(text_pair, str):
            text_pair = [text_pair]
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = self._ids(t)
            if text_pair is not None:
                row = row + [self._hash("[SEP]") % self.vocab_size] \
                    + self._ids(text_pair[i])
            if add_special_tokens:
                row = row[:max_length - 1] + [self.eos_id]
            else:
                row = row[:max_length]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def batch_encode_plus(self, texts, **kw):
        return self(texts, **kw)

    def batch_decode(self, ids, skip_special_tokens: bool = True,
                     ) -> List[str]:
        out = []
        for row in np.asarray(ids):
            words = [f"t{int(t)}" for t in row
                     if int(t) not in (self.pad_id, self.eos_id)]
            out.append(" ".join(words))
        return out


def get_tokenizer(style: str = "ance", allow_hash_fallback: bool = False):
    """HF tokenizer for the encoder style, from files already in the HF
    cache (``local_files_only``: nothing is downloaded, unlike the JAX
    package's loader); HashTokenizer only when explicitly permitted
    (silent garbage tokenizations in offline CLI runs must be a hard
    error), its ids below the vocabulary of the tokenizer it stands in
    for (the JAX package's stub draws BERT-style ids from T5's 32128,
    past the BERT word table's 30522 rows)."""
    name = _TOK_NAMES.get(style, style)
    try:
        from transformers import AutoTokenizer
        kw = {"do_lower_case": True} if style == "ar2" else {}
        return AutoTokenizer.from_pretrained(name, local_files_only=True,
                                             **kw)
    except Exception as e:
        if allow_hash_fallback:
            import sys
            print(f"WARNING: HF tokenizer '{name}' unavailable ({e!r}); "
                  "using HashTokenizer (ids are NOT linguistic)",
                  file=sys.stderr)
            return HashTokenizer(_HASH_VOCAB.get(name, 32128))
        raise RuntimeError(
            f"cannot load HF tokenizer '{name}' ({e!r}); pass "
            "--allow_hash_tokenizer to permit the offline stub") from e


def tokenize_passages(rows: Sequence[Tuple[str, str]], tok,
                      style: str = "ance", length: int = 128,
                      batch_size: int = 1024,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(title, content) rows -> int64 (n, length) tokens + masks
    (``prepare_passage_tokenized.py:63-70,95-156``)."""
    n = len(rows)
    tokens = np.zeros((n, length), np.int64)
    masks = np.zeros((n, length), np.int64)
    for s in range(0, n, batch_size):
        chunk = rows[s:s + batch_size]
        if style == "ar2":
            enc = tok([t for t, _ in chunk], [c for _, c in chunk],
                      max_length=length, truncation=True,
                      padding="max_length", return_tensors="np")
        else:
            if style == "cocondenser":
                texts = [f"{t}{tok.sep_token}{c}" for t, c in chunk]
            else:
                texts = [f"Title: {t} Text: {c}" for t, c in chunk]
            enc = tok(texts, max_length=length, truncation=True,
                      padding="max_length", return_tensors="np")
        tokens[s:s + len(chunk)] = np.asarray(enc["input_ids"])
        masks[s:s + len(chunk)] = np.asarray(enc["attention_mask"])
    return tokens, masks


def tokenize_queries(texts: Sequence[str], tok, length: int = 32,
                     batch_size: int = 4096,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Query texts -> int32 (n, length) ids + mask
    (``tokenize_query.py:10-60`` row format before packing)."""
    n = len(texts)
    ids = np.zeros((n, length), np.int32)
    mask = np.zeros((n, length), np.int32)
    for s in range(0, n, batch_size):
        chunk = list(texts[s:s + batch_size])
        enc = tok(chunk, max_length=length, truncation=True,
                  padding="max_length", return_tensors="np")
        ids[s:s + len(chunk)] = np.asarray(enc["input_ids"])
        mask[s:s + len(chunk)] = np.asarray(enc["attention_mask"])
    return ids, mask
