"""ctypes bindings for the C++ host kernels (``native/mevi_native.cpp``),
the port's own loader (port of ``mevi_tpu.utils.native``).

These are host functions (CSR build, answer matching, line offsets,
cluster-negative sampling), not device kernels.  Every entry point has a
pure-numpy fallback, the reference's contract, so the package works
without the ``.so``; ``ensure_built()`` compiles it on demand with the
repository's Makefile, found from this file's own location.
"""

from __future__ import annotations

import ctypes
import os.path as osp
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
_NATIVE_DIR = osp.join(_REPO_ROOT, "native")
_SO_PATH = osp.join(_NATIVE_DIR, "libmevi_native.so")

_lib = None


def ensure_built(force: bool = False) -> Optional[ctypes.CDLL]:
    """Load the native library, building it if needed; None on failure."""
    global _lib
    if _lib is not None and not force:
        return _lib
    if force or not osp.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cp = ctypes.c_char_p

    lib.build_csr.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                              ctypes.c_int32, i64p, i32p]
    lib.count_lines.argtypes = [cp, ctypes.c_int64]
    lib.count_lines.restype = ctypes.c_int64
    lib.line_offsets.argtypes = [cp, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.line_offsets.restype = ctypes.c_int64
    lib.match_answers.argtypes = [cp, i64p, ctypes.c_int64, cp, i64p,
                                  ctypes.c_int64, u8p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tokenize_hashes.argtypes = [cp, ctypes.c_int64, u8p, u32p, u64p,
                                    ctypes.c_int64]
    lib.tokenize_hashes.restype = ctypes.c_int64
    lib.match_answer_sets.argtypes = [
        cp, i64p, ctypes.c_int64, u8p, u32p, u64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64, i32p, ctypes.c_int64]
    lib.match_answer_sets.restype = ctypes.c_int64
    lib.sample_cluster_negatives.argtypes = [
        i64p, i32p, ctypes.c_int64, i64p, i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint64, i32p]
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_csr(codes: np.ndarray, kary: int,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Counting-sort CSR; falls back to index/csr.build_csr."""
    lib = ensure_built()
    codes = np.ascontiguousarray(codes, np.int32)
    n, levels = codes.shape
    if lib is None:
        from ..index.csr import build_csr as py_build
        off, dids = py_build(codes, kary)
        return off.astype(np.int64), dids
    C = kary ** levels
    offsets = np.zeros(C + 1, np.int64)
    doc_ids = np.zeros(n, np.int32)
    lib.build_csr(_ptr(codes, ctypes.c_int32), n, levels, kary,
                  _ptr(offsets, ctypes.c_int64),
                  _ptr(doc_ids, ctypes.c_int32))
    return offsets, doc_ids


def _concat_bytes(items: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    return b"".join(items), offsets


def match_answers(passages: Sequence[bytes],
                  answers: Sequence[bytes]) -> np.ndarray:
    """out[i] = True if any answer is a substring of passage i
    (NQ answer-set matching, ``get_answers.py:106-180``)."""
    lib = ensure_built()
    if lib is None:
        return np.array([any(a in p for a in answers) for p in passages],
                        bool)
    pbuf, poff = _concat_bytes(list(passages))
    abuf, aoff = _concat_bytes(list(answers))
    out = np.zeros(len(passages), np.uint8)
    lib.match_answers(pbuf, _ptr(poff, ctypes.c_int64), len(passages),
                      abuf, _ptr(aoff, ctypes.c_int64), len(answers),
                      _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


# --------------------------------------------------------------------------
# Word-boundary answer matching (DPR SimpleTokenizer parity,
# get_answers.py:36-141): tokens = \p{L}\p{N}\p{M} runs or single
# non-\p{Z}\p{C} chars, lowercased; match = contiguous token-SEQUENCE.
# --------------------------------------------------------------------------

_UNICODE_TABLES = None
_FNV_OFF = 1469598103934665603
_FNV_PRIME = 1099511628211
_U64 = (1 << 64) - 1


def unicode_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(cat, lower) tables over all codepoints, built from unicodedata so
    the C++ tokenizer classifies exactly like the DPR regex."""
    global _UNICODE_TABLES
    if _UNICODE_TABLES is None:
        import sys
        import unicodedata
        n = sys.maxunicode + 1
        cat = np.full(n, 2, np.uint8)
        lower = np.arange(n, dtype=np.uint32)
        for cp in range(n):
            c = unicodedata.category(chr(cp))
            if c[0] in "LNM":
                cat[cp] = 1
            elif c[0] in "ZC":
                cat[cp] = 0
            lc = chr(cp).lower()
            if len(lc) == 1:
                lower[cp] = ord(lc)
        _UNICODE_TABLES = (cat, lower)
    return _UNICODE_TABLES


def _py_tokenize_hashes(text: str) -> np.ndarray:
    """Pure-python mirror of the C++ tokenizer (tests / no-.so fallback)."""
    cat, lower = unicode_tables()
    out = []
    h, in_tok = _FNV_OFF, False
    for ch in text:
        cp = ord(ch)
        k = cat[cp]
        if k == 1:
            if not in_tok:
                h, in_tok = _FNV_OFF, True
            h = ((h ^ int(lower[cp])) * _FNV_PRIME) & _U64
        else:
            if in_tok:
                out.append(h)
                in_tok = False
            if k == 2:
                out.append(((_FNV_OFF ^ int(lower[cp])) * _FNV_PRIME)
                           & _U64)
    if in_tok:
        out.append(h)
    return np.asarray(out, np.uint64)


def tokenize_hashes(text: str, max_tokens: int = 4096) -> np.ndarray:
    """Token hash sequence of (NFD-normalized) ``text``."""
    import unicodedata
    text = unicodedata.normalize("NFD", text)
    lib = ensure_built()
    if lib is None:
        return _py_tokenize_hashes(text)[:max_tokens]
    cat, lower = unicode_tables()
    raw = text.encode("utf-8")
    out = np.zeros(max_tokens, np.uint64)
    n = lib.tokenize_hashes(raw, len(raw), _ptr(cat, ctypes.c_uint8),
                            _ptr(lower, ctypes.c_uint32),
                            _ptr(out, ctypes.c_uint64), max_tokens)
    return out[:min(n, max_tokens)]


def match_answer_sets(passages: Sequence[str],
                      query_answers: Sequence[Sequence[str]],
                      ) -> "list[list[int]]":
    """For each query: the passages any of whose token sequences contain
    one of the query's answer token sequences (word-boundary KMP,
    ``get_answers.py:140-170``).  Returns hits[query] = [passage ids]."""
    import unicodedata
    ans_seqs, ans_query = [], []
    for q, answers in enumerate(query_answers):
        for a in answers:
            seq = tokenize_hashes(a)
            if len(seq):
                ans_seqs.append(seq)
                ans_query.append(q)
    n_queries = len(query_answers)
    hits = [[] for _ in range(n_queries)]
    if not ans_seqs:
        return hits

    lib = ensure_built()
    if lib is None:                        # pure-python fallback
        for i, p in enumerate(passages):
            toks = _py_tokenize_hashes(
                unicodedata.normalize("NFD", p)).tolist()
            seen = set()
            for seq, q in zip(ans_seqs, ans_query):
                if q in seen:
                    continue
                s = seq.tolist()
                L = len(s)
                for pos in range(len(toks) - L + 1):
                    if toks[pos:pos + L] == s:
                        hits[q].append(i)
                        seen.add(q)
                        break
        return hits

    norm = [unicodedata.normalize("NFD", p).encode("utf-8")
            for p in passages]
    pbuf, poff = _concat_bytes(norm)
    a_off = np.zeros(len(ans_seqs) + 1, np.int64)
    np.cumsum([len(s) for s in ans_seqs], out=a_off[1:])
    a_hash = (np.concatenate(ans_seqs) if len(ans_seqs)
              else np.zeros(0, np.uint64)).astype(np.uint64)
    a_query = np.asarray(ans_query, np.int32)
    cat, lower = unicode_tables()

    capacity = max(1024, 4 * len(passages))
    while True:
        out = np.zeros((capacity, 2), np.int32)
        n = lib.match_answer_sets(
            pbuf, _ptr(poff, ctypes.c_int64), len(passages),
            _ptr(cat, ctypes.c_uint8), _ptr(lower, ctypes.c_uint32),
            _ptr(a_hash, ctypes.c_uint64), _ptr(a_off, ctypes.c_int64),
            _ptr(a_query, ctypes.c_int32), len(ans_seqs), n_queries,
            _ptr(out, ctypes.c_int32), capacity)
        if n <= capacity:
            break
        capacity = int(n + 1024)
    for pid, q in out[:n]:
        hits[int(q)].append(int(pid))
    for h in hits:
        h.sort()
    return hits


def line_offsets(data: bytes) -> np.ndarray:
    """Start offsets of each line (+ final sentinel = len)."""
    lib = ensure_built()
    if lib is None:
        offs = [0]
        pos = data.find(b"\n")
        while pos != -1:
            offs.append(pos + 1)
            pos = data.find(b"\n", pos + 1)
        if offs[-1] >= len(data):
            offs.pop()
        return np.array(offs + [len(data)], np.int64)
    max_lines = lib.count_lines(data, len(data))
    out = np.zeros(max_lines + 1, np.int64)
    n = lib.line_offsets(data, len(data), _ptr(out, ctypes.c_int64),
                         max_lines)
    return out[:n + 1]


def sample_cluster_negatives(offsets: np.ndarray, doc_ids: np.ndarray,
                             cluster_of: np.ndarray, pos_docs: np.ndarray,
                             n_neg: int, seed: int = 1) -> np.ndarray:
    """Batched in-cluster negatives; (b, n_neg) int32."""
    lib = ensure_built()
    pos_docs = np.ascontiguousarray(pos_docs, np.int32)
    b = len(pos_docs)
    if lib is None:
        rng = np.random.default_rng(seed)
        out = np.zeros((b, n_neg), np.int32)
        for i, pos in enumerate(pos_docs):
            c = int(cluster_of[pos])
            mem = doc_ids[offsets[c]:offsets[c + 1]]
            mem = mem[mem != pos]
            if len(mem) == 0:
                mem = rng.integers(0, len(cluster_of), 4 * n_neg)
                mem = mem[mem != pos]
            out[i] = rng.choice(mem, n_neg, replace=True)
        return out
    offsets = np.ascontiguousarray(offsets, np.int64)
    doc_ids = np.ascontiguousarray(doc_ids, np.int32)
    cluster_of = np.ascontiguousarray(cluster_of, np.int64)
    out = np.zeros((b, n_neg), np.int32)
    lib.sample_cluster_negatives(
        _ptr(offsets, ctypes.c_int64), _ptr(doc_ids, ctypes.c_int32),
        len(cluster_of), _ptr(cluster_of, ctypes.c_int64),
        _ptr(pos_docs, ctypes.c_int32), b, n_neg,
        ctypes.c_uint64(seed).value or 1, _ptr(out, ctypes.c_int32))
    return out
