"""Data-preparation transforms (the reference's ``dataprocess/`` stage;
port of ``mevi_tpu.data.prepare``, whose output files it writes byte
for byte).

Pure host-side functions mirroring:

* train/dev tsv building — ``dataprocess/msmarco_passage/
  prepare_origin.py:31-69`` (qrels rows are either ``(qid, _, docid,
  rel)`` or ``(qid, docid)``),
* document-span augmentation — ``prepare_origin.py:103-116``,
* qg{n} subsets of qg10 — ``prepare_origin.py:119-128`` (keep every
  ``10 // n``-th row),
* QG repair (empty/duplicate detection) — ``complement_qg10.py``,
* corpus-drop experiments — ``sampled_corpus.py:8-60``,
* NQ preprocess — ``dataprocess/NQ_dpr/preprocess.py:12-77`` (psgs_w100
  ids are 1-based; corpus ids 0-based),
* NQ answer arrays — ``get_answers.py:106-180`` +
  ``get_inverse_answers.py:10-27``: the saved artifact is the INVERSE
  doc -> answering-query CSR (``test_inverse_{offsets,array}.bin``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# tsv building (MARCO)
# --------------------------------------------------------------------------

def read_id_text_tsv(path: str) -> Dict[str, str]:
    """``id \\t text`` rows (train.query.txt / dev.query.txt)."""
    out = {}
    with open(path, "r", encoding="utf-8") as fr:
        for line in fr:
            line = line.rstrip("\n")
            if not line:
                continue
            k, text = line.split("\t", 1)
            out[k] = text
    return out


def _qrel_docid(row: Sequence[str]) -> str:
    """qrels rows: (qid, _, docid, rel) or (qid, docid)
    (``prepare_origin.py:41-47``)."""
    return row[2] if len(row) >= 3 else row[1]


def build_train_pairs(queries: Dict[str, str],
                      qrels: Iterable[Sequence[str]],
                      ) -> List[Tuple[str, int]]:
    """One (query text, positive docid) row per qrel
    (train_mevi.tsv, ``prepare_origin.py:38-48``)."""
    return [(queries[row[0]], int(_qrel_docid(row))) for row in qrels]


def build_dev_dedup(queries: Dict[str, str],
                    qrels: Iterable[Sequence[str]],
                    ) -> List[Tuple[str, List[int]]]:
    """Group dev qrels by query (dev_mevi_dedup.tsv,
    ``prepare_origin.py:51-69``); first-seen query order."""
    grouped: Dict[str, List[int]] = {}
    order: List[str] = []
    for row in qrels:
        q = queries[row[0]]
        if q not in grouped:
            grouped[q] = []
            order.append(q)
        grouped[q].append(int(_qrel_docid(row)))
    return [(q, grouped[q]) for q in order]


def doc_aug_spans(rows: Iterable[Tuple[int, str, str]], seed: int = 0,
                  spans_per_doc: int = 10, span_len: int = 64,
                  ) -> List[Tuple[str, int]]:
    """Random word spans of each document as pseudo-queries
    (``prepare_origin.py:103-116``): words = title + content split on
    spaces, ``spans_per_doc + max(0, nwords - 3000) // 3000`` spans per
    doc, each ``content[begin : begin + span_len]`` from a uniform
    begin."""
    rng = np.random.default_rng(seed)
    out: List[Tuple[str, int]] = []
    for did, title, content in rows:
        words = (title.split(" ") if title else []) + \
                (content.split(" ") if content else [])
        if not words:
            continue
        n = spans_per_doc + max(0, len(words) - 3000) // 3000
        for _ in range(n):
            begin = int(rng.integers(0, len(words)))
            out.append((" ".join(words[begin:begin + span_len]), did))
    return out


def qg_subset(rows: Sequence, n: int, per_doc: int = 10) -> list:
    """qg{n} from qg10: keep rows where ``i % (per_doc // n) == 0``
    (``prepare_qg_data``, ``prepare_origin.py:119-128``)."""
    interval = max(per_doc // max(n, 1), 1)
    return [r for i, r in enumerate(rows) if i % interval == 0]


def doc_as_query_text(title: str, content: str, style: str = "ance") -> str:
    """Document text in the tower's input format
    (``prepare_passage_tokenized.py:63-70``)."""
    if style == "ar2":
        return f"{title}[SEP]{content}"
    if style == "cocondenser":
        return f"{title}[SEP]{content}"
    return f"Title: {title} Text: {content}"


def compose_train_data(origin_dir: str, recipe: str,
                       corpus_path: Optional[str] = None,
                       style: str = "ance",
                       ) -> Tuple[List[Tuple[str, int]],
                                  Dict[int, List[str]]]:
    """Build the training pair list for a ``--train_data``-style recipe
    (underscore-joined parts: ``gtq`` = train_mevi.tsv, ``doc`` =
    document-as-query, ``qg{n}`` = qg{n}.tsv; reference recipe parsing at
    ``MEVI/main.py:672-699``).

    Returns (pairs [(text, docid)], doc2q {docid: [real query texts]}).
    ``doc2q`` holds only real queries (qg first, then gtq) — document
    pseudo-queries are excluded, matching the reference's query_aug
    bookkeeping.
    """
    import os.path as osp
    from .io import read_query_docids_tsv
    parts = recipe.split("_")
    pairs: List[Tuple[str, int]] = []
    qg_rows: List[Tuple[str, int]] = []
    gtq_rows: List[Tuple[str, int]] = []
    for part in parts:
        if part == "gtq":
            rows = read_query_docids_tsv(osp.join(origin_dir,
                                                  "train_mevi.tsv"))
            gtq_rows = [(q, ids[0]) for q, ids in rows]
            pairs.extend(gtq_rows)
        elif part == "doc":
            assert corpus_path, "recipe 'doc' needs corpus_path"
            with open(corpus_path, encoding="utf-8") as fr:
                for line in fr:
                    if not line.strip():
                        continue
                    did, title, content = (line.rstrip("\n").split("\t")
                                           + ["", ""])[:3]
                    pairs.append((doc_as_query_text(title, content, style),
                                  int(did)))
        elif part.startswith("qg"):
            rows = read_query_docids_tsv(osp.join(origin_dir,
                                                  f"{part}.tsv"))
            qg_rows = [(q, ids[0]) for q, ids in rows]
            pairs.extend(qg_rows)
        elif part == "aug":
            rows = read_query_docids_tsv(osp.join(origin_dir,
                                                  "doc_aug.tsv"))
            pairs.extend((q, ids[0]) for q, ids in rows)
        else:
            raise ValueError(f"unknown recipe part: {part}")
    doc2q: Dict[int, List[str]] = defaultdict(list)
    for q, d in qg_rows + gtq_rows:
        if q not in doc2q[d]:
            doc2q[d].append(q)
    return pairs, dict(doc2q)


# --------------------------------------------------------------------------
# QG repair (complement_qg10.py)
# --------------------------------------------------------------------------

def qg_repair(rows: Sequence[Tuple[str, int]], n_per_doc: int = 10,
              ) -> Tuple[List[Tuple[str, int]], List[int]]:
    """Drop blank queries, dedupe per doc, report short docs.

    Returns (cleaned rows, docids needing regeneration) — docs with
    fewer than ``n_per_doc`` usable queries (``complement_qg10.py``'s
    detection pass)."""
    per_doc: Dict[int, List[str]] = defaultdict(list)
    cleaned: List[Tuple[str, int]] = []
    for q, d in rows:
        qs = q.strip()
        if not qs:
            continue
        if qs in per_doc[d]:
            continue
        per_doc[d].append(qs)
        cleaned.append((q, d))
    need = sorted(d for d, qs in per_doc.items() if len(qs) < n_per_doc)
    return cleaned, need


# --------------------------------------------------------------------------
# corpus-drop experiments (sampled_corpus.py)
# --------------------------------------------------------------------------

def sample_corpus(n_docs: int, drop_rate: float, seed: int = 0,
                  ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Keep a random ``1 - drop_rate`` subset; return (kept original ids
    sorted, {orig id: new id}) (``sampled_corpus.py:8-38``)."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_docs) >= drop_rate
    kept = np.nonzero(keep)[0]
    remap = {int(o): i for i, o in enumerate(kept)}
    return kept, remap


def remap_pairs(pairs: Sequence[Tuple[str, int]], remap: Dict[int, int],
                ) -> List[Tuple[str, int]]:
    """Remap (query, docid) pairs into the sampled id space, dropping
    pairs whose doc was removed (``sampled_corpus.py:41-60``)."""
    return [(q, remap[d]) for q, d in pairs if d in remap]


# --------------------------------------------------------------------------
# NQ preprocess (dataprocess/NQ_dpr)
# --------------------------------------------------------------------------

def nq_corpus_rows(psgs_path: str) -> List[Tuple[int, str, str]]:
    """psgs_w100.tsv (id, text, title; 1-based, header row) ->
    (0-based id, title, text) rows (``preprocess.py:12-25``)."""
    import csv
    out = []
    with open(psgs_path, "r", encoding="utf-8") as fr:
        for row in csv.reader(fr, delimiter="\t"):
            if row[0] == "id":
                continue
            out.append((int(row[0]) - 1, row[2], row[1]))
    return out


def nq_biencoder_pairs(path: str) -> List[Tuple[str, int]]:
    """biencoder-nq-{train,dev}.json -> (question, 0-based positive id)
    pairs, one per positive (``preprocess.py:38-60`` + expand)."""
    import json
    with open(path, "r", encoding="utf-8") as fr:
        data = json.load(fr)
    pairs = []
    for item in data:
        q = item["question"].replace("’", "'")
        for p in item["positive_ctxs"]:
            pairs.append((q, int(p["passage_id"]) - 1))
    return pairs


def build_answer_arrays(passages: Sequence[str],
                        answers: Sequence[Sequence[str]],
                        word_boundary: bool = True,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse doc -> answering-query CSR arrays
    (``test_inverse_{offsets,array}.bin``, ``get_inverse_answers.py:
    10-27``): offsets (n_docs + 1,) int64, array int32 of query indices.

    ``word_boundary=True`` matches DPR SimpleTokenizer token-sequence
    semantics (``get_answers.py:36-141``); False is the raw lowercase
    byte-substring mode (fast, inflates hitrates — kept for ablations).
    """
    from ..utils import native
    n_docs = len(passages)
    hits_per_doc: List[List[int]] = [[] for _ in range(n_docs)]
    if word_boundary:
        hits = native.match_answer_sets(passages, answers)
        for q, docs in enumerate(hits):
            for d in docs:
                hits_per_doc[d].append(q)
    else:
        pas = [p.lower().encode("utf-8") for p in passages]
        for q, ans in enumerate(answers):
            if not ans:
                continue
            m = native.match_answers(
                pas, [a.lower().encode("utf-8") for a in ans])
            for d in np.nonzero(m)[0]:
                hits_per_doc[int(d)].append(q)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(h) for h in hits_per_doc], out=offsets[1:])
    array = np.asarray([q for h in hits_per_doc for q in h], np.int32)
    return offsets, array
