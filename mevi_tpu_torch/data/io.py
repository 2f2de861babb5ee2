"""File contracts shared with the reference data pipeline (the port's
copy of ``mevi_tpu.data.io``):

* ``dev_mevi_dedup.tsv`` / ``qg{n}.tsv`` — ``query \\t docid[,docid...]``
  (``MEVI/main_utils.py:235-291``).
* ``all_document_{tokens,masks}.bin`` — int64 memmaps of shape
  ``(ndoc, doc_length)``
  (``dataprocess/msmarco_passage/prepare_passage_tokenized.py:83-88``).
* ``docemb.bin`` — float32 memmap ``(ndoc, emb)``
  (``MEVI/generate.py:140-187``).
* packed NQ query rows ``(ids[L], mask[L], docid)`` int32
  (``dataprocess/NQ_dpr/tokenize_query.py:10-23``).
* result tsvs: coarse ``(query, clusters, gts, scores)``, fine
  ``(query, ndoc, docids, gts)``, hard-neg ``(query, gt_scores, docids,
  scores)`` (``MEVI/main_models.py:4227-4235``, parsed by
  ``ensemble_marco.py:92-111,164-166``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# query/gt tsvs
# --------------------------------------------------------------------------

def read_query_docids_tsv(path: str) -> List[Tuple[str, List[int]]]:
    """Read ``query \\t docid[,docid...]`` rows (train or dev format)."""
    rows = []
    with open(path, "r", encoding="utf-8") as fr:
        for line in fr:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            query, ids = parts[0], parts[-1]
            rows.append((query, [int(x) for x in ids.split(",") if x != ""]))
    return rows


def write_query_docids_tsv(path: str,
                           rows: Iterable[Tuple[str, Sequence[int]]]) -> None:
    with open(path, "w", encoding="utf-8") as fw:
        for query, ids in rows:
            fw.write(f"{query}\t{','.join(str(i) for i in ids)}\n")


def read_gt_dict(path: str) -> Dict[str, List[int]]:
    """Ground-truth dict keyed by query text (ensemble gt_template:
    ``ensemble_marco.py:164`` uses columns (0, -1))."""
    return dict(read_query_docids_tsv(path))


# --------------------------------------------------------------------------
# memmaps
# --------------------------------------------------------------------------

def open_token_memmaps(prefix: str, doc_length: int = 128,
                       dtype=np.int64) -> Tuple[np.memmap, np.memmap]:
    """Open ``{prefix}_tokens.bin`` / ``{prefix}_masks.bin`` pairs."""
    tokens = np.memmap(prefix + "_tokens.bin", dtype=dtype, mode="r")
    masks = np.memmap(prefix + "_masks.bin", dtype=dtype, mode="r")
    tokens = tokens.reshape(-1, doc_length)
    masks = masks.reshape(-1, doc_length)
    assert tokens.shape == masks.shape
    return tokens, masks


def write_token_memmaps(prefix: str, tokens: np.ndarray,
                        masks: np.ndarray, dtype=np.int64) -> None:
    for name, arr in (("tokens", tokens), ("masks", masks)):
        mm = np.memmap(f"{prefix}_{name}.bin", dtype=dtype, mode="w+",
                       shape=arr.shape)
        mm[:] = arr
        mm.flush()


def open_embedding_memmap(path: str, emb_size: int = 768,
                          dtype=np.float32) -> np.memmap:
    emb = np.memmap(path, dtype=dtype, mode="r")
    return emb.reshape(-1, emb_size)


def write_embedding_memmap(path: str, emb: np.ndarray,
                           dtype=np.float32) -> None:
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=emb.shape)
    mm[:] = emb.astype(dtype)
    mm.flush()


def open_packed_queries(path: str, query_length: int = 32) -> np.ndarray:
    """Packed NQ query rows: ``(ids[L], mask[L], docid)`` int32
    (``tokenize_query.py:10-23``).  Returns (n, 2*L+1)."""
    arr = np.memmap(path, dtype=np.int32, mode="r")
    width = 2 * query_length + 1
    return arr.reshape(-1, width)


def pack_queries(ids: np.ndarray, mask: np.ndarray,
                 docids: np.ndarray) -> np.ndarray:
    assert ids.shape == mask.shape and ids.shape[0] == docids.shape[0]
    return np.concatenate(
        [ids.astype(np.int32), mask.astype(np.int32),
         docids.reshape(-1, 1).astype(np.int32)], axis=1)


# --------------------------------------------------------------------------
# result tsvs (ensemble input contracts)
# --------------------------------------------------------------------------

def _fmt_list(x) -> str:
    return str(list(x))


def write_coarse_results(path: str, rows: Iterable[tuple]) -> None:
    """Rows: (query, clusters[List[List[int]]], gts[List], scores[List])."""
    with open(path, "w", encoding="utf-8") as fw:
        for query, clusters, gts, scores in rows:
            fw.write("\t".join([
                query, _fmt_list([list(c) for c in clusters]),
                _fmt_list(gts), _fmt_list([float(s) for s in scores]),
            ]) + "\n")


def write_fine_results(path: str, rows: Iterable[tuple]) -> None:
    """Rows: (query, ndoc, docids[List[int]], gts[List[int]]).

    Column layout matches the ensemble fine_template {query:0, pred:2,
    score:3} when scores are appended by hard-neg rows; the plain fine tsv
    in the reference is (query, result_docs, gts) at pred index 2 via a
    leading ndoc column.
    """
    with open(path, "w", encoding="utf-8") as fw:
        for query, ndoc, docids, gts in rows:
            fw.write("\t".join([
                query, str(ndoc), _fmt_list(docids), _fmt_list(gts),
            ]) + "\n")


def write_hardneg_results(path: str, rows: Iterable[tuple]) -> None:
    """Rows: (query, gt_scores[List[float]], docids, scores) — the
    full-corpus-scan dump consumed as the ensemble 'fine_file'
    (``main_models.py:3901-3908``, template pred:2 score:3)."""
    with open(path, "w", encoding="utf-8") as fw:
        for query, gt_scores, docids, scores in rows:
            fw.write("\t".join([
                query,
                ",".join(str(float(s)) for s in gt_scores),
                ",".join(str(int(d)) for d in docids),
                ",".join(str(float(s)) for s in scores),
            ]) + "\n")


def parse_result_tsv(path: str, template: Dict[str, int]) -> tuple:
    """Parse a result tsv with a column template, mirroring
    ``ensemble_marco.py:92-111`` (keys: query/pred/score/cluster).

    List columns accept either python-literal lists or comma-joined values.
    """
    qind = template["query"]
    pind = template.get("pred")
    sind = template.get("score")
    cind = template.get("cluster")
    preds, scores, clusters = {}, {}, {}

    def eval_list(item: str):
        item = item.strip()
        if not item.startswith("["):
            item = f"[{item}]"
        return ast.literal_eval(item)

    with open(path, "r", encoding="utf-8") as fr:
        for line in fr:
            line = line.rstrip("\n")
            if not line:
                continue
            items = line.split("\t")
            q = items[qind]
            if pind is not None:
                preds[q] = eval_list(items[pind])
            if sind is not None:
                scores[q] = eval_list(items[sind])
            if cind is not None:
                clusters[q] = eval_list(items[cind])
    return preds, scores, clusters
