"""Dense trie tables over variable-length document ids, the non-RQ
(hierarchical k-means id) mode (port of ``mevi_tpu.decode.trie.build_trie``;
the trie-constrained beam comes with slice E).

* ``child[node, c]``: child node id for code c, -1 if absent,
* ``terminal[node]``: True when a document id ends at this node.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def build_trie(ids: Sequence[Sequence[int]], kary: int,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense trie tables from document id sequences.

    Returns (child (num_nodes, kary) int32 with -1 absent,
    terminal (num_nodes,) bool).  Node 0 is the root.
    """
    child_rows: List[np.ndarray] = [np.full(kary, -1, np.int32)]
    terminal: List[bool] = [False]
    for seq in ids:
        node = 0
        for c in seq:
            nxt = child_rows[node][c]
            if nxt < 0:
                nxt = len(child_rows)
                child_rows[node][c] = nxt
                child_rows.append(np.full(kary, -1, np.int32))
                terminal.append(False)
            node = int(nxt)
        terminal[node] = True
    return np.stack(child_rows), np.asarray(terminal, bool)
