"""Configuration of the port (``mevi_tpu.config``'s ``InferConfig``;
the model, training and mesh configs come with their slices)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class InferConfig:
    """Inference / evaluation config (``marco_eval_nci_rq.sh``)."""

    num_return_sequences: int = 10   # beams == returned clusters
    num_beams: Optional[int] = None  # default = num_return_sequences
    length_penalty: float = 0.8
    recall_level: str = "both"       # 'coarse'|'fine'|'both'
    recall_num: Tuple[int, ...] = (1, 5, 10, 20, 50, 100, 1000)
    max_cluster_docs: int = 4096     # per-beam window cap (CSR path)
    eval_all_documents: bool = False # full-corpus scan instead of clusters
    overflow: str = "scan"           # cluster > cap: 'scan' | 'truncate'
    rank_mode: str = "score"         # fine pool ordering: 'score' |
                                     # 'beam_major' (see merge_pool)
    save_hard_neg: int = 0

    def beams(self) -> int:
        return self.num_beams or self.num_return_sequences
