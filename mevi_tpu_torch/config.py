"""Typed configuration of the port (its own copy of ``mevi_tpu.config``).

The dataclasses, their fields and defaults, ``finalize`` and the JSON
form are the JAX package's, so a config file reads the same in both and
``artifact_key`` gives both packages the same key for the same config
(an artifact cache written by one is found by the other).

Key derived quantities (reference semantics):

* ``decode_vocab_size = kary * max_output_length + 2``
  (``MEVI/main_models.py:1335-1341``); ids 0 (pad/decoder-start) and
  1 (eos) are reserved, code ``c`` at level ``i`` maps to token
  ``2 + i * kary + c``.
* ``max_output_length = subvector_num + 2`` (``marco_train_nci_rq.sh:19``):
  start token + M code tokens + eos.
* RQ default: 4 levels x 2**5 = 32 centroids over d=768 embeddings
  (``marco_train_nci_rq.sh:1-3``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass
class RQConfig:
    """Residual/product quantization config (``MEVI/pq.py:15-80``)."""

    pq_type: str = "rq"              # 'rq' | 'pq' | 'opq'
    subvector_num: int = 4           # M: levels (rq) / subvectors (pq)
    subvector_bits: int = 5          # K = 2**bits centroids per level
    dist_mode: str = "l2"            # 'ip' | 'l2' (main.py:556 default 'l2')
    emb_size: int = 768
    rq_topk_score: str = "prod"      # beam score accumulation (pq.py:664-667)
    # hierarchical by-residual conditioning (ops/rq.rq_train): adds
    # per-level (kary^i, d) shift tables to the quantizer artifacts
    center_levels: bool = False

    @property
    def kary(self) -> int:
        return 2 ** self.subvector_bits

    @property
    def last_dim(self) -> int:
        # rq codebooks live in the full embedding space; pq in subspaces
        if self.pq_type == "rq":
            return self.emb_size
        return self.emb_size // self.subvector_num

    @property
    def num_leaf_clusters(self) -> int:
        return self.kary ** self.subvector_num

    def validate(self) -> "RQConfig":
        if self.pq_type not in ("pq", "opq", "rq"):
            raise ValueError(f"pq_type {self.pq_type!r}")
        if self.dist_mode not in ("ip", "l2"):
            raise ValueError(f"dist_mode {self.dist_mode!r}")
        if self.pq_type != "rq" and self.emb_size % self.subvector_num:
            raise ValueError("emb_size must divide into subvectors")
        return self


@dataclass
class ModelConfig:
    """NCI seq2seq model config (T5-base preset: ``MEVI/main.py:755-761``)."""

    # t5 dims
    num_layers: int = 12
    num_decoder_layers: int = 6
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_heads: int = 12
    vocab_size: int = 32128          # t5 tokenizer vocab (encoder side)
    dropout_rate: float = 0.1
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # t5 v1.0 (t5-ance base)

    # NCI decode-side extensions (modeling_t5.py:1170-1311)
    decode_embedding: bool = True
    kary: int = 32                   # output_vocab_size per level
    max_output_length: int = 6       # 1 start-shift + M codes + eos
    tie_decode_embedding: bool = True
    adaptor_decode: bool = True      # PAWA adaptive head
    adaptor_efficient: bool = True
    adaptor_layer_num: int = 4
    adaptor_num_heads: int = 8
    # frozen twin-tower decoder whose token-0 state joins encoder memory
    reserve_decoder: bool = False

    # Rdrop regularizer (modeling_t5.py:1703-1752)
    rdrop: float = 0.0
    rdrop_loss: str = "Contrast"     # 'KL' | 'Contrast' | 'L2'

    dtype: str = "float32"           # compute dtype for the hot path

    @property
    def output_vocab_size(self) -> int:
        return self.kary

    @property
    def decode_vocab_size(self) -> int:
        return self.kary * self.max_output_length + 2

    @property
    def code_len(self) -> int:
        """Number of code tokens per document (= RQ levels)."""
        return self.max_output_length - 2

    def validate(self) -> "ModelConfig":
        if self.max_output_length < 3:
            raise ValueError("max_output_length < 3")
        # fixed design choices, validated so configs fail loudly
        if not self.decode_embedding:
            raise ValueError("decode_embedding=False (full-vocab NCI) is "
                             "not supported")
        if not self.adaptor_efficient:
            raise ValueError("only the efficient PAWA composition exists")
        if self.feed_forward_proj not in ("relu", "gated-gelu"):
            raise ValueError(self.feed_forward_proj)
        return self


@dataclass
class EncoderConfig:
    """Twin-tower encoder config (``MEVI/document_encoder.py:28-120``)."""

    family: str = "t5"               # 't5' (ANCE) | 'bert' | 'deepseek_v2'
    tied: bool = True                # share query/passage towers
    normalize: bool = False
    d_model: int = 768
    # bert-side dims (AR2 ernie-2.0-base / bert-base defaults)
    num_layers: int = 12
    num_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 30522
    t5_vocab_size: int = 32128       # t5-family tokenizer vocab
    max_position_embeddings: int = 512
    type_vocab_size: int = 4         # ernie uses 4; bert 2
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-12
    query_length: int = 32           # main.py:742-744
    doc_length: int = 128            # co_doc_length main.py:535
    dtype: str = "float32"
    # family 'deepseek_v2' only: HF config.json keys of the widths the
    # fields above do not give (MLA, experts, RoPE; ``rope_scaling`` is
    # required, other missing keys are DeepSeek-V2-Lite's,
    # ``models.deepseek_v2.DeepseekV2Dims``).  Left out of the JSON form and the artifact key while None, so that a
    # config of the other families reads and hashes as the JAX
    # package's.
    deepseek_v2: Optional[dict] = None


def _encoder_dict(enc: EncoderConfig) -> dict:
    out = dataclasses.asdict(enc)
    if out["deepseek_v2"] is None:
        del out["deepseek_v2"]
    return out


@dataclass
class TrainConfig:
    """Training hyper-parameters (``marco_train_nci_rq.sh``, ``main.py``)."""

    train_batch_size: int = 512
    eval_batch_size: int = 16
    encode_batch_size: int = 1024
    num_train_epochs: int = 120
    # per-part learning rates (main.py:434-437)
    learning_rate: float = 2e-4          # encoder (and default)
    decoder_learning_rate: float = 1e-4  # nci decoder + heads
    docenc_learning_rate: float = 5e-6   # twin-tower document encoder
    weight_decay: float = 1e-4
    adam_epsilon: float = 1e-8
    warmup_steps: int = 0
    max_grad_norm: float = 1.0
    gradient_accumulation: int = 1
    seed: int = 42

    # loss switches (main.py flags)
    no_nci_loss: bool = False
    no_twin_loss: bool = False
    pq_loss: str = "ce"              # 'label'|'ce'|'kl'|'mse'|'dot'|'cosine'|'bce'
    pq_softmax_tau: float = 1.0
    pq_negative: str = "none"        # 'none'|'sample'|'batch'
    pq_runtime_label: bool = True    # labels from RQ assignment of doc embeddings
    centroid_update_loss: str = "none"   # 'none'|'reconstruct'
    centroid_loss_scale: float = 1.0
    co_neg_num: int = 7              # in-cluster hard negatives (main.py:537)
    fixnci: bool = False
    fixpq: bool = False
    fixdocenc: bool = False


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


@dataclass
class MeshConfig:
    """Device layout: ``data`` shards batches, ``corpus`` shards the
    document matrix and CSR buckets."""

    data_axis: int = -1              # -1: all devices
    corpus_axis: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        corpus = self.corpus_axis
        data = self.data_axis if self.data_axis > 0 else n_devices // corpus
        if data * corpus != n_devices:
            raise ValueError(f"mesh {data} x {corpus} != {n_devices} devices")
        return data, corpus


@dataclass
class MEVIConfig:
    """Top-level config bundle."""

    rq: RQConfig = field(default_factory=RQConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    dataset: str = "marco"           # 'marco' | 'nq_dpr'
    data_dir: str = "data/marco/origin"
    ckpt_dir: str = "ckpts"

    def finalize(self) -> "MEVIConfig":
        """Apply cross-field derivations (reference: main.py:614-794)."""
        self.rq.validate()
        # NCI decode side follows the RQ geometry.
        self.model.kary = self.rq.kary
        self.model.max_output_length = self.rq.subvector_num + 2
        self.model.validate()
        if self.rq.emb_size != self.encoder.d_model:
            raise ValueError(f"rq.emb_size {self.rq.emb_size} != "
                             f"encoder.d_model {self.encoder.d_model}")
        return self

    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        raw["encoder"] = _encoder_dict(self.encoder)
        return json.dumps(raw, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "MEVIConfig":
        raw = json.loads(text)
        return cls(
            rq=RQConfig(**raw.get("rq", {})),
            model=ModelConfig(**raw.get("model", {})),
            encoder=EncoderConfig(**raw.get("encoder", {})),
            train=TrainConfig(**raw.get("train", {})),
            infer=InferConfig(**{k: tuple(v) if k == "recall_num" else v
                                 for k, v in raw.get("infer", {}).items()}),
            mesh=MeshConfig(**raw.get("mesh", {})),
            **{k: v for k, v in raw.items()
               if k in ("dataset", "data_dir", "ckpt_dir")},
        )

    def artifact_key(self, *parts: Any) -> str:
        """Content-address artifacts by config hash (the reference keys
        them by config+epoch+time_str, ``main_models.py:2944-2978``)."""
        blob = json.dumps([dataclasses.asdict(self.rq),
                           _encoder_dict(self.encoder), parts],
                          sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]
