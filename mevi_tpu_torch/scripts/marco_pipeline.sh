#!/usr/bin/env bash
# MS MARCO passage pipeline of the PyTorch port: the stages and flags of
# scripts/marco_pipeline.sh (marco_generate_embedding_n_rq.sh /
# marco_train_nci_rq.sh / marco_eval_nci_rq.sh / marco_ensemble.sh)
# through mevi_tpu_torch.cli.main.  Run it from the directory that holds
# $CFG and the config's ckpt_dir, with mevi_tpu_torch importable.
#
# Inputs expected under $DATA_DIR:
#   raw/corpus.tsv  raw/train.query.txt  raw/qrels.train.tsv
#   raw/dev.query.txt  raw/qrels.dev.tsv
#   ckpts/t5-ance.pt          (twin-tower checkpoint, torch state dict)
#   ckpts/doc2query.pt        (optional, for QG)
#
# Flags appended to the CLI calls, empty by default (the CLI's commands
# take different flags, so there are two):
#   TOKENIZER_FLAGS  the calls that tokenize text (tokenize, doc2query,
#                    eval, train-joint), e.g. --allow_hash_tokenizer where
#                    no HF tokenizer files are
#   DEVICE_FLAGS     the calls that run on the device (gen-embeddings,
#                    build-index, build-hier, search, train, train-joint,
#                    eval, doc2query), e.g. --device cpu
set -euo pipefail
DATA_DIR=${DATA_DIR:-data/marco}
CFG=${CFG:-configs/marco_rq4x5.json}
CLI="python -m mevi_tpu_torch.cli.main"
TOKENIZER_FLAGS=${TOKENIZER_FLAGS:-}
DEVICE_FLAGS=${DEVICE_FLAGS:-}

stage=${1:-all}

if [[ $stage == prepare || $stage == all ]]; then
  $CLI prepare --raw_dir $DATA_DIR/raw --origin_dir $DATA_DIR/origin \
      --doc_aug
  mkdir -p $DATA_DIR/ance  # the reference leaves it to exist already
  $CLI tokenize --kind corpus --style ance \
      --input $DATA_DIR/raw/corpus.tsv \
      --output $DATA_DIR/ance/all_document --length 128 $TOKENIZER_FLAGS
fi

if [[ $stage == qg ]]; then  # optional: docT5query pseudo-queries
  $CLI doc2query --checkpoint $DATA_DIR/ckpts/doc2query.pt \
      --corpus $DATA_DIR/raw/corpus.tsv \
      --output $DATA_DIR/origin/qg10.tsv --n_gen_query 10 \
      $TOKENIZER_FLAGS $DEVICE_FLAGS
fi

if [[ $stage == index || $stage == all ]]; then
  # == marco_generate_embedding_n_rq.sh: embed corpus + build RQ 4x32
  $CLI gen-embeddings --config $CFG \
      --checkpoint $DATA_DIR/ckpts/t5-ance.pt \
      --documents $DATA_DIR/ance/all_document \
      --output $DATA_DIR/ance/docemb.bin $DEVICE_FLAGS
  $CLI build-index --config $CFG \
      --embeddings $DATA_DIR/ance/docemb.bin \
      --output_dir $DATA_DIR/ance/index --cache_dir $DATA_DIR/cache \
      $DEVICE_FLAGS
fi

if [[ $stage == train || $stage == all ]]; then
  # == marco_train_nci_rq.sh: NCI seq2seq on (query -> RQ code)
  $CLI tokenize --kind queries --style ance \
      --input $DATA_DIR/origin/train_mevi.tsv \
      --output $DATA_DIR/ance/train_queries --length 32 $TOKENIZER_FLAGS
  $CLI train --config $CFG \
      --queries $DATA_DIR/ance/train_queries --query_length 32 \
      --codes $DATA_DIR/ance/index/rq_codes.npy \
      --train_tsv $DATA_DIR/origin/train_mevi.tsv \
      --log_dir $DATA_DIR/logs $DEVICE_FLAGS
fi

if [[ $stage == eval || $stage == all ]]; then
  # == marco_eval_nci_rq.sh: beam-10 coarse + fine rerank, both levels
  $CLI eval --config $CFG \
      --nci_ckpt ckpts/nci/best \
      --tower_ckpt $DATA_DIR/ckpts/t5-ance.pt \
      --embeddings $DATA_DIR/ance/docemb.bin \
      --codes $DATA_DIR/ance/index/rq_codes.npy \
      --dev_tsv $DATA_DIR/origin/dev_mevi_dedup.tsv \
      --num_return_sequences 10 --bf16 \
      --save_path $DATA_DIR/ance/nci_result_rq45_top10.tsv \
      $TOKENIZER_FLAGS $DEVICE_FLAGS
fi

if [[ $stage == ann || $stage == all ]]; then
  # twin-tower ANN baseline == faiss_search.py (exact MIPS, top-1000)
  $CLI tokenize --kind queries --style ance \
      --input $DATA_DIR/origin/dev_mevi_dedup.tsv \
      --output $DATA_DIR/ance/dev_queries --length 32 $TOKENIZER_FLAGS
  $CLI gen-embeddings --config $CFG \
      --checkpoint $DATA_DIR/ckpts/t5-ance.pt \
      --documents $DATA_DIR/ance/dev_queries --doc_length 32 \
      --output $DATA_DIR/ance/qemb.bin $DEVICE_FLAGS
  $CLI search --config $CFG \
      --doc_embeddings $DATA_DIR/ance/docemb.bin \
      --query_embeddings $DATA_DIR/ance/qemb.bin \
      --queries_tsv $DATA_DIR/origin/dev_mevi_dedup.tsv \
      --topk 1000 --bf16 --output $DATA_DIR/ance/ann1000.tsv $DEVICE_FLAGS
fi

if [[ $stage == ensemble || $stage == all ]]; then
  # == marco_ensemble.sh: fuse ANN + coarse + fine lists
  $CLI ensemble \
      --gt_file $DATA_DIR/origin/dev_mevi_dedup.tsv \
      --ance_file $DATA_DIR/ance/ann1000.tsv \
      --coarse_file $DATA_DIR/ance/nci_result_rq45_top10_coarse.tsv \
      --fine_file $DATA_DIR/ance/nci_result_rq45_top10_hn.tsv \
      --mapping_file $DATA_DIR/ance/index/rq_codes.npy \
      --ofile $DATA_DIR/ance/ensemble_result.txt
fi

if [[ $stage == train-joint ]]; then
  # == the --codebook 1 joint mode (main.py:36-174): NCI + codebook +
  # twin tower with runtime RQ labels, in-cluster negatives, EMA books,
  # NCI/twin alternation, validation-driven RQ refit, resume
  $CLI train-joint --config $CFG \
      --queries $DATA_DIR/ance/train_queries --query_length 32 \
      --train_tsv $DATA_DIR/origin/train_mevi.tsv \
      --documents $DATA_DIR/ance/all_document --doc_length 128 \
      --codebooks $DATA_DIR/ance/index/rq_codebooks.npy \
      --codes $DATA_DIR/ance/index/rq_codes.npy \
      --tower_ckpt $DATA_DIR/ckpts/t5-ance.pt \
      --pq_update ema --alt_epochs 2,3 \
      --dev_tsv $DATA_DIR/origin/dev_mevi_dedup.tsv \
      --resume best --log_dir $DATA_DIR/logs \
      $TOKENIZER_FLAGS $DEVICE_FLAGS
fi

if [[ $stage == hier ]]; then
  # non-RQ NCI id space: hierarchical k-means ids + prefix clusters +
  # trie tables (prepare_clus equivalent)
  $CLI build-hier --config $CFG \
      --embeddings $DATA_DIR/ance/docemb.bin \
      --output_dir $DATA_DIR/ance/hier --k 30 --c 30 --layers 1,2,3 \
      $DEVICE_FLAGS
fi
