#!/usr/bin/env bash
# NQ-DPR pipeline of the PyTorch port: the stages and flags of
# scripts/nqdpr_pipeline.sh (nqdpr_{generate_embedding_n_rq,train_nci_rq,
# eval_nci_rq,ensemble}.sh, AR2/ERNIE twin tower) through
# mevi_tpu_torch.cli.main.  Run it from the directory that holds $CFG and
# the config's ckpt_dir, with mevi_tpu_torch importable.
#
# Inputs under $DATA_DIR:
#   raw/psgs_w100.tsv                 (DPR wikipedia passages)
#   raw/biencoder-nq-train.json       (DPR training data)
#   raw/nq-test.qa.csv                (questions + answer sets)
#   ckpts/ar2_nq.pkl                  (AR2 checkpoint, ctx/question towers)
#
# Stages: prepare, answers, index, train, eval, ensemble; `all` runs
# prepare, index, train and eval (eval reads what `answers` writes).
#
# Flags appended to the CLI calls, empty by default (the CLI's commands
# take different flags, so there are two):
#   TOKENIZER_FLAGS  the calls that tokenize text (tokenize, eval), e.g.
#                    --allow_hash_tokenizer where no HF tokenizer files are
#   DEVICE_FLAGS     the calls that run on the device (gen-embeddings,
#                    build-index, train, eval), e.g. --device cpu
set -euo pipefail
DATA_DIR=${DATA_DIR:-data/nq_dpr}
CFG=${CFG:-configs/nqdpr_rq4x5.json}
CLI="python -m mevi_tpu_torch.cli.main"
TOKENIZER_FLAGS=${TOKENIZER_FLAGS:-}
DEVICE_FLAGS=${DEVICE_FLAGS:-}

stage=${1:-all}

if [[ $stage == prepare || $stage == all ]]; then
  python - <<PY
from mevi_tpu_torch.data import io, prepare as P
import os
os.makedirs("$DATA_DIR/origin", exist_ok=True)
rows = list(P.nq_corpus_rows("$DATA_DIR/raw/psgs_w100.tsv"))
with open("$DATA_DIR/origin/corpus.tsv", "w") as fw:
    for did, title, text in rows:
        fw.write(f"{did}\t{title}\t{text}\n")
pairs = P.nq_biencoder_pairs("$DATA_DIR/raw/biencoder-nq-train.json")
io.write_query_docids_tsv("$DATA_DIR/origin/train_mevi.tsv",
                          [(q, [d]) for q, d in pairs])
PY
  mkdir -p $DATA_DIR/ar2  # the reference leaves it to exist already
  $CLI tokenize --kind corpus --style ar2 \
      --input $DATA_DIR/origin/corpus.tsv \
      --output $DATA_DIR/ar2/all_document --length 128 $TOKENIZER_FLAGS
fi

if [[ $stage == answers ]]; then  # answer arrays for test evaluation
  python - <<PY
import ast, csv, numpy as np
from mevi_tpu_torch.data import prepare as P
passages = []
with open("$DATA_DIR/origin/corpus.tsv") as fr:
    for line in fr:
        _, title, text = (line.rstrip("\n").split("\t") + ["", ""])[:3]
        passages.append(f"{title} {text}")
answers = []
with open("$DATA_DIR/raw/nq-test.qa.csv") as fr:
    for q, ans in csv.reader(fr, delimiter="\t"):
        answers.append(ast.literal_eval(ans))
offsets, array = P.build_answer_arrays(passages, answers)
offsets.tofile("$DATA_DIR/origin/test_inverse_offsets.bin")
array.tofile("$DATA_DIR/origin/test_inverse_array.bin")
PY
fi

if [[ $stage == index || $stage == all ]]; then
  $CLI gen-embeddings --config $CFG \
      --checkpoint $DATA_DIR/ckpts/ar2_nq.pkl \
      --documents $DATA_DIR/ar2/all_document \
      --output $DATA_DIR/ar2/docemb.bin $DEVICE_FLAGS
  $CLI build-index --config $CFG \
      --embeddings $DATA_DIR/ar2/docemb.bin \
      --output_dir $DATA_DIR/ar2/index --cache_dir $DATA_DIR/cache \
      $DEVICE_FLAGS
fi

if [[ $stage == train || $stage == all ]]; then
  $CLI tokenize --kind queries --style ar2 \
      --input $DATA_DIR/origin/train_mevi.tsv \
      --output $DATA_DIR/ar2/train_queries --length 32 $TOKENIZER_FLAGS
  $CLI train --config $CFG \
      --queries $DATA_DIR/ar2/train_queries --query_length 32 \
      --codes $DATA_DIR/ar2/index/rq_codes.npy \
      --train_tsv $DATA_DIR/origin/train_mevi.tsv \
      --log_dir $DATA_DIR/logs $DEVICE_FLAGS
fi

if [[ $stage == eval || $stage == all ]]; then
  # == nqdpr_eval_nci_rq.sh: beam-10 coarse + fine, answer-set hitrate
  # via the inverse doc->answering-query arrays
  python - <<PY
import csv
from mevi_tpu_torch.data import io
qs = []
with open("$DATA_DIR/raw/nq-test.qa.csv") as fr:
    for q, ans in csv.reader(fr, delimiter="\t"):
        qs.append(q.replace("’", "'"))
io.write_query_docids_tsv("$DATA_DIR/origin/test_queries.tsv",
                          [(q, [0]) for q in qs])
PY
  $CLI eval --config $CFG \
      --nci_ckpt ckpts/nci/best \
      --tower_ckpt $DATA_DIR/ckpts/ar2_nq.pkl \
      --embeddings $DATA_DIR/ar2/docemb.bin \
      --codes $DATA_DIR/ar2/index/rq_codes.npy \
      --dev_tsv $DATA_DIR/origin/test_queries.tsv \
      --nq_answer_offsets $DATA_DIR/origin/test_inverse_offsets.bin \
      --nq_answer_array $DATA_DIR/origin/test_inverse_array.bin \
      --num_return_sequences 10 --bf16 \
      --save_path $DATA_DIR/ar2/nci_result_rq45_top10.tsv \
      $TOKENIZER_FLAGS $DEVICE_FLAGS
fi

if [[ $stage == ensemble ]]; then
  # == ensemble_nqdpr.sh: fuse ANN + coarse/fine with answer-set eval
  $CLI ensemble \
      --gt_file $DATA_DIR/origin/test_queries.tsv \
      --ance_file $DATA_DIR/ar2/ann1000.tsv \
      --coarse_file $DATA_DIR/ar2/nci_result_rq45_top10_coarse.tsv \
      --fine_file $DATA_DIR/ar2/nci_result_rq45_top10_hn.tsv \
      --mapping_file $DATA_DIR/ar2/index/rq_codes.npy \
      --ofile $DATA_DIR/ar2/ensemble_result.txt
fi
