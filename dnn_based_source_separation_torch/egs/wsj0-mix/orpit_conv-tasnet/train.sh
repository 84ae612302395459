#!/bin/bash
# wsj0-mix / ORPIT Conv-TasNet training recipe for the PyTorch port, on one CUDA card:
# one-and-rest PIT over variable source counts (2+3 speakers).
# The flags of the JAX package's recipe (egs/wsj0-mix/orpit_conv-tasnet/train.sh) plus
# --device (default cuda; --device cpu runs the plain versions of the kernels).
# --n_sources is the most speakers an utterance has: the recipe's 2 reads no s3/ source
# of the 2+3 corpus; pass --n_sources 3 after it to train on the three-speaker ones too.
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
wav_root_train="${wav_root_train:-../../../dataset/wsj0-mix/2+3speakers/wav8k/min/tr}"
wav_root_valid="${wav_root_valid:-../../../dataset/wsj0-mix/2+3speakers/wav8k/min/cv}"
list_train="${list_train:-../../../dataset/wsj0-mix/2+3speakers/mix_2+3_spk_min_tr_mix}"
list_valid="${list_valid:-../../../dataset/wsj0-mix/2+3speakers/mix_2+3_spk_min_cv_mix}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.train_wsj0mix \
    --model conv-tasnet --criterion orpit \
    --train_wav_root "$wav_root_train" --train_list_path "$list_train" \
    --valid_wav_root "$wav_root_valid" --valid_list_path "$list_valid" \
    --exp_dir "$exp_dir" \
    -N 512 -L 16 -H 512 -B 128 -Sc 128 -P 3 -R 3 -X 8 --enc_nonlinear relu \
    --n_sources 2 --batch_size 4 --lr 1e-3 --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
