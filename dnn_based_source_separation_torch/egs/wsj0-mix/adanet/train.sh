#!/bin/bash
# wsj0-mix / adanet training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/wsj0-mix/adanet/train.sh) plus
# --device (default cuda; --device cpu runs the plain versions of the kernels).
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
wav_root_train="${wav_root_train:-../../../dataset/wsj0-mix/2speakers/wav8k/min/tr}"
wav_root_valid="${wav_root_valid:-../../../dataset/wsj0-mix/2speakers/wav8k/min/cv}"
list_train="${list_train:-../../../dataset/wsj0-mix/2speakers/mix_2_spk_min_tr_mix}"
list_valid="${list_valid:-../../../dataset/wsj0-mix/2speakers/mix_2_spk_min_cv_mix}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.train_wsj0mix_spec \
    --model adanet \
    --train_wav_root "$wav_root_train" --train_list_path "$list_train" \
    --valid_wav_root "$wav_root_valid" --valid_list_path "$list_valid" \
    --exp_dir "$exp_dir" \
    --n_fft 256 --hop_length 64 --ideal_mask wfm --threshold 40 \
    -K 20 -H 300 -B 4 -N 6 --dropout 0.5 --duration 0.8 \
    --criterion se --optimizer adam --lr 1e-3 --batch_size 64 --epochs 150 \
    --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
