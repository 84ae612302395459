#!/bin/bash
# wsj0-mix / sepformer training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/wsj0-mix/sepformer/train.sh) plus
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

python -m dnn_based_source_separation_torch.cli.train_wsj0mix \
    --model sepformer \
    --train_wav_root "$wav_root_train" --train_list_path "$list_train" \
    --valid_wav_root "$wav_root_valid" --valid_list_path "$list_valid" \
    --exp_dir "$exp_dir" \
    -N 256 -L 16 -K 250 --sep_hop_size 125 --sep_num_blocks 2 --sep_num_layers 8 --sep_num_heads 8 --sep_bottleneck_channels 256 --mask_nonlinear relu --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
