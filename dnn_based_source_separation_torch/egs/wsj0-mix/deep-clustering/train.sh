#!/bin/bash
# wsj0-mix / deep-clustering training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/wsj0-mix/deep-clustering/train.sh) plus
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
    --model deep-clustering \
    --train_wav_root "$wav_root_train" --train_list_path "$list_train" \
    --valid_wav_root "$wav_root_valid" --valid_list_path "$list_valid" \
    --exp_dir "$exp_dir" \
    --n_fft 256 --hop_length 64 --ideal_mask ibm --threshold 40 \
    -K 40 -H 300 -B 2 --duration 0.8 \
    --criterion affinity --optimizer momentum-sgd --lr 1e-5 --momentum 0.9 \
    --batch_size 64 --epochs 100 --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
