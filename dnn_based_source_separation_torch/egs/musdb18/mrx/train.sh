#!/bin/bash
# MUSDB18 / mrx training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/musdb18/mrx/train.sh) plus --device
# (default cuda; --device cpu runs the plain versions of the kernels).
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
musdb18_root="${musdb18_root:-../../../dataset/musdb18}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.train_musdb18 \
    --musdb18_root "$musdb18_root" \
    --model mrx --mrx_n_fft 512,1024,2048 --hop_length 256 \
    --hidden_channels 512 --num_layers 3 \
    --duration 6 --batch_size 16 --lr 1e-3 --samples_per_epoch 6400 \
    --exp_dir "$exp_dir" --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
