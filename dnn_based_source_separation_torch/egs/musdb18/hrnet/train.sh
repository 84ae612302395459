#!/bin/bash
# MUSDB18 / hrnet training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/musdb18/hrnet/train.sh) plus --device
# (default cuda; --device cpu runs the plain versions of the kernels).
# One model a stem (--target), magnitude MAE.
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
musdb18_root="${musdb18_root:-../../../dataset/MUSDB18}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
target="${target:-vocals}"
mkdir -p "$exp_dir/$target"

python -m dnn_based_source_separation_torch.cli.train_musdb18 \
    --musdb18_root "$musdb18_root" --exp_dir "$exp_dir/$target" \
    --model hrnet --target "$target" --criterion mae \
    --sample_rate 16000 --n_fft 1024 --hop_length 512 \
    --batch_size 5 --lr 1e-4 --samples_per_epoch 6400 --device "$device" \
    "$@" | tee -a "$exp_dir/$target/train.log"
