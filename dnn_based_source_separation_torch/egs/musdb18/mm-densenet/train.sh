#!/bin/bash
# MUSDB18 / mm-densenet training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/musdb18/mm-densenet/train.sh) plus --device
# (default cuda; --device cpu runs the plain versions of the kernels).
# The band-structured YAML is the repo's own (egs/musdb18/mm-densenet/config/paper.yaml).
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
musdb18_root="${musdb18_root:-../../../dataset/MUSDB18}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
config="${config:-$repo_root/egs/musdb18/mm-densenet/config/paper.yaml}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.train_musdb18 \
    --musdb18_root "$musdb18_root" --exp_dir "$exp_dir" \
    --model mm-densenet --mmdense_config "$config" \
    --n_fft 2048 --hop_length 1024 \
    --batch_size 6 --lr 1e-3 --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
