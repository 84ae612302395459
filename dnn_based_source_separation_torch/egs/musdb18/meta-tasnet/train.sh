#!/bin/bash
# MUSDB18 / meta-tasnet training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/musdb18/meta-tasnet/train.sh) plus --device
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
    --model meta-tasnet \
    -N 440 -L 20 -HH 160 -B 160 -Sc 160 -X 8 -R 3 \
    --duration 8 --batch_size 4 --lr 1e-3 \
    --exp_dir "$exp_dir" --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
