#!/bin/bash
# MUSDB18 / cunet training recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/musdb18/cunet/train.sh) plus --device
# (default cuda; --device cpu runs the plain versions of the kernels).
# Every stem's condition trained in one batched step, L1 loss.
# Extra flags pass straight through to the CLI (Kaldi-style --flag value).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
musdb18_root="${musdb18_root:-../../../dataset/MUSDB18}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
conditioning="${conditioning:-film}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.train_musdb18 \
    --musdb18_root "$musdb18_root" --exp_dir "$exp_dir" \
    --model cunet --conditioning "$conditioning" --criterion l1loss \
    --n_fft 1024 --hop_length 768 \
    --cunet_channels 2,16,32,64,128,256 --cunet_control_channels 4,16,64 \
    --batch_size 4 --lr 1e-3 --device "$device" \
    "$@" | tee -a "$exp_dir/train.log"
