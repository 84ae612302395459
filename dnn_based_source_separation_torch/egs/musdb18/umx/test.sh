#!/bin/bash
# MUSDB18 / umx evaluation recipe for the PyTorch port, on one CUDA card: chunked
# full-track inference, the multichannel Wiener EM and museval-v4 medians of medians
# per stem. The flags of the JAX package's recipe (egs/musdb18/umx/test.sh) plus
# --device (default cuda).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
musdb18_root="${musdb18_root:-../../../dataset/MUSDB18}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"
model_choice="${model_choice:-best}"

python -m dnn_based_source_separation_torch.cli.test_musdb18 \
    --musdb18_root "$musdb18_root" \
    --model_path "$exp_dir/model/$model_choice.ckpt" \
    --out_dir "$exp_dir/test" --device "$device" \
    "$@" | tee -a "$exp_dir/test.log"
