#!/bin/bash
# wsj0-mix / ORPIT Conv-TasNet evaluation recipe for the PyTorch port, on one CUDA card.
# The flags of the JAX package's recipe (egs/wsj0-mix/orpit_conv-tasnet/test.sh) plus
# --device (default cuda).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
wav_root_test="${wav_root_test:-../../../dataset/wsj0-mix/2+3speakers/wav8k/min/tt}"
list_test="${list_test:-../../../dataset/wsj0-mix/2+3speakers/mix_2+3_spk_min_tt_mix}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"
model_choice="${model_choice:-best}"

python -m dnn_based_source_separation_torch.cli.test_wsj0mix \
    --test_wav_root "$wav_root_test" --test_list_path "$list_test" \
    --model_path "$exp_dir/model/$model_choice.ckpt" \
    --out_dir "$exp_dir/test" --device "$device" \
    "$@" | tee -a "$exp_dir/test.log"
