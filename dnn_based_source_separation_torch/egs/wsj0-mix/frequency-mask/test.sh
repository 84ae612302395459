#!/bin/bash
# wsj0-mix / oracle frequency-mask evaluation recipe for the PyTorch port, on one CUDA
# card: no training; the SI-SDR improvement of an ideal mask (--mask ibm, irm, wfm or psm)
# on the test set. The flags of the JAX package's recipe (egs/wsj0-mix/frequency-mask/
# test.sh) plus --device (default cuda).
set -o pipefail
repo_root="$(cd "$(dirname "${BASH_SOURCE[0]}")/../../../.." && pwd)"
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"
wav_root_test="${wav_root_test:-../../../dataset/wsj0-mix/2speakers/wav8k/min/tt}"
list_test="${list_test:-../../../dataset/wsj0-mix/2speakers/mix_2_spk_min_tt_mix}"
mask="${mask:-ibm}"
exp_dir="${exp_dir:-./exp}"
device="${device:-cuda}"
mkdir -p "$exp_dir"

python -m dnn_based_source_separation_torch.cli.test_oracle_masks \
    --test_wav_root "$wav_root_test" --test_list_path "$list_test" \
    --mask "$mask" --n_fft 256 --hop_length 64 --device "$device" \
    "$@" | tee -a "$exp_dir/test_${mask}.log"
