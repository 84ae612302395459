"""Separate a WAV file with a trained checkpoint (file-based demo).

Port of `dnn_based_source_separation_tpu/cli/separate.py`, offline path:
read a mixture WAV, run the model on `--device` in `--dtype`, write one
peak-normalized WAV per source.

    python -m dnn_based_source_separation_torch.cli.separate \
        --model_path best.pth --input mix.wav --out_dir out [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav

from ..models.base import load_model
from ..models.fold import fold_gln_affine
from ..models.tdcn import fold_mode

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser("separate")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--input", type=str, required=True, help="mixture wav")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--chunk_duration", type=float, default=None,
                   help="long-form chunking (not ported yet)")
    p.add_argument("--streaming_hop", type=float, default=None,
                   help="exact streaming (not ported yet)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
    return p


def main(args=None):
    args = build_parser().parse_args(args)
    if args.chunk_duration:
        raise NotImplementedError("--chunk_duration (long-form) is not ported yet")
    if args.streaming_hop:
        raise NotImplementedError("--streaming_hop (exact streaming) is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asked for, but CUDA is not available")

    model = load_model(args.model_path, device=device)
    # Inference-time gLN affine fold, pad-free 'heads' mode, under the JAX
    # CLI's condition; a checkpoint saved already folded is left as it is.
    if (type(model).__name__ == "ConvTasNet"
            and not model.causal
            and (model.separable or not model.sep_norm)
            and fold_mode(model.fold_norm_affine) == "none"):
        model, _ = fold_gln_affine(model, model.state_dict(), mode="heads")
    dtype = DTYPES[args.dtype]
    model = model.to(dtype).eval()

    x, sr = read_wav(args.input)
    if x.ndim > 1:
        x = x.mean(axis=1)
    with torch.inference_mode():
        mixture = torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)[None, None]
        est = model(mixture)[0].float().cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for s in range(est.shape[0]):
        sig = est[s] / (np.abs(est[s]).max() + 1e-9)
        write_wav(os.path.join(args.out_dir, f"source{s}.wav"), sig, sr)
    print(f"wrote {est.shape[0]} sources to {args.out_dir}", flush=True)
    return est


if __name__ == "__main__":
    main()
