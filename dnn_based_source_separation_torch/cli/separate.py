"""Separate a WAV file with a trained checkpoint (file-based demo).

Port of `dnn_based_source_separation_tpu/cli/separate.py`: read a mixture
WAV, run the model on `--device` in `--dtype`, write one peak-normalized WAV
per source. With `--streaming_hop` a causal Conv-TasNet, stream-safe causal
DPRNN-TasNet or causal LSTM-TasNet (trainable encoder) checkpoint runs hop by
hop through exact streaming (`models/streaming.py`), whose output equals the
offline forward's. With `--chunk_duration` (and no `--streaming_hop`) any
model runs over 50%-overlapping chunks of that many seconds, crossfaded
(`models/longform.py`).

    python -m dnn_based_source_separation_torch.cli.separate \
        --model_path best.pth --input mix.wav --out_dir out [--dtype bfloat16] \
        [--streaming_hop 0.05 | --chunk_duration 4]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.audio_io import read_wav, write_wav
from ..models.base import load_model
from ..models.fold import fold_for_serving
from ..models.longform import separate_longform
from ..models.streaming import ExactStreamingSeparator
from ..utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser("separate")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--input", type=str, required=True, help="mixture wav")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--chunk_duration", type=float, default=None,
                   help="long-form: run the model over 50%%-overlapping chunks of this many "
                        "seconds, crossfaded")
    p.add_argument("--streaming_hop", type=float, default=None,
                   help="causal Conv-TasNet, stream-safe causal DPRNN-TasNet and causal "
                        "LSTM-TasNet (trainable encoder) checkpoints only: run the file through exact chunk-by-chunk streaming with this "
                        "hop in seconds (output identical to the offline forward)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
    return p


def stream_file(model, x: np.ndarray, hop_seconds: float, sr: int) -> np.ndarray:
    """Separate x (T,) hop by hop with exact streaming, as the JAX CLI does -> (n_src, T)."""
    L = int(model.kernel_size)
    stride = int(model.stride or L // 2)
    hop = max(max(int(hop_seconds * sr) // stride, 1) * stride, L)
    stream = ExactStreamingSeparator(model, hop_samples=hop)
    # The offline forward's stride-grid pad (pl, pr), so streamed == offline
    # for any length; whole hops, then the rest through finish().
    T = x.shape[0]
    grid_pad = (stride - (T - L) % stride) % stride
    pl = grid_pad // 2
    xp = np.concatenate([np.zeros(pl, np.float32), x, np.zeros(grid_pad - pl, np.float32)])
    n_full = len(xp) // hop
    outs = [stream.process(xp[lo:lo + hop]) for lo in range(0, n_full * hop, hop)]
    outs.append(stream.finish(xp[n_full * hop:]))
    return torch.cat(outs, dim=-1)[:, pl:pl + T].cpu().numpy()


def main(args=None):
    args = build_parser().parse_args(args)
    device = resolve_device(args.device)

    model = load_model(args.model_path, device=device)
    # Inference-time gLN affine fold, pad-free 'heads' mode, under the JAX
    # CLI's condition; a checkpoint saved already folded is left as it is.
    model = fold_for_serving(model)
    dtype = DTYPES[args.dtype]
    model = model.to(dtype).eval()

    x, sr = read_wav(args.input)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if args.streaming_hop:
        est = stream_file(model, np.asarray(x, np.float32), args.streaming_hop, sr)
    else:
        with torch.inference_mode():
            mixture = torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)[None, None]
            if args.chunk_duration:
                est = separate_longform(model, mixture, int(args.chunk_duration * sr),
                                        int(model.n_sources))[0]
            else:
                est = model(mixture)[0]
            est = est.float().cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for s in range(est.shape[0]):
        sig = est[s] / (np.abs(est[s]).max() + 1e-9)
        write_wav(os.path.join(args.out_dir, f"source{s}.wav"), sig, sr)
    print(f"wrote {est.shape[0]} sources to {args.out_dir}", flush=True)
    return est


if __name__ == "__main__":
    main()
