"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed):
  1. device: require CUDA, print the card's name and power limit, turn TF32 off;
  2. build: compile csrc/mask_decode.cu with nvcc for sm_90a;
  3. kernel vs plain: fused_mask_decode against its plain PyTorch version on
     the card, f32 and bf16, at the serving shape and three others, and both
     timed with CUDA events at the serving shape;
  4. serve: paper-config Conv-TasNet (random weights from seed 0) through
     cli/separate.py on three mixtures in float32 and bfloat16, counting the
     kernel's launches;
  5. card vs CPU: the f32 card output against the CPU (plain) output, and the
     bf16 card output against the f32 card output;
  6. throughput (informational): B=8 x 4 s bf16 forward, and CLI latency.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors and times.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dnn_based_source_separation_torch.cli import separate as cli
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.fold import fold_gln_affine
from dnn_based_source_separation_torch.ops import _build
from dnn_based_source_separation_torch.ops import mask_decode as md
from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav

SAMPLE_RATE = 8000
# Paper config, N512 L16 S8 B128 H512 Sc128 P3 X8 R3, non-causal gLN, sigmoid
# masks (reference egs/wsj0-mix/conv-tasnet/README.md:5).
PAPER = dict(
    n_basis=512, kernel_size=16, stride=8, enc_basis="trainable", dec_basis="trainable",
    enc_nonlinear="relu", sep_hidden_channels=512, sep_bottleneck_channels=128,
    sep_skip_channels=128, sep_kernel_size=3, sep_num_blocks=3, sep_num_layers=8,
    causal=False, n_sources=2,
)
SERVING_SHAPE = dict(B=8, S=2, T=3999, N=512, CL=16)  # B=8 x 4 s at 8 kHz
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}  # relative to max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_inputs(B, S, T, N, CL, dtype, strided, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((B, T, N), dtype=np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (B, T, S, N)).astype(np.float32))
    kernel = torch.from_numpy((0.1 * rng.standard_normal((N, CL))).astype(np.float32))
    w, mask, kernel = (t.to("cuda", dtype) for t in (w, mask, kernel))
    # The separator hands the decoder a (B, S, T', N) view of a (B, T', S, N)
    # tensor; the strided case feeds the kernel exactly that.
    mask = mask.transpose(1, 2) if strided else mask.transpose(1, 2).contiguous()
    return w, mask, kernel


def phase_kernel():
    log("== phase 3: fused_mask_decode vs plain on the card")
    cases = [
        (dict(SERVING_SHAPE), True),
        (dict(B=1, S=2, T=37, N=512, CL=16), False),
        (dict(B=2, S=2, T=1001, N=512, CL=32), True),
        (dict(B=1, S=2, T=129, N=512, CL=64), False),
    ]
    result = {}
    for shape, strided in cases:
        for dtype in (torch.float32, torch.bfloat16):
            w, mask, kernel = kernel_inputs(**shape, dtype=dtype, strided=strided, seed=shape["T"])
            got = md.fused_mask_decode(w, mask, kernel)
            ref = md.fused_mask_decode_reference(w, mask, kernel)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == torch.float32, (got.shape, got.dtype))
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            ok = err <= TOL[dtype] * scale
            log(f"  {shape} strided={strided} {str(dtype)[6:]}: max|kernel-plain| = {err:.3e} "
                f"(limit {TOL[dtype]:g} x max|plain| {scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_mask_decode disagrees with plain: {err} > "
                                     f"{TOL[dtype]} x {scale}")
            if shape == SERVING_SHAPE:
                ms = median_ms(lambda: md.fused_mask_decode(w, mask, kernel))
                plain_ms = median_ms(lambda: md.fused_mask_decode_reference(w, mask, kernel))
                log(f"  serving shape {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                    f"(median of 20, CUDA events)")
                result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return result


def make_checkpoint(path):
    model = ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0), device="cuda")
    # Non-identity gLN affines, so the CLI's fold does real work.
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.5 + rng.random(p.shape, np.float32)))
            elif name.endswith(".beta"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    save_model(path, model)


def phase_serve(tmp):
    log("== phase 4: serve paper-config Conv-TasNet through cli/separate.py")
    ckpt = os.path.join(tmp, "conv_tasnet.pth")
    make_checkpoint(ckpt)
    rng = np.random.default_rng(0)
    wavs = []
    for seconds in (1.0, 2.5, 4.0):
        path = os.path.join(tmp, f"mix_{seconds}s.wav")
        write_wav(path, 0.1 * rng.standard_normal(int(seconds * SAMPLE_RATE)), SAMPLE_RATE)
        wavs.append(path)

    outputs = {}
    md.LAUNCHES = 0
    for dtype in ("float32", "bfloat16"):
        for wav in wavs:
            before = md.LAUNCHES
            out_dir = os.path.join(tmp, f"out_{dtype}_{os.path.basename(wav)[:-4]}")
            est = cli.main(["--model_path", ckpt, "--input", wav, "--out_dir", out_dir,
                            "--device", "cuda", "--dtype", dtype])
            grew = md.LAUNCHES - before
            n_in = read_wav(wav)[0].shape[0]
            files = sorted(os.listdir(out_dir))
            check(files == ["source0.wav", "source1.wav"], files)
            for f in files:
                sig, sr = read_wav(os.path.join(out_dir, f))
                check(sr == SAMPLE_RATE and sig.shape == (n_in,) and np.isfinite(sig).all(),
                      (f, sig.shape, n_in))
            check(est.shape == (2, n_in) and np.isfinite(est).all(), est.shape)
            check(grew >= 1, f"request {wav} ({dtype}) did not launch the kernel")
            log(f"  {dtype} {os.path.basename(wav)}: 2 sources x {n_in} samples, "
                f"kernel launches +{grew}")
            outputs[(dtype, wav)] = est
    launches = md.LAUNCHES
    log(f"  main-path kernel launches: {launches}")
    return ckpt, wavs, outputs, launches


def phase_parity(ckpt, wavs, outputs):
    log("== phase 5: card vs CPU, bf16 vs f32")
    wav = wavs[0]
    ref = cli.main(["--model_path", ckpt, "--input", wav, "--out_dir",
                    os.path.join(os.path.dirname(ckpt), "out_cpu"), "--device", "cpu"])
    card = outputs[("float32", wav)]
    err = float(np.abs(card - ref).max())
    scale = float(np.abs(ref).max())
    log(f"  f32 card vs CPU (1 s): max abs err {err:.3e}, max|ref| {scale:.3e}, "
        f"limit {1e-3 * scale:.3e}")
    if not err <= 1e-3 * scale:
        raise AssertionError(f"card output disagrees with CPU: {err} > 1e-3 x {scale}")
    for w in wavs:
        f32, bf16 = outputs[("float32", w)], outputs[("bfloat16", w)]
        snr = 10 * np.log10(np.sum(f32 ** 2) / np.sum((bf16 - f32) ** 2))
        log(f"  bf16 vs f32 on the card, {os.path.basename(w)}: SNR {snr:.2f} dB (limit 25)")
        if not snr >= 25.0:
            raise AssertionError(f"bf16 output SNR {snr:.2f} dB < 25 dB")
    return err


def phase_throughput(ckpt, wavs, card):
    log("== phase 6: throughput (informational)")
    model = load_model(ckpt, device="cuda")
    model, _ = fold_gln_affine(model, model.state_dict(), mode="heads")
    model = model.to(torch.bfloat16)
    B, T = 8, 4 * SAMPLE_RATE
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 1, T), dtype=np.float32))
    x = x.to("cuda", torch.bfloat16)
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=3, iters=20)
    log(f"  B=8 x 4 s bf16 heads-fold forward: {ms:.3f} ms, {B * 4.0 / (ms / 1e3):.1f} "
        f"audio-s/s [{card}]")
    tmp = os.path.dirname(ckpt)
    lat = []
    for _ in range(3):
        start = time.perf_counter()
        cli.main(["--model_path", ckpt, "--input", wavs[-1], "--out_dir",
                  os.path.join(tmp, "out_latency"), "--device", "cuda", "--dtype", "bfloat16"])
        lat.append(time.perf_counter() - start)
    log(f"  CLI request latency, 4 s mixture, bf16 (load + fold + forward + write): "
        f"median {np.median(lat) * 1e3:.1f} ms of {[round(v * 1e3, 1) for v in lat]} [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    log("== phase 1: device")
    card = card_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 2: build")
    start = time.perf_counter()
    md.build()
    log(f"  mask_decode built/loaded in {time.perf_counter() - start:.2f} s")
    log("  " + _build.BUILD_INFO["mask_decode"]["log"].strip().replace("\n", "\n  "))

    timings = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, wavs, outputs, launches = phase_serve(tmp)
        phase_parity(ckpt, wavs, outputs)
        phase_throughput(ckpt, wavs, card)
    if launches < 1:
        raise AssertionError("the serving path never launched fused_mask_decode")
    check("jax" not in sys.modules and "flax" not in sys.modules, "jax was imported")

    serving = timings[torch.bfloat16]
    log(card)
    print(json.dumps({"kernels": [{
        "name": "fused_mask_decode", "route": "cuda",
        "source": "dnn_based_source_separation_torch/csrc/mask_decode.cu",
        "replaces": "dnn_based_source_separation_tpu/ops/pallas_kernels.py:109",
        "launches": launches, "max_abs_err": serving["max_abs_err"],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
