"""Drive the PyTorch port's serving paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed):
  1. device: require CUDA, print the card's name and power limit, turn TF32 off;
  2. build: compile csrc/mask_decode.cu and csrc/lstm_scan.cu with nvcc for
     sm_90a, both at once;
  3. kernel vs plain: fused_mask_decode against its plain PyTorch version on
     the card, f32 and bf16, at the Conv-TasNet serving shape, the DPRNN-TasNet
     decoder shape and three others, timed with CUDA events at the two
     serving shapes;
  3b. lstm_scan_bidir and lstm_scan against their plain versions, f32 and
     bf16, at the intra- and inter-chunk serving shapes (timed), an odd small
     shape, T=1, and H=256 and 512;
  4. serve: paper-config Conv-TasNet (random weights from seed 0) through
     cli/separate.py on three mixtures in float32 and bfloat16, counting the
     kernel's launches;
  4b. serve: recipe-config DPRNN-TasNet, non-causal and causal (random weights
     from seed 0), the same way; each request must launch the LSTM kernels and
     the decode kernel;
  5. card vs CPU: the f32 card output against the CPU (plain) output, and the
     bf16 card output against the f32 card output, for every served model;
  6. throughput (informational): B=8 x 4 s bf16 forward, and CLI latency,
     for each served model.

Each serving path runs with every launch count set to 0 just before it and
read just after it. The last line is {"ok": true, "device": {...}}; the line
before it lists the kernels with their launch counts, errors and times.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dnn_based_source_separation_torch.cli import separate as cli
from dnn_based_source_separation_torch.models import ConvTasNet, DPRNNTasNet
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.fold import fold_gln_affine
from dnn_based_source_separation_torch.ops import _build
from dnn_based_source_separation_torch.ops import lstm_scan as ls
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
# Recipe config, N64 L2 stride 1, K250 P125, 6 blocks, bottleneck 64, hidden
# 128, LSTM, sigmoid masks (egs/wsj0-mix/dprnn-tasnet/train.sh:22 and the
# defaults of cli/train_wsj0mix.py:41-70); `causal` is set per variant.
DPRNN = dict(
    n_basis=64, kernel_size=2, stride=1, enc_basis="trainable", dec_basis="trainable",
    enc_nonlinear="relu", sep_bottleneck_channels=64, sep_hidden_channels=128,
    sep_chunk_size=250, sep_hop_size=125, sep_num_blocks=6, mask_nonlinear="sigmoid",
    rnn_type="lstm", n_sources=2,
)
SERVING_SHAPE = dict(B=8, S=2, T=3999, N=512, CL=16)  # B=8 x 4 s at 8 kHz
DPRNN_DECODE_SHAPE = dict(B=8, S=2, T=31999, N=64, CL=2)  # the same audio, DPRNN-TasNet
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}  # relative to max|plain|
# (name, B, T, H). At B=8 x 4 s the DPRNN-TasNet latent has T' = 31999 frames,
# padded to 32000 = 255 chunks of K = 250 at hop 125.
LSTM_SHAPES = [
    ("intra", 2040, 250, 128),  # B*S sequences of K steps
    ("inter", 2000, 255, 128),  # B*K sequences of S steps
    ("odd", 37, 19, 40),
    ("T=1", 3, 1, 128),
    # Wider hidden sizes the wrapper accepts: W_hh rows past the shared-memory
    # stage come from global memory in bf16 too, and fewer groups per block.
    ("H=256", 64, 33, 256),
    ("H=512", 16, 9, 512),
]
# Absolute, and |hs| < 1. f32: the kernel and the plain version sum the
# recurrent product in another order. bf16: both round h to bf16 each step,
# and a rounding that lands the other way feeds every later step.
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SNR_LIMIT_DB = 25.0


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
        (dict(DPRNN_DECODE_SHAPE), True),
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
            if shape in (SERVING_SHAPE, DPRNN_DECODE_SHAPE):
                ms = median_ms(lambda: md.fused_mask_decode(w, mask, kernel))
                plain_ms = median_ms(lambda: md.fused_mask_decode_reference(w, mask, kernel))
                which = "serving shape" if shape == SERVING_SHAPE else "DPRNN-TasNet decoder shape"
                log(f"  {which} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                    f"(median of 20, CUDA events)")
                if shape == SERVING_SHAPE:
                    result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return result


def lstm_inputs(B, T, H, dtype, seed):
    """Two chains' gates ~ N(0, 0.25) and recurrent weights ~ U(+-1/sqrt(H)), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xw = [0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen) for _ in range(2)]
    w = [(2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(2)]
    return [t.to(dtype) for t in (*xw, *w)]


def phase_lstm():
    log("== phase 3b: lstm_scan_bidir and lstm_scan vs plain on the card")
    result = {}
    for name, B, T, H in LSTM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xw_f, xw_b, w_f, w_b = lstm_inputs(B, T, H, dtype, seed=B + T + H)
            runs = {
                "lstm_scan_bidir": (lambda: ls.lstm_scan_bidir(xw_f, xw_b, w_f, w_b),
                                    lambda: ls.lstm_scan_bidir_reference(xw_f, xw_b, w_f, w_b)),
                "lstm_scan": (lambda: (ls.lstm_scan(xw_f, w_f),),
                              lambda: (ls.lstm_scan_reference(xw_f, w_f),)),
            }
            for kname, (kernel, plain) in runs.items():
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    check(a.shape == b.shape == (B, T, H) and a.dtype == b.dtype == dtype,
                          (kname, a.shape, a.dtype))
                err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                ok = err <= LSTM_TOL[dtype]
                log(f"  {kname} {name} (B={B}, T={T}, H={H}) {str(dtype)[6:]}: "
                    f"max|kernel-plain| = {err:.3e} (limit {LSTM_TOL[dtype]:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kname} disagrees with plain at {name}: {err}")
                if name in ("intra", "inter"):
                    ms = median_ms(kernel, warmup=2, iters=10)
                    plain_ms = median_ms(plain, warmup=1, iters=3)
                    log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                        f"(medians of 10 and 3, CUDA events)")
                    result[(kname, name, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return result


def counts() -> dict:
    return {"fused_mask_decode": md.LAUNCHES, **ls.LAUNCHES}


def reset_counts() -> None:
    md.LAUNCHES = 0
    for name in ls.LAUNCHES:
        ls.LAUNCHES[name] = 0


def make_checkpoint(path, model):
    # Non-identity norm affines, so the norms (and the Conv-TasNet CLI's fold) do real work.
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.5 + rng.random(p.shape, np.float32)))
            elif name.endswith(".beta"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    save_model(path, model)


def write_mixtures(tmp):
    rng = np.random.default_rng(0)
    wavs = []
    for seconds in (1.0, 2.5, 4.0):
        path = os.path.join(tmp, f"mix_{seconds}s.wav")
        write_wav(path, 0.1 * rng.standard_normal(int(seconds * SAMPLE_RATE)), SAMPLE_RATE)
        wavs.append(path)
    return wavs


def serve(tag, ckpt, wavs, per_request):
    """Six requests (three mixtures x f32/bf16) through cli/separate.py.

    Every launch count is set to 0 first; each request must add exactly
    `per_request` launches. Returns the outputs and the path's counts.
    """
    tmp = os.path.dirname(ckpt)
    outputs = {}
    reset_counts()
    for dtype in ("float32", "bfloat16"):
        for wav in wavs:
            before = counts()
            out_dir = os.path.join(tmp, f"out_{tag}_{dtype}_{os.path.basename(wav)[:-4]}")
            est = cli.main(["--model_path", ckpt, "--input", wav, "--out_dir", out_dir,
                            "--device", "cuda", "--dtype", dtype])
            grew = {k: v - before[k] for k, v in counts().items()}
            n_in = read_wav(wav)[0].shape[0]
            files = sorted(os.listdir(out_dir))
            check(files == ["source0.wav", "source1.wav"], files)
            for f in files:
                sig, sr = read_wav(os.path.join(out_dir, f))
                check(sr == SAMPLE_RATE and sig.shape == (n_in,) and np.isfinite(sig).all(),
                      (f, sig.shape, n_in))
            check(est.shape == (2, n_in) and np.isfinite(est).all(), est.shape)
            check(grew == per_request,
                  f"request {wav} ({dtype}) launched {grew}, expected {per_request}")
            log(f"  {dtype} {os.path.basename(wav)}: 2 sources x {n_in} samples, "
                f"kernel launches {grew}")
            outputs[(dtype, wav)] = est
    launches = counts()
    log(f"  main-path kernel launches: {launches}")
    return outputs, launches


def phase_parity(tag, ckpt, wavs, outputs):
    log(f"== phase 5: card vs CPU, bf16 vs f32 ({tag})")
    wav = wavs[0]
    ref = cli.main(["--model_path", ckpt, "--input", wav, "--out_dir",
                    os.path.join(os.path.dirname(ckpt), f"out_{tag}_cpu"), "--device", "cpu"])
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
        log(f"  bf16 vs f32 on the card, {os.path.basename(w)}: SNR {snr:.2f} dB "
            f"(limit {SNR_LIMIT_DB:g})")
        if not snr >= SNR_LIMIT_DB:
            raise AssertionError(f"bf16 output SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
    return err


def cli_latency(ckpt, wav, what, card):
    tmp = os.path.dirname(ckpt)
    lat = []
    for _ in range(3):
        start = time.perf_counter()
        cli.main(["--model_path", ckpt, "--input", wav, "--out_dir",
                  os.path.join(tmp, "out_latency"), "--device", "cuda", "--dtype", "bfloat16"])
        lat.append(time.perf_counter() - start)
    log(f"  CLI request latency, 4 s mixture, bf16 ({what}): "
        f"median {np.median(lat) * 1e3:.1f} ms of {[round(v * 1e3, 1) for v in lat]} [{card}]")


def forward_throughput(model, what, card, warmup, iters):
    B, T = 8, 4 * SAMPLE_RATE
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 1, T), dtype=np.float32))
    x = x.to("cuda", torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=warmup, iters=iters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  B=8 x 4 s bf16 {what} forward: {ms:.3f} ms, {B * 4.0 / (ms / 1e3):.1f} "
        f"audio-s/s, peak {peak:.1f} MiB [{card}]")


def phase_throughput(ckpt, wavs, card):
    log("== phase 6: throughput (informational), Conv-TasNet")
    model = load_model(ckpt, device="cuda")
    model, _ = fold_gln_affine(model, model.state_dict(), mode="heads")
    forward_throughput(model.to(torch.bfloat16), "heads-fold", card, warmup=3, iters=20)
    cli_latency(ckpt, wavs[-1], "load + fold + forward + write", card)


def phase_throughput_dprnn(tag, ckpt, wavs, card):
    log(f"== phase 6: throughput (informational), {tag}")
    model = load_model(ckpt, device="cuda").to(torch.bfloat16)
    forward_throughput(model, tag, card, warmup=2, iters=5)
    cli_latency(ckpt, wavs[-1], "load + forward + write", card)


def kernel_entry(name, source, replaces, launches, timing):
    return {"name": name, "route": "cuda", "source": f"dnn_based_source_separation_torch/{source}",
            "replaces": f"dnn_based_source_separation_tpu/{replaces}", "launches": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"]}


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
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, both at once
        for build in [pool.submit(md.build), pool.submit(ls.build)]:
            build.result()
    log(f"  mask_decode and lstm_scan built/loaded in {time.perf_counter() - start:.2f} s")
    for name in ("mask_decode", "lstm_scan"):
        info = _build.BUILD_INFO[name]
        log(f"  {name} ({info['seconds']:.2f} s):")
        log("  " + info["log"].strip().replace("\n", "\n  "))

    timings = phase_kernel()
    lstm_timings = phase_lstm()
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_mixtures(tmp)
        log("== phase 4: serve paper-config Conv-TasNet through cli/separate.py")
        conv_ckpt = os.path.join(tmp, "conv_tasnet.pth")
        make_checkpoint(conv_ckpt, ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0),
                                              device="cuda"))
        conv_out, launches = serve("conv_tasnet", conv_ckpt, wavs, dict(
            fused_mask_decode=1, lstm_scan_bidir=0, lstm_scan=0))
        dprnn = {}
        for causal in (False, True):
            tag = "dprnn_tasnet_causal" if causal else "dprnn_tasnet"
            log(f"== phase 4b: serve recipe-config DPRNN-TasNet, causal={causal}, "
                f"through cli/separate.py")
            ckpt = os.path.join(tmp, f"{tag}.pth")
            make_checkpoint(ckpt, DPRNNTasNet(**DPRNN, causal=causal, device="cuda",
                                              generator=torch.Generator().manual_seed(0)))
            blocks = DPRNN["sep_num_blocks"]
            # Intra-chunk: one bidirectional layer per block; inter-chunk: one
            # more (non-causal) or one unidirectional layer (causal).
            outputs, path_launches = serve(tag, ckpt, wavs, dict(
                fused_mask_decode=1, lstm_scan_bidir=blocks if causal else 2 * blocks,
                lstm_scan=blocks if causal else 0))
            dprnn[tag] = (ckpt, outputs)
            launches = {k: v + path_launches[k] for k, v in launches.items()}
        phase_parity("Conv-TasNet", conv_ckpt, wavs, conv_out)
        for tag, (ckpt, outputs) in dprnn.items():
            phase_parity(tag, ckpt, wavs, outputs)
        phase_throughput(conv_ckpt, wavs, card)
        for tag, (ckpt, _) in dprnn.items():
            phase_throughput_dprnn(tag, ckpt, wavs, card)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the serving paths never launched {name}")
    check("jax" not in sys.modules and "flax" not in sys.modules, "jax was imported")

    bf16 = torch.bfloat16
    log(card)
    print(json.dumps({"kernels": [
        kernel_entry("fused_mask_decode", "csrc/mask_decode.cu", "ops/pallas_kernels.py:109",
                     launches["fused_mask_decode"], timings[bf16]),
        kernel_entry("lstm_scan_bidir", "csrc/lstm_scan.cu", "ops/pallas_lstm.py:250",
                     launches["lstm_scan_bidir"], lstm_timings[("lstm_scan_bidir", "intra", bf16)]),
        kernel_entry("lstm_scan", "csrc/lstm_scan.cu", "ops/pallas_lstm.py:62",
                     launches["lstm_scan"], lstm_timings[("lstm_scan", "inter", bf16)]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
