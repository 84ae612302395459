"""Drive the PyTorch port's serving, training and evaluation paths on one CUDA card and check them.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only 3e,3f    # phases 1 and 2, then the kernel phases named
    python3 chip_smoke.py --only 6s       # phases 1 and 2, then streaming ms per hop
    python3 chip_smoke.py --only 11       # phases 1 and 2, then musdb18 serving

Phases (any failure exits non-zero; nothing is caught and passed):
  1. device: require CUDA, print the card's name and power limit, turn TF32 off;
  2. build: compile csrc/mask_decode.cu, csrc/lstm_scan.cu, csrc/lstm_scan_bwd.cu,
     csrc/gru_scan.cu, csrc/gru_scan_bwd.cu and csrc/quantize.cu with nvcc for
     sm_90a, all at once, and require 0 bytes of stack in every kernel;
  3. kernel vs plain: fused_mask_decode against its plain PyTorch version on
     the card, f32 and bf16, at the Conv-TasNet serving shape, the DPRNN-TasNet
     decoder shape (and at a ragged T'), the LSTM-TasNet decoder shape (N=500,
     C·L=40), a streamed Conv-TasNet hop (B=1, T'=50) and others (N=61,
     C·L=80, S = 1 and 3, both "mma" tile counts,
     narrow and ragged N), contiguous and strided. Each case runs on the path
     _plan gives it ("rows", "mma" or "generic"; PATH_LAUNCHES must grow on
     that path) and, where that is "rows" or "mma", on the generic kernel too.
     At the three decoder shapes and the hop one whole wrapper call and the kernel alone
     (a CUDA graph of 10 launches a timing) are timed with CUDA events, the new path and the
     generic kernel in turns (generic, new, new, generic), beside the plain
     version, its bound and, in f32, einsum (the same function);
  3b. lstm_scan_bidir and lstm_scan against their plain versions, f32 and
     bf16, at the intra- and inter-chunk serving shapes (timed), an odd small
     shape, B=37 and T=19 at H=128 (rows past the tile), T=1, H=64, a streamed
     hop's three chunks (timed), and H=256 and 512. Each launch must take the path
     _plan gives: for H a multiple of 16 up to 128 the tensor cores, "mma" in
     bf16 and "tf32x3" (3xTF32, clusters of 2 or 4 blocks) in f32, the FMA kernel
     otherwise. Where a tensor-core kernel runs, it is launched ten more
     times, each output held to the limit, and the FMA kernel is forced too
     and held to the plain version; at the timed shapes it is timed between
     two timings of the tensor-core kernel;
  3c. gru_scan_bidir and gru_scan the same way;
  3d. the training forward (cs written; the tensor-core paths) and the
     backward kernels of lstm_scan_bidir and lstm_scan under autograd against
     the plain forward and lstm_scan_bwd_reference, f32 and bf16, at the recipe
     training shapes (B = 2 x 4 s, timed), an odd shape, T=1 and H=256. Each
     backward launch must take the path _plan_bwd gives: for H a multiple of
     16 up to 128 the split-TF32 tensor cores ("tf32x3" in f32, "tf32x2" in
     bf16; clusters of 2 or 4 blocks), the FMA kernel otherwise. Where the
     tensor cores run, ten more launches are checked and the FMA kernel is
     forced and checked too; at the training shapes the whole backward and
     the kernel alone are timed, FMA and tensor cores in turns (FMA, new,
     new, FMA); fused_mask_decode must refuse CUDA tensors that require grad;
  3e. the backward kernels of gru_scan_bidir and gru_scan under autograd
     against gru_scan_bwd_reference the same way;
  3f. quantize_int8 against its plain version, bit for bit, on every weight
     tensor of paper-config Conv-TasNet that quantize_state_dict quantizes
     (those JAX's quantize_params quantizes) and on a (4096, 4096) tensor
     (timed); stochastic rounding: every value the floor or the ceiling, and
     unbiased over 64 seeds;
  3g. the library calls beside the recurrence kernels (informational):
     cuDNN's nn.LSTM / nn.GRU forward and backward, f32 and bf16, at the
     kernels' timed shapes, input projection included; the port never calls
     them;
  4. serve: paper-config Conv-TasNet (random weights from seed 0) through
     cli/separate.py on three mixtures in float32 and bfloat16, counting the
     kernel's launches;
  4b. serve: recipe-config DPRNN-TasNet, non-causal and causal (random weights
     from seed 0), the same way; each request must launch the LSTM kernels and
     the decode kernel;
  4c. serve: the same with rnn_type='gru'; each request must launch the GRU
     kernels and the decode kernel, and no LSTM kernel;
  4d. stream: the stream-safe causal DPRNN-TasNet, LSTM and GRU, through
     cli/separate.py --streaming_hop 0.05; each request must launch exactly
     what its separator calls imply, and the f32 streamed output must match
     the offline stream-safe forward on the card;
  4f. stream: causal paper-config Conv-TasNet through cli/separate.py
     --streaming_hop 0.05; each request must launch fused_mask_decode exactly
     once per separator call and nothing else, and the f32 streamed output
     must match the offline causal forward on the card;
  4g. long-form: a 30 s mixture through cli/separate.py --chunk_duration 4
     with paper-config Conv-TasNet; each request must launch fused_mask_decode
     once per chunk, 14 real chunks bucketed to 16, and nothing else;
  4e. quantized weights: paper-config Conv-TasNet's weights quantized to int8
     on the card (one quantize_int8 launch per weight tensor, 99), dequantized,
     loaded and served through cli/separate.py; the SNR against the
     unquantized output is informational;
  5. card vs CPU: the f32 card output against the CPU (plain) output, and the
     bf16 card output against the f32 card output, for every served model,
     streamed ones included;
  6. throughput (informational): B=8 x 4 s bf16 forward (DPRNN-TasNet in f32
     too), and CLI latency, for each offline model; ms per 0.05 s hop, its
     real-time factor and the CLI latency for the streamed ones; long-form wall
     time per audio-second; `python -m dnn_based_source_separation_torch.bench`
     by default and with --streaming_hop 0.05 --causal, its JSON lines printed;
  7. one train step, card vs CPU: recipe-config DPRNN-TasNet (LSTM and GRU,
     non-causal and causal) and paper-config Conv-TasNet, same seed-made
     weights and batch, f32: the loss and every gradient, none all zero on the
     card, and the kernel launches of the step;
  8. train through cli/train_wsj0mix.py on a synthetic wsj0-style corpus:
     `python -m` for two epochs, then in-process --continue_from, causal,
     --mixed_precision 1, --rnn_type gru (f32, bf16, causal f32 and bf16) and Conv-TasNet
     runs, with the launches of every run checked against its steps and
     validation forwards; one step and one validation forward counted alone;
     a fixed batch must lower its loss over 20 steps; the trained checkpoints
     serve through cli/separate.py;
  9. training throughput (informational): p50 step time and audio-s/s, and a
     torch.profiler split of one DPRNN-TasNet step, LSTM and GRU, then of its
     backward alone: the backward launches by path (each on the tensor cores)
     and the ten longest device ops of the rest of the backward;
  10. evaluate the checkpoints phase 8 trained (Conv-TasNet, LSTM and GRU
     DPRNN-TasNet) through cli/test_wsj0mix.py --device cuda on a synthetic
     test list of uneven lengths, one utterance per call: exact launches per
     utterance, every metric within 0.05 dB of the same CLI with --device cpu,
     and the wall time per utterance split into forward and BSS-Eval;
  11. musdb18 serving: paper-config ParallelOpenUnmix and bridged X-UMX (seed-0
     weights, scrambled BatchNorm statistics and affines) in their
     SpectrogramMaskingWrapper, through cli/test_musdb18.py --device cuda on a
     synthetic musdb-layout corpus of two 20 s stereo tracks (two 10 s chunks
     each, S = 431 frames): exactly 12 lstm_scan_bidir launches a chunk per
     model, all on the FMA kernel (H = 256), and no other kernel; the same CLI
     with --device cpu (both models side by side in threads): the card's stems
     within 1e-3 x max|CPU|, every median SDR / ISR / SIR / SAR within 0.05 dB;
     the Wiener EM alone card vs CPU within 1e-3 relative, with its time and
     peak memory; per-chunk forward, Wiener and iSTFT ms, audio-s/s; causal
     UMX (lstm_scan, H = 512, fma) over one chunk card vs CPU; lstm_scan_bidir
     and lstm_scan alone at UMX's shapes beside cuDNN's nn.LSTM; the bench's
     `--model umx` and `--model xumx` lines.

Each serving, quantizing and evaluation path, and the training path of phase
8, runs with every launch count set to 0 just before it and read just after
it. Every recurrence forward and backward of phases 4b-4d, 6 and 7-10 is also
counted by path (the wrappers' PATH_LAUNCHES and BWD_PATH_LAUNCHES): each bf16
request and bf16 train step must launch only the bf16 tensor-core kernels
("mma" forward, "tf32x2" backward), each f32 one only the 3xTF32 kernels
("tf32x3"), and none the FMA kernels (the served and trained models have
H = 128); and every decode of phases 4-4g, 6, 8 and 10 on its planned
fused_mask_decode path ("mma" in bf16, "generic" for f32 Conv-TasNet,
"rows" for f32 DPRNN-TasNet). Phase 11's launches are counted apart:
UMX's recurrences run on the FMA kernel by design. The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels with their launch counts,
errors, times, bounds and library times: fused_mask_decode six times
(Conv-TasNet's and DPRNN-TasNet's decoder widths and a streamed Conv-TasNet
hop, f32 and bf16), each on its path with the launches of its width and
dtype (WIDTH_LAUNCHES; the hop rows phase 4f's hops), one whole
wrapper call as `ms` and the kernel alone (from a CUDA graph) as
`kernel_ms`, beside the generic kernel's `generic_ms` and
`generic_kernel_ms` (a "rows" or "mma" row); the recurrence
forwards and backwards twice, f32 (3xTF32) and bf16 (the tensor cores), each
with the FMA kernel's time in the same dtype and run as `fma_ms` (the f32
forwards and every backward also with the FMA kernel's bound as
`fma_bound_ms`; the backwards also with the kernel alone as `kernel_ms`,
`fma_kernel_ms` and `kernel_bound_ms`); and lstm_scan_bidir and lstm_scan once
more at UMX's shapes (B = 1, T = 431; H = 256 and 512), on the FMA kernel, with
phase 11's launches.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dnn_based_source_separation_torch.algorithm.frequency_mask import multichannel_wiener_filter
from dnn_based_source_separation_torch.bench import (
    DPRNN, MUSDB_SAMPLE_RATE, PAPER, PEAK_FLOPS, UMX, UMX_STFT,
)
from dnn_based_source_separation_torch.cli import separate as cli
from dnn_based_source_separation_torch.cli import test_musdb18 as musdb_cli
from dnn_based_source_separation_torch.cli import test_wsj0mix as test_cli
from dnn_based_source_separation_torch.cli import train_wsj0mix as train_cli
from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
from dnn_based_source_separation_torch.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_torch.data.musdb18 import WaveTestDataset as MusdbTestDataset
from dnn_based_source_separation_torch.data.synthetic import (
    _speaker_bank, synth_pseudo_speech, write_musdb_quality_corpus, write_quality_corpus,
)
from dnn_based_source_separation_torch.models import (
    ConvTasNet, CrossNetOpenUnmix, DPRNNTasNet, ParallelOpenUnmix, SpectrogramMaskingWrapper,
)
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.longform import chunk_count, separate_longform
from dnn_based_source_separation_torch.models.fold import fold_for_serving
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops import _build
from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_torch.ops import mask_decode as md
from dnn_based_source_separation_torch.ops import quantize as q8
from dnn_based_source_separation_torch.train import Evaluater, make_optimizer, make_train_step

SAMPLE_RATE = 8000
# PAPER: paper-config Conv-TasNet, N512 L16 S8 B128 H512 Sc128 P3 X8 R3,
# non-causal (entry.py); DPRNN: recipe-config DPRNN-TasNet, `causal` set per
# variant (bench.py).
SERVING_SHAPE = dict(B=8, S=2, T=3999, N=512, CL=16)  # B=8 x 4 s at 8 kHz
DPRNN_DECODE_SHAPE = dict(B=8, S=2, T=31999, N=64, CL=2)  # the same audio, DPRNN-TasNet
# The same audio through LSTM-TasNet's decoder (N=500, L=40, hop 20:
# egs/wsj0-mix/lstm-tasnet/train.sh:19): rows of 1000 bytes in bf16, not
# whole 16-byte vectors.
LSTM_TASNET_DECODE_SHAPE = dict(B=8, S=2, T=1599, N=500, CL=40)
# One streamed 0.05 s hop of causal Conv-TasNet after the first (T' = 49 on the
# first call, 50 after it), the mask the separator's strided view.
HOP_DECODE_SHAPE = dict(B=1, S=2, T=50, N=512, CL=16)
DECODE_SHAPES = {"serving shape": SERVING_SHAPE, "DPRNN-TasNet decoder shape": DPRNN_DECODE_SHAPE,
                 "LSTM-TasNet decoder shape": LSTM_TASNET_DECODE_SHAPE,
                 "streamed hop shape": HOP_DECODE_SHAPE}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}  # relative to max|plain|
DECODE_REPEATS = 10  # fused_mask_decode launches a timing of the kernel alone
# (name, B, T, H). At B=8 x 4 s the DPRNN-TasNet latent has T' = 31999 frames,
# padded to 32000 = 255 chunks of K = 250 at hop 125.
LSTM_SHAPES = [
    ("intra", 2040, 250, 128),  # B*S sequences of K steps
    ("inter", 2000, 255, 128),  # B*K sequences of S steps
    ("odd", 37, 19, 40),
    ("odd H=128", 37, 19, 128),  # bf16: rows past B in the tensor-core tile
    ("T=1", 3, 1, 128),
    ("H=64", 50, 17, 64),
    ("stream", 3, 250, 128),  # one streamed hop: three chunks of K steps (timed)
    # Wider hidden sizes the wrapper accepts: W_hh rows past the shared-memory
    # stage come from global memory in bf16 too, and fewer groups per block.
    ("H=256", 64, 33, 256),
    ("H=512", 16, 9, 512),
]
# Absolute, and |hs| < 1. f32: the kernel and the plain version sum the
# recurrent product in another order. bf16: both round h to bf16 each step,
# and a rounding that lands the other way feeds every later step.
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
REPEATS = 10  # further launches of each tensor-core recurrence kernel, each checked
SNR_LIMIT_DB = 25.0
STREAMING_HOP = 0.05  # seconds: 400 samples at 8 kHz
STREAM_TOL = 1e-4  # streamed vs offline f32, relative to max|offline|
CHUNK_DURATION = 4.0  # seconds: long-form chunks of 32000 samples at a hop of 16000
LONGFORM_SECONDS = 30.0  # 14 real chunks, bucketed to 16

# The least time for a kernel's work is the larger of its operations over
# the peak for their type (bench.PEAK_FLOPS: one H100 SXM at its full 700 W)
# and its bytes (each input read once, each output written once) over the
# memory rate.
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak) -> dict:
    """`peak` keys PEAK_FLOPS: a dtype, or "tf32"."""
    return bound_of_ops({peak: flops}, nbytes)


def bound_of_ops(ops: dict, nbytes: float) -> dict:
    """The least time of work that runs ops[peak] operations at each PEAK_FLOPS rate, one
    after the other, and moves `nbytes`."""
    ops_s = sum(flops / PEAK_FLOPS[peak] for peak, flops in ops.items())
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading line also gets the seconds since the start."""
    if msg.startswith("=="):
        msg += f" [{time.perf_counter() - START:.1f} s]"
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


def graph_ms(launch, repeats: int) -> float:
    """ms of one launch() on the card alone: `repeats` launches captured in one CUDA
    graph, its replay timed by median_ms, over `repeats`."""
    launch()  # the first call of a path sets its kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            launch()
    return median_ms(graph.replay) / repeats


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


def mask_decode_bound(B, S, T, N, CL, dtype) -> dict:
    """The least time of fused_mask_decode's work: w, mask and K read once in
    their dtype, the f32 output written once; (w * mask) @ K per frame."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (B * T * N * (1 + S) + N * CL) + 4.0 * B * S * T * CL
    return bound(B * S * T * N * (2.0 * CL + 1), nbytes, dtype)


def mask_decode_library(w, mask, kernel):
    """One PyTorch call for the same function: in f32 it is fused_mask_decode."""
    return torch.einsum("btn,bstn,nc->bstc", w, mask, kernel)


def on_path(paths, name, call, want):
    """Run one call; it must have launched `name` once, on path `want`. `paths`: the
    wrapper's launch counts of `name` by path."""
    before = dict(paths)
    out = call()
    torch.cuda.synchronize()
    grew = {p: n - before[p] for p, n in paths.items()}
    check(grew == {p: int(p == want) for p in grew}, f"{name} took {grew}, expected {want}")
    return out


def phase_kernel():
    """fused_mask_decode against its plain version on the path `_plan` gives each case,
    and on the generic kernel too where that is "rows" or "mma"; timed at the decoder
    shapes of Conv-TasNet, DPRNN-TasNet and LSTM-TasNet (the new path and the generic
    kernel in turns: generic, new, new, generic), with its bound and einsum's time (f32,
    where einsum computes the same function)."""
    log("== phase 3: fused_mask_decode vs plain on the card")
    cases = [
        (dict(SERVING_SHAPE), True),
        (dict(HOP_DECODE_SHAPE), True),
        (dict(B=1, S=2, T=37, N=512, CL=16), False),
        (dict(B=2, S=2, T=1001, N=512, CL=32), True),
        (dict(B=1, S=2, T=129, N=512, CL=64), False),
        (dict(DPRNN_DECODE_SHAPE), True),
        # Frames past the last whole work item of "rows" (8 frames) and of
        # "mma" (8 frames); an odd S and S = 1 (the last pair's second source
        # masked); narrow N and both n8-tile counts of "mma"; N past the last
        # whole 32-wide chunk and C·L past the last n8 tile; widths "rows" does
        # not take in f32.
        (dict(B=3, S=2, T=4001, N=64, CL=2), True),
        (dict(B=2, S=3, T=77, N=64, CL=2), True),
        (dict(B=2, S=1, T=77, N=64, CL=2), False),
        (dict(B=2, S=3, T=77, N=512, CL=16), True),
        (dict(B=2, S=2, T=99, N=16, CL=4), False),
        (dict(B=2, S=2, T=99, N=32, CL=1), True),
        (dict(B=2, S=2, T=99, N=128, CL=16), True),
        (dict(B=2, S=2, T=99, N=256, CL=8), False),
        (dict(B=2, S=2, T=77, N=200, CL=12), False),
        # Widths past the 16-byte vectors and past 64 columns of K.
        (dict(LSTM_TASNET_DECODE_SHAPE), True),
        (dict(LSTM_TASNET_DECODE_SHAPE), False),
        (dict(B=2, S=2, T=333, N=61, CL=2), True),
        (dict(B=2, S=2, T=333, N=61, CL=2), False),
        (dict(B=2, S=2, T=257, N=512, CL=80), True),
        (dict(B=2, S=2, T=257, N=512, CL=80), False),
    ]
    result = {}
    for shape, strided in cases:
        for dtype in (torch.float32, torch.bfloat16):
            w, mask, kernel = kernel_inputs(**shape, dtype=dtype, strided=strided, seed=shape["T"])
            path = md.launch_plan(w, mask, kernel)
            ref = md.fused_mask_decode_reference(w, mask, kernel)
            scale = float(ref.abs().max())
            calls = {p: (lambda p=p: md.fused_mask_decode(w, mask, kernel, path=p))
                     for p in dict.fromkeys((path, "generic"))}
            errs = {}
            for p, call in calls.items():
                got = on_path(md.PATH_LAUNCHES, "fused_mask_decode", call, p)
                check(got.shape == ref.shape and got.dtype == torch.float32, (got.shape, got.dtype))
                errs[p] = float((got - ref).abs().max())
                ok = errs[p] <= TOL[dtype] * scale
                log(f"  {shape} strided={strided} {str(dtype)[6:]} {p}: max|kernel-plain| = "
                    f"{errs[p]:.3e} (limit {TOL[dtype]:g} x max|plain| {scale:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_mask_decode ({p}) disagrees with plain: "
                                         f"{errs[p]} > {TOL[dtype]} x {scale}")
            which = next((k for k, v in DECODE_SHAPES.items() if v == shape), None)
            if which is not None and strided:
                # `ms` is one whole wrapper call, as the decoder makes it (planning,
                # allocation and the ctypes call included); `kernel_ms` is the kernel
                # alone, from a CUDA graph of DECODE_REPEATS launches, so that the
                # host's time a launch (which the hop shape's kernel is shorter than)
                # stays out of it.
                alone = {p: md._staged(w, mask, kernel, p)[0] for p in calls}

                def call_ms(p):
                    return median_ms(calls[p])

                def kernel_ms(p):
                    return graph_ms(alone[p], DECODE_REPEATS)

                timing = dict(path=path, max_abs_err=errs[path], library_ms=None)
                if path != "generic":
                    for key, time_of in (("ms", call_ms), ("kernel_ms", kernel_ms)):
                        first = time_of("generic")
                        new = [time_of(path), time_of(path)]
                        again = time_of("generic")
                        timing.update({key: sum(new) / 2, f"generic_{key}": (first + again) / 2})
                        timing[f"{key}_turns"] = (first, *new, again)
                    timing["generic_max_abs_err"] = errs["generic"]
                    times = "; ".join(
                        f"{what} {path} {t[1]:.4f} / {t[2]:.4f} ms between generic {t[0]:.4f} / "
                        f"{t[3]:.4f} ms" for what, t in (("one call", timing.pop("ms_turns")),
                                                        ("kernel alone",
                                                         timing.pop("kernel_ms_turns"))))
                else:
                    timing.update(ms=call_ms(path), kernel_ms=kernel_ms(path))
                    times = (f"generic: one call {timing['ms']:.4f} ms, kernel alone "
                             f"{timing['kernel_ms']:.4f} ms")
                timing["plain_ms"] = median_ms(lambda: md.fused_mask_decode_reference(w, mask,
                                                                                      kernel))
                timing.update(mask_decode_bound(**shape, dtype=dtype))
                if dtype == torch.float32:
                    lib = mask_decode_library(w, mask, kernel)
                    check(float((lib - ref).abs().max()) <= TOL[dtype] * scale,
                          "einsum is not the same function")
                    timing["library_ms"] = median_ms(lambda: mask_decode_library(w, mask, kernel))
                library = ("" if timing["library_ms"] is None
                           else f"einsum {timing['library_ms']:.4f} ms, ")
                log(f"  {which} {str(dtype)[6:]}: {times}, plain {timing['plain_ms']:.4f} ms, "
                    f"{library}bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}) "
                    f"(medians of 20, CUDA events)")
                for p, launch in alone.items():  # after a few hundred launches into one output
                    err = float((launch() - ref).abs().max())
                    check(err <= TOL[dtype] * scale, f"fused_mask_decode ({p}) disagrees with "
                                                     f"plain after the timed launches: {err}")
                result[(which, dtype)] = timing
    return result


def lstm_inputs(B, T, H, dtype, seed):
    """Two chains' gates ~ N(0, 0.25) and recurrent weights ~ U(+-1/sqrt(H)), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xw = [0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen) for _ in range(2)]
    w = [(2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(2)]
    return [t.to(dtype) for t in (*xw, *w)]


def gru_inputs(B, T, H, dtype, seed):
    """Two chains' input projections ~ N(0, 0.25), recurrent weights ~ U(+-1/sqrt(H)) and
    b_hh ~ N(0, 0.01), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xw = [0.5 * torch.randn(B, T, 3 * H, device="cuda", generator=gen) for _ in range(2)]
    w = [(2 * torch.rand(H, 3 * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(2)]
    b = [0.1 * torch.randn(3 * H, device="cuda", generator=gen) for _ in range(2)]
    return [t.to(dtype) for t in (*xw, *w, *b)]


def forward_path(module, kname, call, want):
    """Run one forward call; it must have launched `kname` once, on path `want`."""
    return on_path(module.PATH_LAUNCHES[kname], kname, call, want)


def plan(module, B, n_chains, H, dtype, path=None):
    """module._plan as the wrapper calls it on this card -> (path, tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = module._tf32_clusters(H, "cuda") if ls._tensor_core_path(H, dtype) else None
    return module._plan(B, n_chains, H, dtype, sms, path, clusters)


def phase_scan(title, module, make_inputs, runs):
    """Recurrence kernels against their plain versions at LSTM_SHAPES, f32 and bf16.

    runs(*inputs) -> {kernel name: (kernel call, plain call, FMA-forced call)}, each
    call returning a tuple of hs. Every launch must take the path `_plan` gives its
    dtype and shape; where that is a tensor-core path ("mma" in bf16, "tf32x3" in
    f32), the FMA kernel is forced and held to the plain version too. At the intra
    and inter serving shapes and the streamed hop the kernel is timed: the
    tensor-core kernel, the FMA kernel and the tensor-core kernel again, in turn.
    """
    log(title)
    result = {}
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the 3xTF32 kernel the card holds at once, by blocks a cluster "
        f"(H={H}): {module._tf32_clusters(H, 'cuda')}")
    for name, B, T, H in LSTM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = make_inputs(B, T, H, dtype, seed=B + T + H)
            for kname, (kernel, plain, fma) in runs(*inputs).items():
                n_chains = 2 if kname.endswith("bidir") else 1
                path, tile = plan(module, B, n_chains, H, dtype)
                calls = {path: kernel}
                if path != "fma":
                    calls["fma"] = fma
                ref = plain()
                errs = {}
                for p, call in calls.items():
                    got = forward_path(module, kname, call, p)
                    for a, b in zip(got, ref):
                        check(a.shape == b.shape == (B, T, H) and a.dtype == b.dtype == dtype,
                              (kname, a.shape, a.dtype))
                    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                    errs[p] = err
                    ok = err <= LSTM_TOL[dtype]
                    _, p_tile = plan(module, B, n_chains, H, dtype, p)
                    p_tile = (f"M={p_tile[0]}, C={p_tile[1]}" if isinstance(p_tile, tuple)
                              else f"{'R' if p == 'fma' else 'M'}={p_tile}")
                    log(f"  {kname} {name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} {p} "
                        f"({p_tile}): max|kernel-plain| = "
                        f"{err:.3e} (limit {LSTM_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{kname} ({p}) disagrees with plain at {name}: "
                                             f"{err}")
                if path != "fma":  # a race shows only in some launches: repeat, check each
                    worst = max(max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(kernel(), ref)) for _ in range(REPEATS))
                    log(f"    {REPEATS} more {path} launches: worst max|kernel-plain| = "
                        f"{worst:.3e}")
                    check(worst <= LSTM_TOL[dtype], f"{kname} ({path}) disagreed with plain "
                                                    f"in a repeated launch at {name}: {worst}")
                if name in ("intra", "inter", "stream"):
                    timing = dict(max_abs_err=errs[path])
                    if path != "fma":
                        first = median_ms(kernel, warmup=2, iters=10)
                        timing["fma_ms"] = median_ms(fma, warmup=2, iters=10)
                        again = median_ms(kernel, warmup=2, iters=10)
                        timing.update(ms=(first + again) / 2, fma_max_abs_err=errs["fma"])
                        times = (f"{path} {first:.4f} / {again:.4f} ms around FMA "
                                 f"{timing['fma_ms']:.4f} ms")
                    else:
                        timing["ms"] = median_ms(kernel, warmup=2, iters=10)
                        times = f"kernel {timing['ms']:.4f} ms"
                    timing["plain_ms"] = median_ms(plain, warmup=1, iters=3)
                    log(f"    {times}, plain {timing['plain_ms']:.4f} ms (medians of 10 and 3, "
                        f"CUDA events)")
                    result[(kname, name, dtype)] = timing
    return result


def phase_lstm():
    return phase_scan(
        "== phase 3b: lstm_scan_bidir and lstm_scan vs plain on the card", ls, lstm_inputs,
        lambda xw_f, xw_b, w_f, w_b: {
            "lstm_scan_bidir": (
                lambda: ls.lstm_scan_bidir(xw_f, xw_b, w_f, w_b),
                lambda: ls.lstm_scan_bidir_reference(xw_f, xw_b, w_f, w_b),
                lambda: tuple(ls._forward_cuda([(xw_f, w_f), (xw_b, w_b)], False, "fma")[0])),
            "lstm_scan": (lambda: (ls.lstm_scan(xw_f, w_f),),
                          lambda: (ls.lstm_scan_reference(xw_f, w_f),),
                          lambda: tuple(ls._forward_cuda([(xw_f, w_f)], False, "fma")[0])),
        })


def phase_gru():
    return phase_scan(
        "== phase 3c: gru_scan_bidir and gru_scan vs plain on the card", gs, gru_inputs,
        lambda xw_f, xw_b, w_f, w_b, b_f, b_b: {
            "gru_scan_bidir": (
                lambda: gs.gru_scan_bidir(xw_f, xw_b, w_f, w_b, b_f, b_b),
                lambda: gs.gru_scan_bidir_reference(xw_f, xw_b, w_f, w_b, b_f, b_b),
                lambda: tuple(gs._forward_cuda([(xw_f, w_f, b_f), (xw_b, w_b, b_b)], "fma"))),
            "gru_scan": (lambda: (gs.gru_scan(xw_f, w_f, b_f),),
                         lambda: (gs.gru_scan_reference(xw_f, w_f, b_f),),
                         lambda: tuple(gs._forward_cuda([(xw_f, w_f, b_f)], "fma"))),
        })


# Backward kernels at the recipe-config training shapes, B = 2 x 4 s: the
# latent has T' = 31999 frames, padded to 32000 = 255 chunks of K = 250.
BWD_SHAPES = [
    ("intra", 510, 250, 128),  # B*S sequences of K steps
    ("inter", 500, 255, 128),  # B*K sequences of S steps
    ("odd", 37, 19, 40),
    ("T=1", 3, 1, 128),
    ("H=256", 64, 33, 256),
]
BWD_TOL = 1e-4  # f32, relative to max|plain|: the recurrent sums run in another order


def bwd_limit(dtype, scale):
    """f32: BWD_TOL x max|plain|; bf16: 2 bf16 ulps of max|plain| (both round the same f32
    derivatives, which differ only in the order of the recurrent sums)."""
    if dtype == torch.float32:
        return BWD_TOL * scale
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0


def plan_bwd(module, B, n_chains, H, dtype, path=None):
    """module._plan_bwd as the wrapper calls it on this card -> (path, tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = (module._tf32_bwd_clusters(H, "cuda") if ls._tensor_core_path(H, dtype, True)
                else None)
    return module._plan_bwd(B, n_chains, H, dtype, sms, path, clusters)


def backward_path(module, kname, call, want):
    """Run one backward call; it must have launched `kname` once, on path `want`."""
    return on_path(module.BWD_PATH_LAUNCHES[kname], kname, call, want)


def grad_errors(kname, got, ref, dtype):
    """[(max|kernel - plain|, limit)] of each gradient."""
    errs = []
    for a, b in zip(got, ref):
        check(a.shape == b.shape and a.dtype == b.dtype == dtype, (kname, a.shape, a.dtype))
        errs.append((float((a.float() - b.float()).abs().max()),
                     bwd_limit(dtype, float(b.float().abs().max()))))
    return errs


def check_backward(module, kname, label, grads_of, plain_chains, ref, plain, timed):
    """One backward under autograd (`grads_of()`, its gradients in `ref`'s order) on the
    path _plan_bwd gives it, against the plain version's `ref`. Where the tensor cores run,
    REPEATS more launches are checked and the FMA kernel is forced and checked too. If
    `timed`, the whole backward (gate recompute, kernel, parameter gradients) and the kernel
    alone are timed, the FMA kernel and the tensor-core one in turns (FMA, new, new, FMA),
    and `plain()` -> a timing dict."""
    xw, w_hh = plain_chains[0][:2]
    B, T, _ = xw.shape
    H, dtype = w_hh.shape[0], xw.dtype
    path, tile = plan_bwd(module, B, len(plain_chains), H, dtype)

    def flat(outs):
        return [d for chain in outs for d in chain]

    calls = {path: grads_of}
    if path != "fma":
        calls["fma"] = lambda: flat(module._backward_cuda(plain_chains, "fma"))
    errs = {}
    for p, call in calls.items():
        e = grad_errors(kname, backward_path(module, kname, call, p), ref, dtype)
        _, p_tile = plan_bwd(module, B, len(plain_chains), H, dtype, p)
        p_tile = f"M={p_tile[0]}, C={p_tile[1]}" if isinstance(p_tile, tuple) else f"R={p_tile}"
        ok = all(x <= lim for x, lim in e)
        log(f"  {kname} {label} {p} ({p_tile}): max|kernel-plain| / limit of each gradient: "
            + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in e) + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"{kname} ({p}) disagrees with plain at {label}")
        errs[p] = max(x for x, _ in e)
    if path != "fma":  # a race shows only in some launches: repeat, check each
        worst = 0.0
        for _ in range(REPEATS):
            e = grad_errors(kname, flat(module._backward_cuda(plain_chains)), ref, dtype)
            check(all(x <= lim for x, lim in e),
                  f"{kname} ({path}) disagreed with plain in a repeated launch at {label}: {e}")
            worst = max(worst, max(x / lim if lim else 0.0 for x, lim in e))
        log(f"    {REPEATS} more {path} launches: worst max|kernel-plain| {worst:.3f} of its limit")
    if not timed:
        return None
    check(path != "fma", f"{kname} at {label} is timed against the FMA kernel, but runs on it")
    # The staged arrays stay alive with each launch call.
    calls = {"whole": {p: (lambda p=p: module._backward_cuda(plain_chains, p))
                       for p in (path, "fma")},
             "alone": {p: module._staged_backward(plain_chains, p)[1] for p in (path, "fma")}}
    ms = {}
    for what, by_path in calls.items():
        fma_1, new_1, new_2, fma_2 = (median_ms(by_path[p], warmup=2, iters=10)
                                      for p in ("fma", path, path, "fma"))
        ms[what] = ((new_1 + new_2) / 2, (fma_1 + fma_2) / 2)
        log(f"    {'whole backward' if what == 'whole' else 'kernel alone'}: {path} "
            f"{new_1:.4f} / {new_2:.4f} ms between FMA {fma_1:.4f} / {fma_2:.4f} ms")
    plain_ms = median_ms(plain, warmup=1, iters=3)
    log(f"    plain {plain_ms:.4f} ms (medians of 10, 10 and 3, CUDA events)")
    return dict(max_abs_err=errs[path], fma_max_abs_err=errs["fma"], ms=ms["whole"][0],
                fma_ms=ms["whole"][1], kernel_ms=ms["alone"][0], fma_kernel_ms=ms["alone"][1],
                plain_ms=plain_ms)


def phase_lstm_bwd():
    """The training forward (with cs) and the backward kernels against the plain versions."""
    log("== phase 3d: lstm_scan_bidir and lstm_scan backward vs plain on the card")
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the tensor-core backward the card holds at once, by blocks a cluster "
        f"(H={H}): {ls._tf32_bwd_clusters(H, 'cuda')}")
    result = {}
    for name, B, T, H in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xw_f, xw_b, w_f, w_b = lstm_inputs(B, T, H, dtype, seed=B + T + H + 1)
            gen = torch.Generator(device="cuda").manual_seed(B + T)
            g_f, g_b = (torch.randn(B, T, H, device="cuda", generator=gen).to(dtype)
                        for _ in range(2))
            path, _ = plan(ls, B, 2, H, dtype)
            (hs_f, hs_b), (cs_f, cs_b) = forward_path(
                ls, "lstm_scan_bidir",
                lambda: ls._forward_cuda([(xw_f, w_f), (xw_b, w_b)], True), path)
            cs_err, cs_scale = 0.0, 1.0
            for xw, w, hs, cs in ((xw_f, w_f, hs_f, cs_f), (xw_b, w_b, hs_b, cs_b)):
                hs_ref, cs_ref = ls.lstm_forward_reference(xw, w)
                cs_scale = max(cs_scale, float(cs_ref.float().abs().max()))
                cs_err = max(cs_err, float((cs.float() - cs_ref.float()).abs().max()),
                             float((hs.float() - hs_ref.float()).abs().max()))
            cs_ok = cs_err <= LSTM_TOL[dtype] * cs_scale
            log(f"  forward with cs {name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} {path}: "
                f"max|kernel-plain| of hs, cs = {cs_err:.3e} (limit {LSTM_TOL[dtype]:g} x "
                f"{cs_scale:.3f}) {'ok' if cs_ok else 'FAIL'}")
            if not cs_ok:
                raise AssertionError(f"forward cs disagrees with plain at {name}: {cs_err}")
            for kname, chains, grads in (
                    ("lstm_scan_bidir_bwd", [(xw_f, w_f, hs_f, cs_f), (xw_b, w_b, hs_b, cs_b)],
                     (g_f, g_b)),
                    ("lstm_scan_bwd", [(xw_f, w_f, hs_f, cs_f)], (g_f,))):
                leaves = [t.clone().requires_grad_() for c in chains for t in c[:2]]
                fn = ls.lstm_scan_bidir if len(chains) == 2 else ls.lstm_scan

                def grads_of(fn=fn, leaves=leaves, grads=grads):
                    outs = fn(*leaves[0::2], *leaves[1::2])
                    return torch.autograd.grad(outs if len(grads) == 2 else (outs,), leaves,
                                               grads)

                plain_chains = [(*c, g) for c, g in zip(chains, grads)]
                ref = [d for c in plain_chains for d in ls.lstm_scan_bwd_reference(*c)]
                timing = check_backward(
                    ls, kname, f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]}", grads_of,
                    plain_chains, ref,
                    lambda: [ls.lstm_scan_bwd_reference(*c) for c in plain_chains],
                    timed=name in ("intra", "inter"))
                if timing is not None:
                    result[(kname, name, dtype)] = timing
    # fused_mask_decode has no backward (as in JAX): it refuses autograd on the
    # card rather than drop it.
    try:
        md.fused_mask_decode(*kernel_inputs(1, 2, 37, 512, 16, torch.float32, True, 0)[:2],
                             torch.zeros(512, 16, device="cuda", requires_grad=True))
    except NotImplementedError as err:
        log(f"  fused_mask_decode under autograd on CUDA raises: {str(err)[:80]}...")
    else:
        raise AssertionError("fused_mask_decode returned a result under autograd on CUDA")
    return result


def phase_gru_bwd():
    """The backward kernels of the GRU recurrences against gru_scan_bwd_reference."""
    log("== phase 3e: gru_scan_bidir and gru_scan backward vs plain on the card")
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the tensor-core backward the card holds at once, by blocks a cluster "
        f"(H={H}): {gs._tf32_bwd_clusters(H, 'cuda')}")
    result = {}
    for name, B, T, H in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xw_f, xw_b, w_f, w_b, b_f, b_b = gru_inputs(B, T, H, dtype, seed=B + T + H + 2)
            gen = torch.Generator(device="cuda").manual_seed(B + T + 1)
            g_f, g_b = (torch.randn(B, T, H, device="cuda", generator=gen).to(dtype)
                        for _ in range(2))
            hs_f, hs_b = gs._forward_cuda([(xw_f, w_f, b_f), (xw_b, w_b, b_b)])
            for kname, chains, hs, grads in (
                    ("gru_scan_bidir_bwd", [(xw_f, w_f, b_f), (xw_b, w_b, b_b)], (hs_f, hs_b),
                     (g_f, g_b)),
                    ("gru_scan_bwd", [(xw_f, w_f, b_f)], (hs_f,), (g_f,))):
                leaves = [t.clone().requires_grad_() for c in chains for t in c]

                def grads_of(leaves=leaves, grads=grads):
                    if len(grads) == 2:
                        outs = gs.gru_scan_bidir(*leaves[0::3], *leaves[1::3], *leaves[2::3])
                    else:
                        outs = (gs.gru_scan(*leaves),)
                    return torch.autograd.grad(outs, leaves, grads)

                plain_chains = [(*c, h, g) for c, h, g in zip(chains, hs, grads)]
                ref = [d for c in plain_chains for d in gs.gru_scan_bwd_reference(*c)]
                timing = check_backward(
                    gs, kname, f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]}", grads_of,
                    plain_chains, ref,
                    lambda: [gs.gru_scan_bwd_reference(*c) for c in plain_chains],
                    timed=name in ("intra", "inter"))
                if timing is not None:
                    result[(kname, name, dtype)] = timing
    return result


QUANT_BIG = (4096, 4096)
STOCH_SHAPE, STOCH_SEEDS = (1024, 1024), 64
# Stochastic rounding over 64 seeds: the mean of q - x / scale over every draw
# is 0 within 1e-3 (16 standard deviations of a mean of 67M draws, each
# within +-1), and each value's mean over the seeds within 0.45 of x / scale
# (7.2 standard deviations of a mean of 64 draws, over 1M values).
STOCH_MEAN_TOL, STOCH_VALUE_TOL = 1e-3, 0.45


def phase_quantize():
    """quantize_int8 against its plain version, bit for bit, and stochastic rounding."""
    log("== phase 3f: quantize_int8 vs plain on the card")
    model = ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0), device="cuda")
    tensors = [t.reshape(t.shape[0], -1).contiguous() for t in model.state_dict().values()
               if q8.quantizable(t)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    big = torch.randn(*QUANT_BIG, device="cuda", generator=gen)
    err = 0.0
    for x in tensors + [big]:
        values, scale = q8.quantize_int8(x)
        ref_values, ref_scale = q8.quantize_int8_reference(x)
        torch.cuda.synchronize()
        check(values.dtype == torch.int8 and values.shape == x.shape and scale.shape == (1, 1),
              (values.dtype, values.shape, scale.shape))
        err = max(err, float((values.int() - ref_values.int()).abs().max()),
                  float((scale - ref_scale).abs().max()))
        if not (torch.equal(values, ref_values) and torch.equal(scale, ref_scale)):
            raise AssertionError(f"quantize_int8 differs from plain at {tuple(x.shape)}")
    log(f"  {len(tensors)} weight tensors of paper-config Conv-TasNet and one "
        f"{QUANT_BIG}: int8 values and scales equal to the plain version bit for bit")
    ms = median_ms(lambda: q8.quantize_int8(big), warmup=3, iters=20)
    plain_ms = median_ms(lambda: q8.quantize_int8_reference(big), warmup=3, iters=20)
    log(f"  {QUANT_BIG}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA "
        f"events)")

    x = torch.randn(*STOCH_SHAPE, device="cuda", generator=gen)
    _, scale = q8.quantize_int8(x)
    s = x / scale
    low, high = torch.floor(s), torch.ceil(s)
    total = torch.zeros_like(s, dtype=torch.float64)
    previous = None
    for seed in range(STOCH_SEEDS):
        values, st_scale = q8.quantize_int8(x, seed=seed, stochastic=True)
        q = values.float()
        check(torch.equal(st_scale, scale), "the stochastic scale differs")
        check(bool(((q == low) | (q == high)).all()), f"seed {seed}: a value is neither the "
                                                      "floor nor the ceiling")
        check(previous is None or not torch.equal(values, previous), "two seeds drew alike")
        previous = values
        total += (q - s).double()
    mean_all = float(total.mean()) / STOCH_SEEDS
    worst = float((total / STOCH_SEEDS).abs().max())
    log(f"  stochastic, {STOCH_SHAPE} over {STOCH_SEEDS} seeds: every value the floor or the "
        f"ceiling; mean(q - x/scale) {mean_all:.2e} (limit {STOCH_MEAN_TOL:g}), worst value's "
        f"mean {worst:.3f} (limit {STOCH_VALUE_TOL:g})")
    check(abs(mean_all) <= STOCH_MEAN_TOL and worst <= STOCH_VALUE_TOL,
          "stochastic rounding is biased")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# The recurrence kernels' timed shapes, (rows, B, T, chains, phase): serving
# (3b, 3c) and training (3d, 3e). DPRNN-TasNet's RNNs take N = 64 features.
LIBRARY_SHAPES = {
    "scan_bidir": (2040, 250, 2), "scan": (2000, 255, 1),
    "scan_bidir_bwd": (510, 250, 2), "scan_bwd": (500, 255, 1),
}
RNN_FEATURES = DPRNN["sep_bottleneck_channels"]


def phase_library():
    """cuDNN's nn.LSTM / nn.GRU at the recurrence kernels' timed shapes (informational):
    the forward and the backward, in f32 and bf16.

    One PyTorch call each: the module's forward, or torch.autograd.grad of
    its output for the backward rows. Both also do the input projection
    (x @ W_ih and its gradients), which the port's kernels take as given.
    """
    log("== phase 3g: library calls beside the recurrence kernels (cuDNN, informational)")
    result = {}
    H = DPRNN["sep_hidden_channels"]
    rows = [(row, shape, torch.float32) for row, shape in LIBRARY_SHAPES.items()]
    rows += [(row, shape, torch.bfloat16) for row, shape in LIBRARY_SHAPES.items()]
    for rnn, cls in (("lstm", torch.nn.LSTM), ("gru", torch.nn.GRU)):
        for row, (B, T, chains), dtype in rows:
            module = cls(RNN_FEATURES, H, batch_first=True, bidirectional=chains == 2,
                         device="cuda", dtype=dtype)
            gen = torch.Generator(device="cuda").manual_seed(B + T)
            x = torch.randn(B, T, RNN_FEATURES, device="cuda", generator=gen).to(dtype)
            if row.endswith("bwd"):
                x.requires_grad_()
                y = module(x)[0]
                g = torch.randn(y.shape, device="cuda", generator=gen)
                inputs = [x, *module.parameters()]
                ms = median_ms(lambda: torch.autograd.grad(y, inputs, g, retain_graph=True),
                               warmup=2, iters=10)
            else:
                with torch.no_grad():
                    ms = median_ms(lambda: module(x), warmup=2, iters=10)
            result[f"{rnn}_{row}" + ("_bf16" if dtype == torch.bfloat16 else "")] = ms
            log(f"  {cls.__name__} {'backward' if row.endswith('bwd') else 'forward'} "
                f"{str(dtype)[6:]} (B={B}, T={T}, F={RNN_FEATURES}, H={H}, {chains} chain(s)): "
                f"{ms:.4f} ms (median of 10, CUDA events)")
    return result


def counts() -> dict:
    return {"fused_mask_decode": md.LAUNCHES, **ls.LAUNCHES, **gs.LAUNCHES, **q8.LAUNCHES}


# The served decodes, (path, dtype, N, C·L) as md.WIDTH_LAUNCHES counts them:
# Conv-TasNet's decoder (f32 generic, bf16 mma) and DPRNN-TasNet's (f32 rows,
# bf16 mma).
SERVED_DECODES = (("generic", "float32", 512, 16), ("mma", "bfloat16", 512, 16),
                  ("rows", "float32", 64, 2), ("mma", "bfloat16", 64, 2))


def width_key(path, dtype, N, CL) -> str:
    return f"fused_mask_decode/{path}/{dtype}/N={N}/CL={CL}"


# The recurrence forwards, each counted by path too ("name/mma", "name/tf32x3", "name/fma"),
# and their backwards ("name/tf32x2", "name/tf32x3", "name/fma").
FORWARDS = ("lstm_scan", "lstm_scan_bidir", "gru_scan", "gru_scan_bidir")
BACKWARDS = tuple(f"{name}_bwd" for name in FORWARDS)
# The tensor-core path of each: (bf16, f32).
TENSOR_CORE_PATHS = {**{name: ("mma", "tf32x3") for name in FORWARDS},
                     **{name: ("tf32x2", "tf32x3") for name in BACKWARDS}}


def path_counts() -> dict:
    return {**{f"{name}/{path}": n for module in (ls, gs)
               for table in (module.PATH_LAUNCHES, module.BWD_PATH_LAUNCHES)
               for name, paths in table.items() for path, n in paths.items()},
            **{f"fused_mask_decode/{path}": n for path, n in md.PATH_LAUNCHES.items()},
            **{width_key(*width): md.WIDTH_LAUNCHES[width] for width in SERVED_DECODES}}


def all_counts() -> dict:
    """Every kernel's launches and the recurrence forwards' launches by path."""
    return {**counts(), **path_counts()}


def reset_counts() -> None:
    md.LAUNCHES = 0
    for path in md.PATH_LAUNCHES:
        md.PATH_LAUNCHES[path] = 0
    md.WIDTH_LAUNCHES.clear()
    for table in (ls.LAUNCHES, gs.LAUNCHES, q8.LAUNCHES):
        for name in table:
            table[name] = 0
    for module in (ls, gs):
        for table in (module.PATH_LAUNCHES, module.BWD_PATH_LAUNCHES):
            for paths in table.values():
                for path in paths:
                    paths[path] = 0


def grown(before: dict) -> dict:
    """all_counts() since `before`."""
    return {k: v - before[k] for k, v in all_counts().items()}


def kernels_of(launches: dict) -> dict:
    """The per-kernel counts of an all_counts() dict."""
    return {k: launches[k] for k in counts()}


def decode_path(tag: str, dtype) -> str:
    """The fused_mask_decode path of a served model's decode (ops/mask_decode.py:_plan):
    every bf16 decode on the tensor cores; in f32, Conv-TasNet's N=512, C·L=16 on the
    generic kernel and DPRNN-TasNet's N=64, C·L=2 on "rows"."""
    if dtype in ("bfloat16", torch.bfloat16):
        return "mma"
    return "generic" if "conv" in tag else "rows"


def check_paths(grew: dict, bf16: dict, what: str, decode: str | None = None) -> None:
    """A run's recurrence forwards and backwards by path: bf16[name] launches of each on
    its bf16 tensor-core path ("mma" forward, "tf32x2" backward), the rest of grew[name]
    (its f32 ones) on the 3xTF32 kernels ("tf32x3"), and none on the FMA kernels: every
    served and trained model has H = 128. With `decode`, every fused_mask_decode launch
    of the run on that path."""
    if decode is not None:
        n = grew["fused_mask_decode"]
        got = {p: grew[f"fused_mask_decode/{p}"] for p in md.PATH_LAUNCHES}
        check(got == {p: n * (p == decode) for p in got},
              f"{what}: fused_mask_decode launched {got} by path, expected {n} on {decode}")
    for name, (bf16_path, f32_path) in TENSOR_CORE_PATHS.items():
        want = (bf16.get(name, 0), grew[name] - bf16.get(name, 0), 0)
        got = (grew[f"{name}/{bf16_path}"], grew[f"{name}/{f32_path}"], grew[f"{name}/fma"])
        check(got == want, f"{what}: {name} launched ({bf16_path}, {f32_path}, fma) = {got}, "
                           f"expected {want}")


def all_bf16(grew: dict) -> dict:
    """check_paths' `bf16` for a run whose every recurrence forward and backward is bf16."""
    return {name: grew[name] for name in TENSOR_CORE_PATHS}


def nonzero(launches: dict) -> dict:
    """The kernels a count names, for the log."""
    return {k: v for k, v in launches.items() if v}


def expected(**per_request) -> dict:
    """Expected launches of one request: the kernels named, and none of the others."""
    return {name: per_request.get(name, 0) for name in counts()}


def stream_calls(n_samples, L, S, P):
    """Separator calls of one --streaming_hop request: (calls on whole latent hops,
    latent frames left for a final call).

    The CLI pads to the stride grid and feeds whole hops, each one call on the whole
    latent hops (P frames; P = 1 for Conv-TasNet) it completes, then finish(rest): one
    more call on its whole latent hops, if any.
    """
    hop = max(max(int(STREAMING_HOP * SAMPLE_RATE) // S, 1) * S, L)
    total = n_samples + (S - (n_samples - L) % S) % S
    calls = pending = 0
    for _ in range(total // hop):
        frames = (pending + hop - L) // S + 1
        calls, pending = calls + 1, pending + hop - frames // P * P * S
    buf = pending + total % hop
    frames = (buf - L) // S + 1 if buf >= L else 0
    return calls + (frames >= P), frames % P


def stream_launches(n_samples, bidir, blocks=DPRNN["sep_num_blocks"], L=DPRNN["kernel_size"],
                    S=DPRNN["stride"], P=DPRNN["sep_hop_size"]):
    """Launches of one --streaming_hop request of the stream-safe DPRNN-TasNet: each call
    that runs the dual-path stack launches one bidirectional kernel per block (the
    intra-chunk RNN; the carried inter-chunk RNN is a plain step loop), and every
    separator call decodes once. The final call, which empties the latent delay line,
    always decodes, and runs the stack on a partial hop only."""
    calls, left = stream_calls(n_samples, L, S, P)
    return expected(fused_mask_decode=calls + 1, **{bidir: blocks * (calls + (left > 0))})


def conv_stream_launches(n_samples, L=PAPER["kernel_size"], S=PAPER["stride"]):
    """Launches of one --streaming_hop request of causal Conv-TasNet: one decode per
    separator call, and no final call (no latent delay)."""
    return expected(fused_mask_decode=stream_calls(n_samples, L, S, 1)[0])


def scramble_norms(model):
    # Non-identity norm affines, so the norms (and the Conv-TasNet CLI's fold) do real work.
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.5 + rng.random(p.shape, np.float32)))
            elif name.endswith(".beta"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return model


def make_checkpoint(path, model):
    save_model(path, scramble_norms(model))


def write_mixtures(tmp):
    rng = np.random.default_rng(0)
    wavs = []
    for seconds in (1.0, 2.5, 4.0):
        path = os.path.join(tmp, f"mix_{seconds}s.wav")
        write_wav(path, 0.1 * rng.standard_normal(int(seconds * SAMPLE_RATE)), SAMPLE_RATE)
        wavs.append(path)
    return wavs


def separate(argv):
    """cli/separate.py's main, its progress line kept off the log."""
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


def serve(tag, ckpt, wavs, per_request, flags=()):
    """Six requests (three mixtures x f32/bf16) through cli/separate.py.

    Every launch count is set to 0 first; each request must add exactly
    `per_request` launches (a dict, or a function of the request's number of
    samples). Returns the outputs and the path's counts.
    """
    tmp = os.path.dirname(ckpt)
    outputs = {}
    reset_counts()
    for dtype in ("float32", "bfloat16"):
        for wav in wavs:
            before = all_counts()
            out_dir = os.path.join(tmp, f"out_{tag}_{dtype}_{os.path.basename(wav)[:-4]}")
            est = separate(["--model_path", ckpt, "--input", wav, "--out_dir", out_dir,
                            "--device", "cuda", "--dtype", dtype, *flags])
            grew_all = grown(before)
            grew = kernels_of(grew_all)
            n_in = read_wav(wav)[0].shape[0]
            want = per_request(n_in) if callable(per_request) else per_request
            files = sorted(os.listdir(out_dir))
            check(files == ["source0.wav", "source1.wav"], files)
            for f in files:
                sig, sr = read_wav(os.path.join(out_dir, f))
                check(sr == SAMPLE_RATE and sig.shape == (n_in,) and np.isfinite(sig).all(),
                      (f, sig.shape, n_in))
            check(est.shape == (2, n_in) and np.isfinite(est).all(), est.shape)
            check(grew == want, f"request {wav} ({dtype}) launched {grew}, expected {want}")
            check_paths(grew_all, all_bf16(grew_all) if dtype == "bfloat16" else {},
                        f"request {wav} ({dtype})", decode_path(tag, dtype))
            log(f"  {dtype} {os.path.basename(wav)}: 2 sources x {n_in} samples, "
                f"kernel launches {nonzero(grew_all)}")
            outputs[(dtype, wav)] = est
    launches = all_counts()
    log(f"  main-path kernel launches: {nonzero(launches)}")
    return outputs, launches


def phase_parity(tag, ckpt, wavs, outputs, flags=()):
    log(f"== phase 5: card vs CPU, bf16 vs f32 ({tag})")
    wav = wavs[0]
    ref = separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                    os.path.join(os.path.dirname(ckpt), f"out_{tag}_cpu"), "--device", "cpu",
                    *flags])
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


def cli_latency(ckpt, wav, what, card, flags=()):
    tmp = os.path.dirname(ckpt)
    lat = []
    for _ in range(3):
        start = time.perf_counter()
        separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                  os.path.join(tmp, "out_latency"), "--device", "cuda", "--dtype", "bfloat16",
                  *flags])
        lat.append(time.perf_counter() - start)
    log(f"  CLI request latency, 4 s mixture, bf16 ({what}): "
        f"median {np.median(lat) * 1e3:.1f} ms of {[round(v * 1e3, 1) for v in lat]} [{card}]")


def forward_throughput(model, what, card, warmup, iters, dtype=torch.bfloat16, tag=None):
    """The B=8 x 4 s forward of `model` (already in `dtype`); its recurrence forwards
    must take the dtype's tensor-core path, its decode decode_path(tag, dtype)."""
    B, T = 8, 4 * SAMPLE_RATE
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 1, T), dtype=np.float32))
    x = x.to("cuda", dtype)
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=warmup, iters=iters)
    grew = grown(before)
    check_paths(grew, all_bf16(grew) if dtype == torch.bfloat16 else {}, f"{what} forward",
                decode_path(tag or what, dtype))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  B=8 x 4 s {str(dtype)[6:]} {what} forward: {ms:.3f} ms, "
        f"{B * 4.0 / (ms / 1e3):.1f} audio-s/s, peak {peak:.1f} MiB [{card}]")


def phase_throughput(ckpt, wavs, card):
    log("== phase 6: throughput (informational), Conv-TasNet")
    model = load_model(ckpt, device="cuda")
    model = fold_for_serving(model)
    forward_throughput(model.to(torch.bfloat16), "heads-fold", card, warmup=3, iters=20,
                       tag="conv_tasnet")
    cli_latency(ckpt, wavs[-1], "load + fold + forward + write", card)


def phase_throughput_dprnn(tag, ckpt, wavs, card):
    log(f"== phase 6: throughput (informational), {tag}")
    model = load_model(ckpt, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
        forward_throughput(model.to(dtype), tag, card, warmup=2, iters=5, dtype=dtype)
    cli_latency(ckpt, wavs[-1], "load + forward + write", card)


def phase_stream_offline(tag, ckpt, wavs, outputs, phase="4d"):
    """The f32 streamed output against the offline (stream-safe) forward, both on the card."""
    log(f"== phase {phase}: streamed vs offline on the card ({tag})")
    for wav in wavs:
        ref = separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                        os.path.join(os.path.dirname(ckpt), f"out_{tag}_offline"),
                        "--device", "cuda"])
        got = outputs[("float32", wav)]
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        log(f"  {os.path.basename(wav)}: max|streamed - offline| {err:.3e}, max|offline| "
            f"{scale:.3e}, limit {STREAM_TOL * scale:.3e}")
        if not err <= STREAM_TOL * scale:
            raise AssertionError(f"streamed output disagrees with offline: {err} > "
                                 f"{STREAM_TOL} x {scale}")


def stream_hop_times(ckpt, wav, dtype, card):
    """ms per hop of one 4 s stream, each hop ended by a synchronize, as a server would."""
    model = load_model(ckpt, device="cuda").to(dtype)
    x = read_wav(wav)[0].astype(np.float32)
    hop = int(STREAMING_HOP * SAMPLE_RATE)
    stream = ExactStreamingSeparator(model, hop_samples=hop)
    for lo in range(0, 4 * hop, hop):  # warm-up: a short stream, then a fresh one
        stream.process(x[lo:lo + hop])
    stream.reset()
    times = []
    for lo in range(0, len(x) // hop * hop, hop):
        start = time.perf_counter()
        stream.process(x[lo:lo + hop]).cpu()
        times.append((time.perf_counter() - start) * 1e3)
    ms, p90 = float(np.median(times)), float(np.percentile(times, 90))
    log(f"  {str(dtype)[6:]}: {len(times)} hops of {STREAMING_HOP * 1e3:g} ms audio: median "
        f"{ms:.3f} ms, p90 {p90:.3f} ms, max {max(times):.3f} ms per hop, real-time factor "
        f"{ms / (STREAMING_HOP * 1e3):.4f} [{card}]")


def phase_stream_hops():
    """Phase 6's ms per hop of the stream-safe causal DPRNN-TasNet alone, LSTM and GRU
    (`--only 6s`: the streaming metric of two trees compared in one call)."""
    log("== phase 6s: streaming ms per hop (informational)")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        wav = write_mixtures(tmp)[-1]
        for rnn in ("lstm", "gru"):
            ckpt = os.path.join(tmp, f"{rnn}.pth")
            make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=True,
                                              stream_safe=True, device="cuda",
                                              generator=torch.Generator().manual_seed(0)))
            log(f"  {rnn}:")
            for dtype in (torch.bfloat16, torch.float32):
                stream_hop_times(ckpt, wav, dtype, card)


def write_long_mixture(tmp):
    path = os.path.join(tmp, f"mix_{LONGFORM_SECONDS:g}s.wav")
    rng = np.random.default_rng(30)
    write_wav(path, 0.1 * rng.standard_normal(int(LONGFORM_SECONDS * SAMPLE_RATE)), SAMPLE_RATE)
    return path


def phase_longform(conv_ckpt, wav):
    """A 30 s mixture through --chunk_duration 4: one decode per bucketed chunk."""
    log(f"== phase 4g: long-form paper-config Conv-TasNet, {LONGFORM_SECONDS:g} s through "
        f"cli/separate.py --chunk_duration {CHUNK_DURATION:g}")
    n, chunk = int(LONGFORM_SECONDS * SAMPLE_RATE), int(CHUNK_DURATION * SAMPLE_RATE)
    real, bucketed = chunk_count(n, chunk, bucket=False), chunk_count(n, chunk)
    check((real, bucketed) == (14, 16), f"{n} samples in {chunk}-sample chunks: {real}, "
                                        f"bucketed {bucketed}; expected 14 and 16")
    log(f"  {real} real chunks of {chunk} samples at a hop of {chunk // 2}, bucketed to "
        f"{bucketed}")
    return serve("conv_tasnet_longform", conv_ckpt, [wav],
                 lambda n: expected(fused_mask_decode=chunk_count(n, chunk)),
                 flags=["--chunk_duration", str(CHUNK_DURATION)])


def phase_throughput_longform(ckpt, wav, card):
    """Long-form wall time per audio-second: the folded model (as the CLI serves it) over
    the 30 s mixture, ended by a host copy; median of 3 after one warm-up."""
    log("== phase 6: long-form (informational), paper-config Conv-TasNet")
    x = torch.from_numpy(read_wav(wav)[0].astype(np.float32))[None, None]
    chunk = int(CHUNK_DURATION * SAMPLE_RATE)
    model = load_model(ckpt, device="cuda")
    model = fold_for_serving(model)
    for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
        model = model.to(dtype)
        mixture = x.to("cuda", dtype)
        times = []
        with torch.inference_mode():
            for _ in range(4):
                start = time.perf_counter()
                separate_longform(model, mixture, chunk, 2).cpu()
                times.append(time.perf_counter() - start)
        ms = float(np.median(times[1:])) * 1e3
        log(f"  {str(dtype)[6:]}: {LONGFORM_SECONDS:g} s in {chunk_count(x.shape[-1], chunk)} "
            f"chunks: {ms:.3f} ms, {ms / LONGFORM_SECONDS:.3f} ms per audio-second "
            f"(median of 3) [{card}]")


def phase_bench():
    """`python -m dnn_based_source_separation_torch.bench`, by default and streaming."""
    log("== phase 6: the bench module (informational)")
    for flags in ([], ["--streaming_hop", str(STREAMING_HOP), "--causal"]):
        proc = subprocess.run([sys.executable, "-m", "dnn_based_source_separation_torch.bench",
                               *flags], capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, f"bench {flags} failed: {proc.stdout[-2000:]}"
                                    f"{proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check(line["value"] > 0, line)
        log(f"  bench {' '.join(flags) or '(default)'}: {json.dumps(line)}")


def phase_throughput_stream(tag, ckpt, wavs, card):
    log(f"== phase 6: streaming (informational), {tag}")
    for dtype in (torch.bfloat16, torch.float32):
        stream_hop_times(ckpt, wavs[-1], dtype, card)
    cli_latency(ckpt, wavs[-1], "load + stream + write", card,
                flags=["--streaming_hop", str(STREAMING_HOP)])


# Training: the models the train CLI builds, at the recipe's widths.
TRAIN_MODELS = {
    "dprnn_tasnet": (DPRNNTasNet, dict(DPRNN, causal=False)),
    "dprnn_tasnet_causal": (DPRNNTasNet, dict(DPRNN, causal=True)),
    "dprnn_tasnet_gru": (DPRNNTasNet, dict(DPRNN, causal=False, rnn_type="gru")),
    "dprnn_tasnet_gru_causal": (DPRNNTasNet, dict(DPRNN, causal=True, rnn_type="gru")),
    "conv_tasnet": (ConvTasNet, PAPER),
}
GRAD_TOL_L2 = 1e-3  # card vs the f64 CPU step: relative L2 of the whole gradient
GRAD_TOL_TENSOR = 5e-2  # card vs the f64 CPU step, each tensor, relative to its max|g|
LOSS_TOL = 1e-4  # card vs the f64 CPU step, relative
# The recipes' flags (egs/wsj0-mix/dprnn-tasnet/train.sh:22; the Conv-TasNet
# defaults of cli/train_wsj0mix.py are the paper config).
CLI_RECIPES = {
    "dprnn_tasnet": ["--model", "dprnn-tasnet", "-N", "64", "-L", "2", "-K", "250",
                     "--sep_hop_size", "125", "--sep_num_blocks", "6",
                     "--sep_bottleneck_channels", "64", "--sep_hidden_channels", "128",
                     "--batch_size", "2"],
    "conv_tasnet": ["--model", "conv-tasnet", "--batch_size", "4"],
}


def train_step_launches(tag: str) -> dict:
    """Launches of one train step: each recurrence forward and backward once per layer,
    and no decode kernel (training decodes with the plain version)."""
    blocks = DPRNN["sep_num_blocks"]
    if tag.startswith("conv"):
        return expected()
    rnn = "gru" if "_gru" in tag else "lstm"
    if tag.endswith("causal"):
        return expected(**{f"{rnn}_scan_bidir": blocks, f"{rnn}_scan": blocks,
                           f"{rnn}_scan_bidir_bwd": blocks, f"{rnn}_scan_bwd": blocks})
    return expected(**{f"{rnn}_scan_bidir": 2 * blocks, f"{rnn}_scan_bidir_bwd": 2 * blocks})


def eval_launches(tag: str) -> dict:
    """Launches of one validation (or served, or evaluated) forward: the serving kernels."""
    blocks = DPRNN["sep_num_blocks"]
    if tag.startswith("conv"):
        return expected(fused_mask_decode=1)
    rnn = "gru" if "_gru" in tag else "lstm"
    causal = tag.endswith("causal")
    return expected(fused_mask_decode=1, **{f"{rnn}_scan_bidir": blocks * (2 - causal),
                                            f"{rnn}_scan": blocks * causal})


def train_batch(B, seconds, device, seed=7):
    """Two sources of noise and their sum, (B, 1, T) and (B, 2, T), from a seed."""
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal((B, 2, int(seconds * SAMPLE_RATE)), dtype=np.float32)
    mixture = sources.sum(axis=1, keepdims=True)
    return torch.from_numpy(mixture).to(device), torch.from_numpy(sources).to(device)


def grads_of_step(model, batch):
    """One make_train_step with SGD at lr 0 (the weights stay; the gradients stay in .grad)."""
    step = make_train_step(model, PIT1d(NegSISDR(), n_sources=2),
                           make_optimizer("sgd", 0.0, params=model.parameters()))
    loss = float(step(*batch))
    return loss, {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def phase_train_parity():
    """One train step on the card against the same step on the CPU.

    Both f32 steps are held against an f64 step on the CPU. The randomly
    initialised paper-config Conv-TasNet (24 blocks, each ending in a
    scale-invariant gLN) is ill-conditioned in its backward: a PReLU slope or
    a bottleneck gradient comes out of f32 up to about 1e-2 off the f64 one in
    either implementation (the CPU's worst tensor read 8.8e-03 of its max|g|,
    and per-layer output gradients reach 2e-2 on both devices, at different
    layers). So the whole gradient vector must be within GRAD_TOL_L2 (relative
    L2) of the f64 one, or no further than 10x the CPU's f32 gradient is, and
    each tensor within GRAD_TOL_TENSOR x its max|g|: a missing or wrong
    backward is off by O(1).
    """
    log("== phase 7: one train step, card vs CPU (f32, TF32 off, B=2 x 0.5 s; f64 CPU "
        "reference)")
    for tag, (cls, cfg) in TRAIN_MODELS.items():
        def make(device):
            return scramble_norms(cls(**cfg, generator=torch.Generator().manual_seed(0),
                                      device=device))
        cpu_model = make("cpu")
        batch = train_batch(2, 0.5, "cpu")
        ref_loss, ref_grads = grads_of_step(copy.deepcopy(cpu_model).double(),
                                            tuple(t.double() for t in batch))
        cpu_loss, cpu_grads = grads_of_step(cpu_model, batch)
        reset_counts()
        card_loss, card_grads = grads_of_step(make("cuda"), train_batch(2, 0.5, "cuda"))
        torch.cuda.synchronize()
        launched = counts()
        check(launched == train_step_launches(tag),
              f"{tag}: a train step launched {launched}, expected {train_step_launches(tag)}")
        check_paths(all_counts(), {}, f"{tag}: an f32 train step")
        zero = [n for n, g in card_grads.items() if g is None or not bool(g.abs().max() > 0)]
        if zero:
            raise AssertionError(f"{tag}: gradients all zero or missing on the card: {zero}")
        card_sq = cpu_sq = ref_sq = 0.0
        rows = []
        for n, ref in ref_grads.items():
            card_d = card_grads[n].cpu().double() - ref
            cpu_d = cpu_grads[n].double() - ref
            card_sq += float(card_d.square().sum())
            cpu_sq += float(cpu_d.square().sum())
            ref_sq += float(ref.square().sum())
            scale = float(ref.abs().max()) or 1.0
            rows.append((float(card_d.abs().max()) / scale, float(cpu_d.abs().max()) / scale, n))
        rows.sort(reverse=True)
        card_l2, cpu_l2 = (card_sq / ref_sq) ** 0.5, (cpu_sq / ref_sq) ** 0.5
        l2_limit = max(GRAD_TOL_L2, 10 * cpu_l2)
        loss_limit = max(LOSS_TOL * abs(ref_loss), 10 * abs(cpu_loss - ref_loss))
        log(f"  {tag}: loss card {card_loss:.6f}, CPU f32 {cpu_loss:.6f}, f64 {ref_loss:.6f} "
            f"(card err {abs(card_loss - ref_loss):.2e}, limit {loss_limit:.2e}); "
            f"{len(ref_grads)} gradients, none all zero on the card; whole-gradient relative "
            f"L2 vs f64: card {card_l2:.2e}, CPU f32 {cpu_l2:.2e} (limit {l2_limit:.2e}); "
            f"launches per step {nonzero(launched)}")
        for card_rel, cpu_rel, n in rows[:3]:
            log(f"    {n}: max|card-f64| / max|g| {card_rel:.2e}, CPU f32 {cpu_rel:.2e} "
                f"(limit {GRAD_TOL_TENSOR:g})")
        if not (abs(card_loss - ref_loss) <= loss_limit and card_l2 <= l2_limit
                and rows[0][0] <= GRAD_TOL_TENSOR):
            raise AssertionError(f"{tag}: card train step disagrees with CPU")


def train_through_cli(argv, launches=None):
    """train_wsj0mix.main in-process; with `launches`, check the run's kernel launches
    against its steps and validation forwards."""
    before = all_counts()
    trainer = train_cli.main(argv)
    grew_all = grown(before)
    grew = kernels_of(grew_all)
    losses = trainer.train_loss + trainer.valid_loss
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    if launches is not None:
        epochs = len(trainer.train_loss) - trainer.start_epoch
        steps, evals = epochs * len(trainer.train_loader), epochs * len(trainer.valid_loader)
        per_step, per_eval = train_step_launches(launches), eval_launches(launches)
        want = {k: steps * per_step[k] + evals * per_eval[k] for k in grew}
        check(grew == want, f"{argv[-1]}: launched {grew}, expected {want} for {steps} "
                            f"steps and {evals} validation forwards")
        # Mixed precision: the steps' forwards and backwards run on bf16 copies
        # ("mma", "tf32x2"), the validation forwards on the f32 weights ("tf32x3").
        mixed = "--mixed_precision" in argv
        check_paths(grew_all, {k: steps * per_step[k] for k in TENSOR_CORE_PATHS} if mixed
                    else {}, argv[-1], decode_path(launches, "float32"))
    model_dir = os.path.join(trainer.config.exp_dir, "model")
    check(sorted(os.listdir(model_dir)) == ["best.ckpt", "last.ckpt"], os.listdir(model_dir))
    stats = trainer.last_epoch_stats or {}
    log(f"  {argv[argv.index('--model') + 1]}{' gru' if 'gru' in argv else ''} "
        f"{'bf16' if '--mixed_precision' in argv else 'f32'}"
        f"{' causal' if '--causal' in argv else ''}: epochs {trainer.start_epoch + 1}-"
        f"{len(trainer.train_loss)}, train loss {[round(v, 4) for v in trainer.train_loss]}, "
        f"valid loss {[round(v, 4) for v in trainer.valid_loss]}, "
        f"{stats.get('audio_sec_per_sec', 0):.1f} audio-s/s, "
        f"p50 {stats.get('iter_p50_ms', 0):.1f} ms, launches {nonzero(grew_all)}")
    return trainer


def phase_train_cli(tmp, card):
    """Train through the CLI on a synthetic wsj0-style corpus; resume; serve the result."""
    log("== phase 8: train through cli/train_wsj0mix.py")
    corpus = os.path.join(tmp, "corpus")
    tr_root, tr_list = write_quality_corpus(corpus, "tr", 6)  # 8 windows of 4 s
    cv_root, cv_list = write_quality_corpus(corpus, "cv", 2)
    data = ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
            cv_root, "--valid_list_path", cv_list, "--duration", "4", "--valid_duration", "4",
            "--device", "cuda"]
    exp = os.path.join(tmp, "exp_dprnn")
    # The entry point itself, as a user runs it, in a process of its own.
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "dnn_based_source_separation_torch.cli.train_wsj0mix", *data,
         *CLI_RECIPES["dprnn_tasnet"], "--epochs", "2", "--exp_dir", exp],
        cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
        timeout=600)
    log("  python -m ...cli.train_wsj0mix (DPRNN-TasNet, 2 epochs):\n    "
        + "\n    ".join(proc.stdout.strip().splitlines()[-6:]))
    if proc.returncode != 0:
        raise AssertionError(f"the train CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    last = os.path.join(exp, "model", "last.ckpt")
    check(os.path.exists(os.path.join(exp, "model", "best.ckpt")) and os.path.exists(last),
          os.listdir(os.path.join(exp, "model")))

    reset_counts()  # the training path, in-process from here on
    resumed = train_through_cli([*data, *CLI_RECIPES["dprnn_tasnet"], "--epochs", "3",
                                 "--continue_from", last, "--exp_dir", exp], "dprnn_tasnet")
    check(resumed.start_epoch == 2 and len(resumed.train_loss) == 3,
          (resumed.start_epoch, resumed.train_loss))
    trainers = {"dprnn_tasnet": resumed}
    gru = ["--rnn_type", "gru"]
    for tag, flags in (("dprnn_tasnet_causal", ["--causal", "1"]),
                       ("dprnn_tasnet", ["--mixed_precision", "1"]),
                       ("dprnn_tasnet_causal", ["--causal", "1", "--mixed_precision", "1"]),
                       ("dprnn_tasnet_gru", gru),
                       ("dprnn_tasnet_gru", [*gru, "--mixed_precision", "1"]),
                       ("dprnn_tasnet_gru_causal", [*gru, "--causal", "1"]),
                       ("dprnn_tasnet_gru_causal", [*gru, "--causal", "1",
                                                    "--mixed_precision", "1"]),
                       ("conv_tasnet", [])):
        recipe = CLI_RECIPES["conv_tasnet" if tag.startswith("conv") else "dprnn_tasnet"]
        out = os.path.join(tmp, f"exp_{tag}_{'_'.join(flags).replace('-', '')}")
        trainer = train_through_cli([*data, *recipe, *flags, "--epochs", "1", "--exp_dir", out],
                                    tag)
        trainers.setdefault(tag, trainer)  # the f32 one of each model for the checks below

    # Per step and per validation forward, then a fixed batch trained for 20 steps.
    for tag, trainer in trainers.items():
        batch = train_batch(2 if tag.startswith("dprnn") else 4, 4.0, "cuda", seed=11)
        before = all_counts()
        losses = [float(trainer.train_step(*batch))]
        step_all = grown(before)
        before = all_counts()
        trainer.eval_step(*batch)
        eval_all = grown(before)
        step_launches, eval_grew = kernels_of(step_all), kernels_of(eval_all)
        check(step_launches == train_step_launches(tag) and eval_grew == eval_launches(tag),
              f"{tag}: step launched {step_launches}, eval {eval_grew}")
        check_paths(step_all, {}, f"{tag}: an f32 train step")
        check_paths(eval_all, {}, f"{tag}: an f32 validation forward",
                    decode_path(tag, "float32"))
        losses += [float(trainer.train_step(*batch)) for _ in range(19)]
        log(f"  {tag}: one train step launched {nonzero(step_launches)}; one validation "
            f"forward {nonzero(eval_grew)}; a fixed batch over 20 steps: loss {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{tag}: 20 steps on one batch did not lower its loss: {losses}")
    launches = all_counts()
    log(f"  training-path kernel launches: {nonzero(launches)}")

    wavs = write_mixtures(tmp)
    for tag, trainer in (("dprnn_tasnet", resumed), ("conv_tasnet", trainers["conv_tasnet"])):
        ckpt = os.path.join(trainer.config.exp_dir, "model", "last.ckpt")
        log(f"  serve the trained {tag} checkpoint through cli/separate.py")
        _, served = serve(f"trained_{tag}", ckpt, wavs[:1], eval_launches(tag))
        launches = {k: v + served[k] for k, v in launches.items()}
    checkpoints = {tag: os.path.join(trainers[tag].config.exp_dir, "model", "last.ckpt")
                   for tag in ("conv_tasnet", "dprnn_tasnet", "dprnn_tasnet_gru")}
    return launches, checkpoints


def timed_train_steps(cls, cfg, B, compute_dtype, card, what, warmup=3, iters=10):
    model = scramble_norms(cls(**cfg, generator=torch.Generator().manual_seed(0), device="cuda"))
    step = make_train_step(model, PIT1d(NegSISDR(), n_sources=2),
                           make_optimizer("adam", 1e-3, 5.0, params=model.parameters()),
                           compute_dtype)
    batch = train_batch(B, 4.0, "cuda")
    times = []
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    for i in range(warmup + iters):
        start = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - start)
    grew = grown(before)
    check_paths(grew, all_bf16(grew) if compute_dtype == torch.bfloat16 else {}, what)
    p50 = float(np.median(times))
    log(f"  {what}, B={B} x 4 s: p50 step {p50 * 1e3:.3f} ms of {iters} (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), {B * 4.0 / p50:.1f} audio-s/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB [{card}]")
    return model


BACKWARD_KERNELS = ("lstm_bwd_kernel", "gru_bwd_kernel", "bwd_tf32_kernel")


def profile_train_step(model, compute_dtype, card, what):
    """One step split by CUDA events into forward, backward and optimizer, with the device
    time of the backward kernels and the device's idle share from torch.profiler; then the
    backward alone profiled, its launches by path (each on the tensor cores) and the ten
    longest device ops of the rest of it by name."""
    from torch.autograd import DeviceType
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile

    criterion = PIT1d(NegSISDR(), n_sources=2)
    optimizer = make_optimizer("adam", 1e-3, 5.0, params=model.parameters())
    mixture, sources = train_batch(2, 4.0, "cuda")

    def loss_of():
        if compute_dtype is None:
            estimates = model(mixture)
        else:
            cast = {k: v.to(compute_dtype) if v.dtype == torch.float32 else v
                    for k, v in model.named_parameters()}
            estimates = functional_call(model, cast, (mixture.to(compute_dtype),)).float()
        return criterion(estimates, sources)[0]

    def step(events):
        events[0].record()
        optimizer.zero_grad()
        loss = loss_of()
        events[1].record()
        loss.backward()
        events[2].record()
        optimizer.step()
        events[3].record()

    def device_times(prof):  # device time by kernel name, ms
        times = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        check(times, "the profiler recorded no device time")
        return times

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step(events)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    fwd, bwd, opt = (events[i].elapsed_time(events[i + 1]) for i in range(3))
    device = device_times(prof)
    busy = sum(device.values())
    bwd_kernel = sum(t for k, t in device.items() if any(n in k for n in BACKWARD_KERNELS))
    fwd_kernel = sum(t for k, t in device.items() if "lstm_kernel" in k or "gru_kernel" in k
                     or "scan_mma_kernel" in k or "scan_tf32_kernel" in k)
    log(f"  profile of one {what} step (B=2 x 4 s): wall {wall:.3f} ms; forward "
        f"{fwd:.3f} ms (recurrence kernels {fwd_kernel:.3f} ms device), backward {bwd:.3f} ms "
        f"(backward kernels {bwd_kernel:.3f} ms device, other backward {bwd - bwd_kernel:.3f} "
        f"ms), optimizer {opt:.3f} ms; device busy {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.1%} [{card}]")
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    log("    top device time: " + ", ".join(f"{k[:48]} {t:.3f} ms" for k, t in top))

    # The backward alone: what the rest of it is made of.
    optimizer.zero_grad()
    loss = loss_of()
    torch.cuda.synchronize()
    before = all_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    grew = grown(before)
    by_path = {k: n for k, n in grew.items() if "_bwd/" in k and n}
    check_paths(grew, all_bf16(grew) if compute_dtype == torch.bfloat16 else {},
                f"{what}: the profiled backward")
    device = device_times(prof)
    rest = {k: t for k, t in device.items() if not any(n in k for n in BACKWARD_KERNELS)}
    log(f"    backward alone: device {sum(device.values()):.3f} ms, backward kernels "
        f"{sum(device.values()) - sum(rest.values()):.3f} ms, launches by path {by_path}; "
        f"the rest {sum(rest.values()):.3f} ms, its ten longest ops by name:")
    for k, t in sorted(rest.items(), key=lambda kv: -kv[1])[:10]:
        log(f"      {t:9.3f} ms  {k[:110]}")


def phase_train_throughput(card):
    log("== phase 9: training throughput (informational)")
    for rnn in ("lstm", "gru"):
        dprnn = TRAIN_MODELS["dprnn_tasnet" + ("_gru" if rnn == "gru" else "")]
        for dtype in (None, torch.bfloat16):
            what = f"DPRNN-TasNet {rnn.upper()} non-causal {'bf16' if dtype else 'f32'}"
            model = timed_train_steps(*dprnn, 2, dtype, card, what)
            profile_train_step(model, dtype, card, what)
    for dtype in (None, torch.bfloat16):
        timed_train_steps(*TRAIN_MODELS["conv_tasnet"], 4, dtype, card,
                          f"Conv-TasNet {'bf16' if dtype else 'f32'}", iters=5)


def phase_quantized_serve(conv_ckpt, wavs, conv_out):
    """Quantize paper-config Conv-TasNet's weights on the card, dequantize, serve."""
    log("== phase 4e: int8-quantized paper-config Conv-TasNet through cli/separate.py")
    reset_counts()
    model = load_model(conv_ckpt, device="cuda")
    qstate = q8.quantize_state_dict(model.state_dict())
    n_quantized = sum(isinstance(v, dict) for v in qstate.values())
    model.load_state_dict(q8.dequantize_state_dict(qstate))
    quantized = counts()
    # The JAX tree's >= 2-D leaves: the encoder, decoder, bottleneck and mask
    # convolutions, and per TDCN layer its bottleneck, depthwise and skip
    # convolutions and, but in the last layer, its output convolution.
    layers = PAPER["sep_num_blocks"] * PAPER["sep_num_layers"]
    weights = 4 + 4 * layers - 1
    check(n_quantized == weights and quantized == expected(quantize_int8=weights),
          f"quantized {n_quantized} tensors with launches {quantized}, expected {weights}")
    ckpt = os.path.join(os.path.dirname(conv_ckpt), "conv_tasnet_int8.pth")
    save_model(ckpt, model)
    log(f"  {n_quantized} tensors quantized on the card, one quantize_int8 launch each")
    outputs, served = serve("conv_tasnet_int8", ckpt, wavs, expected(fused_mask_decode=1))
    for wav in wavs:
        ref, got = conv_out[("float32", wav)], outputs[("float32", wav)]
        snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
        log(f"  f32 {os.path.basename(wav)}: int8 weights vs f32 weights, SNR {snr:.2f} dB "
            f"(informational)")
    return {k: v + quantized.get(k, 0) for k, v in served.items()}


# Uneven test utterances (samples at 8 kHz): off the stride-8 grid of
# Conv-TasNet and off DPRNN-TasNet's chunk grid.
TEST_LENGTHS = (9001, 12345, 15997)
TEST_METRICS = ("loss", "loss_improvement", "sdr_improvement", "sir_improvement", "sar")
EVAL_TOL_DB = 0.05  # card vs CPU, each metric of each utterance


def write_test_list(tmp):
    """A wsj0-style test set of pseudo-speech pairs, one list file per utterance."""
    root = os.path.join(tmp, "tt_uneven")
    for sub in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    speakers = _speaker_bank(6, seed=11)
    rng = np.random.default_rng(12)
    lists = []
    for i, T in enumerate(TEST_LENGTHS):
        s1 = synth_pseudo_speech(speakers[i], rng, T, SAMPLE_RATE)
        s2 = 0.7 * synth_pseudo_speech(speakers[i + 3], rng, T, SAMPLE_RATE)
        utt = f"tt{i}"
        for sub, sig in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
            write_wav(os.path.join(root, sub, f"{utt}.wav"), sig, SAMPLE_RATE)
        lists.append(os.path.join(root, f"{utt}.lst"))
        with open(lists[-1], "w") as f:
            f.write(utt + "\n")
    return root, lists


def evaluate(root, list_path, ckpt, device):
    """cli/test_wsj0mix.main on one utterance -> its summary (its CSV lines kept off the log)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return test_cli.main(["--test_wav_root", root, "--test_list_path", list_path,
                              "--model_path", ckpt, "--device", device])


def phase_evaluate(tmp, checkpoints, card):
    """The trained checkpoints through cli/test_wsj0mix.py on the card, against the CPU."""
    log("== phase 10: evaluate through cli/test_wsj0mix.py, card vs CPU")
    root, lists = write_test_list(tmp)
    total = dict.fromkeys(all_counts(), 0)
    for tag, ckpt in checkpoints.items():
        worst = 0.0
        reset_counts()
        for list_path, T in zip(lists, TEST_LENGTHS):
            before = all_counts()
            start = time.perf_counter()
            got = evaluate(root, list_path, ckpt, "cuda")
            wall = (time.perf_counter() - start) * 1e3
            grew_all = grown(before)
            grew = kernels_of(grew_all)
            check(grew == eval_launches(tag), f"{tag}: an utterance launched {grew}, expected "
                                              f"{eval_launches(tag)}")
            check_paths(grew_all, {}, f"{tag}: an f32 evaluation", decode_path(tag, "float32"))
            ref = evaluate(root, list_path, ckpt, "cpu")
            diffs = {k: abs(got[k] - ref[k]) for k in TEST_METRICS}
            check(all(np.isfinite(got[k]) for k in TEST_METRICS), got)
            worst = max(worst, *diffs.values())
            log(f"  {tag}, {T} samples: SI-SDRi {got['loss_improvement']:.3f} dB, SDRi "
                f"{got['sdr_improvement']:.3f}, SIRi {got['sir_improvement']:.3f}, SAR "
                f"{got['sar']:.3f}; max |card - CPU| {max(diffs.values()):.2e} dB; wall "
                f"{wall:.1f} ms = forward {got['forward_ms']:.1f} + BSS-Eval "
                f"{got['bss_eval_ms']:.1f} + load; launches {nonzero(grew)} [{card}]")
            if not max(diffs.values()) <= EVAL_TOL_DB:
                raise AssertionError(f"{tag}: card metrics differ from the CPU's: {diffs}")
        path = all_counts()
        total = {k: v + path[k] for k, v in total.items()}
        log(f"  {tag}: {len(lists)} utterances, worst |card - CPU| over every metric "
            f"{worst:.2e} dB (limit {EVAL_TOL_DB:g}); path launches {nonzero(path)}")
    return total


# Phase 11: musdb18 serving of paper-config ParallelOpenUnmix and bridged X-UMX.
MUSDB_TRACK_SECONDS = 20.0  # two test tracks of two 10 s chunks each
MUSDB_CHUNK_SECONDS = 10.0  # the CLI's default --duration: S = 431 frames a chunk
MUSDB_TRACKS = 2
MUSDB_DB_TOL = 0.05  # card vs CPU, each median of each stem
WIENER_TOL = 1e-3  # the EM alone, card vs CPU, relative to max|CPU|
UMX_BIDIR_LAYERS = UMX["num_layers"] * 4  # one bidirectional layer a stem, per chunk
# The recurrences at UMX's serving shapes: a 10 s chunk at B = 1; H = 512 // 2 per
# direction (bidirectional) and 512 (causal); both on the FMA kernel (H > 128).
UMX_SCAN_SHAPES = {"lstm_scan_bidir": (1, 431, UMX["hidden_channels"] // 2, 2),
                   "lstm_scan": (1, 431, UMX["hidden_channels"], 1)}


class RecordingEvaluater(Evaluater):
    """The musdb18 CLI's Evaluater, keeping the float stems (n_src, T, C) the CLI hands
    it, one list per thread (one CLI run a thread)."""

    stems: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        RecordingEvaluater.stems[threading.get_ident()] = self.seen = []

    def add_track(self, references, estimates):
        self.seen.append(np.array(estimates))
        return super().add_track(references, estimates)


def umx_wrapper(kind, causal=False, device="cuda"):
    """Paper-config ParallelOpenUnmix or bridged X-UMX in its wrapper, weights from seed 0,
    BatchNorm statistics and the per-bin affines off their init so they do real work."""
    cls = {"umx": ParallelOpenUnmix, "xumx": CrossNetOpenUnmix}[kind]
    model = SpectrogramMaskingWrapper(
        cls(**UMX, causal=causal, generator=torch.Generator().manual_seed(0), device=device),
        **UMX_STFT, device=device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_var", "norm1d.weight", "scale_in", "scale_out")):
                t.copy_(torch.from_numpy(0.5 + rng.random(t.shape, np.float32)))
            elif name.endswith(("running_mean", "norm1d.bias", "bias_in", "bias_out")):
                t.copy_(torch.from_numpy(0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    return model.eval()


def run_musdb_cli(root, ckpt, device):
    """cli/test_musdb18.py on `device` -> (medians table, per-track stats, float stems).
    The CLI's own lines go to the log as they come (CPU runs share the log from threads)."""
    argv = ["--musdb18_root", root, "--model_path", ckpt, "--device", device,
            "--sample_rate", str(MUSDB_SAMPLE_RATE), "--duration", str(MUSDB_CHUNK_SECONDS)]
    table, stats = musdb_cli.run(argv)
    return table, stats, RecordingEvaluater.stems.pop(threading.get_ident())


def musdb_chunks(root):
    """The chunks the CLI serves: each test track cut into 10 s chunks, the last padded."""
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    return sum(-(-mix.shape[-1] // chunk) for _, mix, _ in MusdbTestDataset(root))


def wiener_card_vs_cpu(model, root, card):
    """The EM alone on the first track's full-length inputs (the model's magnitudes of its
    chunks, the mixture spectrogram): card vs CPU, time and peak memory on the card."""
    _, mixture, _ = MusdbTestDataset(root)[0]
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    x = torch.from_numpy(mixture).cuda()
    with torch.inference_mode():
        amps = torch.cat([model(x[None, ..., i:i + chunk])[0]
                          for i in range(0, x.shape[-1], chunk)], dim=-1)
        spec = torch.cat([model.spectrogram(x[0, :, i:i + chunk])
                          for i in range(0, x.shape[-1], chunk)], dim=-1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card_est = multichannel_wiener_filter(spec, amps)
        peak = torch.cuda.max_memory_allocated()
        ms = median_ms(lambda: multichannel_wiener_filter(spec, amps), warmup=1, iters=5)
        ref = multichannel_wiener_filter(spec.cpu(), amps.cpu())
    err = float((card_est.cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  Wiener EM alone, {tuple(amps.shape)} (one iteration): card vs CPU max abs err "
        f"{err:.3e}, max|CPU| {scale:.3e}, limit {WIENER_TOL * scale:.3e}; {ms:.3f} ms "
        f"(median of 5, CUDA events); peak allocated {peak / 2**20:.1f} MiB, "
        f"{(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before "
        f"[{card}]")
    check(torch.isfinite(card_est).all() and err <= WIENER_TOL * scale,
          f"the Wiener EM on the card disagrees with the CPU: {err} > {WIENER_TOL} x {scale}")
    return dict(wiener_ms=ms, wiener_peak_bytes=peak, wiener_extra_bytes=peak - base)


def serve_musdb(kind, root, ckpt, chunks):
    """One model through the CLI on the card, every count set to 0 just before and read
    just after: exactly UMX_BIDIR_LAYERS lstm_scan_bidir launches a chunk, all on fma, and
    no other kernel."""
    log(f"== phase 11: musdb18 serving, paper-config {kind.upper()} through "
        f"cli/test_musdb18.py --device cuda")
    reset_counts()
    table, stats, stems = run_musdb_cli(root, ckpt, "cuda")
    launches = all_counts()
    want = expected(lstm_scan_bidir=UMX_BIDIR_LAYERS * chunks)
    check(kernels_of(launches) == want, f"{kind}: the CLI launched {nonzero(launches)}, "
                                        f"expected {nonzero(want)}")
    paths = {p: launches[f"lstm_scan_bidir/{p}"] for p in ls.PATH_LAUNCHES["lstm_scan_bidir"]}
    check(paths == {"mma": 0, "tf32x3": 0, "fma": UMX_BIDIR_LAYERS * chunks},
          f"{kind}: lstm_scan_bidir launched {paths} by path, expected all "
          f"{UMX_BIDIR_LAYERS * chunks} on fma (H = 256)")
    log(f"  {chunks} chunks: kernel launches {nonzero(launches)} "
        f"({UMX_BIDIR_LAYERS} lstm_scan_bidir on fma a chunk)")
    return dict(table=table, stats=stats, stems=stems, launches=launches["lstm_scan_bidir/fma"])


def musdb_card_vs_cpu(kind, served, cpu_run, card):
    """The card's stems within 1e-3 x max|CPU| of the CPU's, every median within
    MUSDB_DB_TOL dB; the card's stage times, audio-s/s and EM peak memory logged."""
    log(f"== phase 11: {kind.upper()} card vs CPU (cli/test_musdb18.py --device cpu)")
    table, cpu_table, cpu_stems = served["table"], cpu_run[0], cpu_run[2]
    for i, (got, ref) in enumerate(zip(served["stems"], cpu_stems)):
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        log(f"  track {i}: stems {got.shape} card vs CPU max abs err {err:.3e}, max|ref| "
            f"{scale:.3e}, limit {1e-3 * scale:.3e}")
        check(np.isfinite(got).all() and err <= 1e-3 * scale,
              f"{kind}: the card's stems disagree with the CPU's: {err} > 1e-3 x {scale}")
    check(len(served["stems"]) == len(cpu_stems) == MUSDB_TRACKS, "tracks evaluated")
    worst = max(abs(table[s][m] - cpu_table[s][m]) for s in table for m in Evaluater.METRICS)
    for s in table:
        log(f"  {s}: " + ", ".join(f"{m} {table[s][m]:.3f} (CPU {cpu_table[s][m]:.3f})"
                                   for m in Evaluater.METRICS) + " dB")
    log(f"  medians card vs CPU: worst {worst:.4f} dB (limit {MUSDB_DB_TOL})")
    check(worst <= MUSDB_DB_TOL, f"{kind}: a median differs from the CPU's by {worst:.4f} dB")
    for st in served["stats"]:
        log(f"  {st['name']}: BSS-Eval v4 {st['evaluate_s']:.2f} s on the host (the CLI's "
            f"card run, beside the CPU runs)")


def musdb_stage_times(kind, model, root, card, repeats=3):
    """A track's separation on a quiet host (no CLI run beside it): the CLI's
    separate_track on the second test track, after one warm-up, median of `repeats`;
    device ms by stage (CUDA events), audio-s/s on the host clock (host copy included),
    the EM's peak allocation."""
    _, mixture, _ = MusdbTestDataset(root)[1]
    x = torch.from_numpy(mixture).cuda()
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    chunks = -(-x.shape[-1] // chunk)
    runs = []
    with torch.inference_mode():
        for i in range(1 + repeats):
            start = time.perf_counter()
            wave, clock, peak = musdb_cli.separate_track(model, x, chunk, 1)
            wave.cpu()
            if i:
                runs.append(dict(clock.ms(), separate_s=time.perf_counter() - start, peak=peak))
    med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    seconds = x.shape[-1] / MUSDB_SAMPLE_RATE
    log(f"  {kind.upper()} stage times, {seconds:g} s track in {chunks} chunks (median of "
        f"{repeats}): forward {med['forward'] / chunks:.3f} ms a chunk, mixture STFT "
        f"{med['stft'] / chunks:.3f} ms a chunk, Wiener EM {med['wiener']:.3f} ms, iSTFT "
        f"{med['istft']:.3f} ms (CUDA events); separated in {med['separate_s'] * 1e3:.1f} ms = "
        f"{seconds / med['separate_s']:.2f} audio-s/s (host clock, host copy included); EM "
        f"peak allocated {med['peak'] / 2**20:.1f} MiB [{card}]")
    return dict(chunk_forward_ms=med["forward"] / chunks, track_audio_s_per_s=seconds /
                med["separate_s"], em_peak_bytes=med["peak"])


def causal_umx(root, card):
    """Causal paper-config UMX (one-chain LSTM, H = 512, on fma) over one 10 s chunk: card
    vs CPU, launches and forward time."""
    log("== phase 11: causal paper-config UMX, one 10 s chunk, card vs CPU")
    model = umx_wrapper("umx", causal=True)
    cpu = umx_wrapper("umx", causal=True, device="cpu")
    cpu.load_state_dict(model.state_dict())
    _, mixture, _ = MusdbTestDataset(root)[0]
    x = torch.from_numpy(mixture[..., :int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)])[None]
    reset_counts()
    with torch.inference_mode():
        got = model(x.cuda())
        torch.cuda.synchronize()
        launches = all_counts()
        ref = cpu(x)
        ms = median_ms(lambda: model(x.cuda()), warmup=1, iters=5)
    want = expected(lstm_scan=UMX_BIDIR_LAYERS)
    check(kernels_of(launches) == want and launches["lstm_scan/fma"] == UMX_BIDIR_LAYERS,
          f"causal UMX launched {nonzero(launches)}, expected {nonzero(want)} on fma")
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    log(f"  {tuple(got.shape)}: launches {nonzero(launches)}; card vs CPU max abs err "
        f"{err:.3e}, max|ref| {scale:.3e}, limit {1e-3 * scale:.3e}; forward {ms:.3f} ms "
        f"(median of 5, CUDA events) [{card}]")
    check(err <= 1e-3 * scale, f"causal UMX on the card disagrees with the CPU: {err}")
    return launches["lstm_scan/fma"]


def umx_scan_timings(card):
    """lstm_scan_bidir and lstm_scan alone at UMX's shapes (f32, FMA) against their plain
    versions, beside cuDNN's nn.LSTM at the same shape (input projection from 512
    features included)."""
    log("== phase 11: lstm_scan_bidir and lstm_scan at UMX's serving shapes (f32, fma)")
    out = {}
    features = UMX["hidden_channels"]
    for name, (B, T, H, chains) in UMX_SCAN_SHAPES.items():
        xw_f, xw_b, w_f, w_b = lstm_inputs(B, T, H, torch.float32, seed=T + H)
        if chains == 2:
            kernel = lambda: ls.lstm_scan_bidir(xw_f, xw_b, w_f, w_b)
            plain = lambda: ls.lstm_scan_bidir_reference(xw_f, xw_b, w_f, w_b)
        else:
            kernel = lambda: (ls.lstm_scan(xw_f, w_f),)
            plain = lambda: (ls.lstm_scan_reference(xw_f, w_f),)
        check(plan(ls, B, chains, H, torch.float32)[0] == "fma", f"{name} H={H} is not on fma")
        got = forward_path(ls, name, kernel, "fma")
        ref = plain()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        check(err <= LSTM_TOL[torch.float32], f"{name} at UMX's shape disagrees: {err}")
        ms = median_ms(kernel, warmup=2, iters=10)
        plain_ms = median_ms(plain, warmup=1, iters=3)
        lstm = torch.nn.LSTM(features, H, batch_first=True, bidirectional=chains == 2,
                             device="cuda")
        xin = torch.randn(B, T, features, device="cuda")
        with torch.no_grad():
            library_ms = median_ms(lambda: lstm(xin), warmup=2, iters=10)
        log(f"  {name} (B={B}, T={T}, H={H}, {chains} chain(s)) f32 fma: max|kernel-plain| "
            f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN nn.LSTM "
            f"{library_ms:.4f} ms (F={features}; medians of 10, 3, 10, CUDA events) [{card}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms)
    return out


def musdb_bench(card):
    """`python -m dnn_based_source_separation_torch.bench --model umx` and `xumx`."""
    log("== phase 11: the bench module's musdb18 lines (informational)")
    for kind in ("umx", "xumx"):
        proc = subprocess.run([sys.executable, "-m", "dnn_based_source_separation_torch.bench",
                               "--model", kind], capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, f"bench --model {kind} failed: {proc.stdout[-2000:]}"
                                    f"{proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        check(line["value"] > 0, line)
        log(f"  bench --model {kind}: {json.dumps(line)}")


def phase_musdb(card=None):
    """Phase 11 -> its launches and timings for the kernels line. BSS-Eval on the host
    dominates the CLI runs, so the two CPU runs go in threads beside the card runs (one at
    a time, each counted alone); the stage times come from a quiet host afterwards."""
    card = card or card_line()
    musdb_cli.Evaluater = RecordingEvaluater
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "musdb18")
        with contextlib.redirect_stdout(io.StringIO()):
            write_musdb_quality_corpus(root, n_train=0, n_valid=0, n_test=MUSDB_TRACKS,
                                       track_sec=MUSDB_TRACK_SECONDS,
                                       sample_rate=MUSDB_SAMPLE_RATE)
        chunks = musdb_chunks(root)
        models, ckpts, served = {}, {}, {}
        for kind in ("umx", "xumx"):
            models[kind] = umx_wrapper(kind)
            ckpts[kind] = os.path.join(tmp, f"{kind}.pth")
            save_model(ckpts[kind], models[kind])
        log("== phase 11: cli/test_musdb18.py --device cpu for UMX and X-UMX, in two threads "
            "beside the card runs")
        with ThreadPoolExecutor(2) as pool:
            cpu_runs = {kind: pool.submit(run_musdb_cli, root, ckpts[kind], "cpu")
                        for kind in ckpts}
            for kind in ckpts:
                served[kind] = serve_musdb(kind, root, ckpts[kind], chunks)
            cpu_runs = {kind: run.result() for kind, run in cpu_runs.items()}
        for kind in ckpts:
            musdb_card_vs_cpu(kind, served[kind], cpu_runs[kind], card)
            served[kind].update(wiener_card_vs_cpu(models[kind], root, card))
            served[kind].update(musdb_stage_times(kind, models[kind], root, card))
        causal = causal_umx(root, card)
    musdb_cli.Evaluater = Evaluater
    timings = umx_scan_timings(card)
    musdb_bench(card)
    return dict(served=served, causal_launches=causal, timings=timings)


def kernel_entry(name, source, replaces, launches, timing, bound_of, library_ms=None,
                 dtype=torch.float32, fma_bound=None):
    """One kernel of the `kernels` line; `dtype` is that of the inputs timed. A timing
    with the FMA kernel's time of the same run (a tensor-core row) adds it as fma_ms, and
    `fma_bound` (a bound() of the FMA kernel's work) as fma_bound_ms."""
    extra = {"fma_ms": timing["fma_ms"]} if "fma_ms" in timing else {}
    if fma_bound is not None:
        extra["fma_bound_ms"] = fma_bound["bound_ms"]
    return {"name": name, "route": "cuda", "source": f"dnn_based_source_separation_torch/{source}",
            "replaces": f"dnn_based_source_separation_tpu/{replaces}", "launches": launches,
            "dtype": str(dtype)[6:], "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], **bound_of, "library_ms": library_ms, **extra}


def recurrence_bound(B, T, H, gates, chains, backward=False, cell_state=False, bias=False,
                     dtype=torch.float32, tf32=0):
    """The least time of a recurrence's work at (B, T, H) in `dtype`.

    Forward: 2 x B x T x gates x H^2 FLOPs per chain (the recurrent product;
    the gate nonlinearities are a few operations per unit and are left out),
    over the dtype's peak (bf16: the tensor cores; f32: FMA outside them, or,
    with `tf32` = 3, three TF32 products at the tensor cores' TF32 peak), and
    xw read, hs written, at the dtype's size. Backward, as timed (the gate
    recompute, the kernel and the weight gradient): three products of that
    size, xw, hs, the cotangent (and the LSTM's cs) read, d_xw and the
    parameter gradients written. The backward computes in f32 in both dtypes:
    the FMA route runs all three products at the f32 FMA peak, the
    tensor-core route (`tf32` = 3 in f32 or 2 in bf16) the recurrent product
    as `tf32` TF32 products and the two cuBLAS products around it at the f32
    FMA peak.
    """
    G = gates * H
    product = chains * 2.0 * B * T * G * H
    seq = B * T * (G + H)  # xw and hs
    if backward:
        seq += B * T * (H + G + (H if cell_state else 0))  # g_hs, d_xw, cs
    params = G * H * (2 if backward else 1) + (G * (2 if backward else 1) if bias else 0)
    nbytes = torch.tensor([], dtype=dtype).element_size() * chains * (seq + params)
    if not backward:
        return bound(tf32 * product, nbytes, "tf32") if tf32 else bound(product, nbytes, dtype)
    if tf32:
        return bound_of_ops({"tf32": tf32 * product, torch.float32: 2 * product}, nbytes)
    return bound(3 * product, nbytes, torch.float32)


def backward_kernel_bound(B, T, H, gates, chains, dtype, tf32):
    """The least time of the tensor-core backward kernel alone: its recurrent product as
    `tf32` TF32 products, and its arrays read and written once. LSTM: gates and das in
    f32 (4H), cs and g_hs in the dtype, d_xw in bf16 only (in f32 das is d_xw). GRU: xw,
    hs, g_hs and d_xw in the dtype, hw and d_hw in f32 (3H each). W_hh in the dtype."""
    G = gates * H
    size = torch.tensor([], dtype=dtype).element_size()
    if gates == 4:
        row = 4 * 2 * G + size * (2 * H + (G if dtype == torch.bfloat16 else 0))
    else:
        row = 4 * 2 * G + size * (2 * G + 2 * H)
    nbytes = chains * (B * T * row + size * G * H)
    return bound(tf32 * chains * 2.0 * B * T * G * H, nbytes, "tf32")


BUILDS = {"mask_decode": md.build, "lstm_scan": ls.build, "lstm_scan_bwd": ls.build_backward,
          "gru_scan": gs.build, "gru_scan_bwd": gs.build_backward, "quantize": q8.build}


def phase_build():
    log("== phase 2: build")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:  # one nvcc per source, all at once
        for build in [pool.submit(b) for b in BUILDS.values()]:
            build.result()
    log(f"  {', '.join(BUILDS)} built/loaded in {time.perf_counter() - start:.2f} s")
    for name in BUILDS:
        info = _build.BUILD_INFO[name]
        log(f"  {name} ({info['seconds']:.2f} s):")
        log("  " + info["log"].strip().replace("\n", "\n  "))
        if info["log"] == "cached":
            continue
        stacks = [int(n) for n in re.findall(r"(\d+) bytes stack frame", info["log"])]
        check(stacks and not any(stacks), f"{name}: a kernel uses stack: {stacks}")
    log("  every kernel built with 0 bytes of stack")


ONLY_PHASES = {"3": phase_kernel, "3b": phase_lstm, "3c": phase_gru, "3d": phase_lstm_bwd,
               "3e": phase_gru_bwd, "3f": phase_quantize, "3g": phase_library,
               "6s": phase_stream_hops, "11": phase_musdb}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("chip_smoke")
    parser.add_argument("--only", type=str, default=None,
                        help="comma-separated kernel phases (3, 3b-3g), 6s (streaming ms "
                             "per hop) or 11 (musdb18 serving) to run after phases 1 and 2, "
                             "and nothing else; no result line is printed")
    args = parser.parse_args(argv)
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
    phase_build()
    if args.only:
        for phase in args.only.split(","):
            ONLY_PHASES[phase.strip()]()
        log(card)
        return 0

    timings = phase_kernel()
    lstm_timings = phase_lstm()
    gru_timings = phase_gru()
    bwd_timings = phase_lstm_bwd()
    gru_bwd_timings = phase_gru_bwd()
    quant_timing = phase_quantize()
    library = phase_library()
    blocks = DPRNN["sep_num_blocks"]
    stream_flags = ["--streaming_hop", str(STREAMING_HOP)]
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_mixtures(tmp)
        log("== phase 4: serve paper-config Conv-TasNet through cli/separate.py")
        conv_ckpt = os.path.join(tmp, "conv_tasnet.pth")
        make_checkpoint(conv_ckpt, ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0),
                                              device="cuda"))
        conv_out, total = serve("conv_tasnet", conv_ckpt, wavs, expected(fused_mask_decode=1))
        dprnn, streamed = {}, {}
        for rnn, phase in (("lstm", "4b"), ("gru", "4c")):
            for causal in (False, True):
                tag = f"dprnn_tasnet_{rnn}" + ("_causal" if causal else "")
                log(f"== phase {phase}: serve recipe-config DPRNN-TasNet, rnn_type={rnn}, "
                    f"causal={causal}, through cli/separate.py")
                ckpt = os.path.join(tmp, f"{tag}.pth")
                make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=causal,
                                                  device="cuda",
                                                  generator=torch.Generator().manual_seed(0)))
                # Intra-chunk: one bidirectional layer per block; inter-chunk: one
                # more (non-causal) or one unidirectional layer (causal).
                outputs, path = serve(tag, ckpt, wavs, expected(**{
                    "fused_mask_decode": 1, f"{rnn}_scan_bidir": blocks * (2 - causal),
                    f"{rnn}_scan": blocks * causal}))
                dprnn[tag] = (ckpt, outputs)
                total = {k: v + path[k] for k, v in total.items()}
        for rnn in ("lstm", "gru"):
            tag = f"dprnn_tasnet_{rnn}_stream"
            log(f"== phase 4d: stream the stream-safe causal DPRNN-TasNet, rnn_type={rnn}, "
                f"through cli/separate.py --streaming_hop {STREAMING_HOP}")
            ckpt = os.path.join(tmp, f"{tag}.pth")
            make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=True,
                                              stream_safe=True, device="cuda",
                                              generator=torch.Generator().manual_seed(0)))
            outputs, path = serve(tag, ckpt, wavs,
                                  lambda n, rnn=rnn: stream_launches(n, f"{rnn}_scan_bidir"),
                                  flags=stream_flags)
            streamed[tag] = (ckpt, outputs)
            total = {k: v + path[k] for k, v in total.items()}
            phase_stream_offline(tag, ckpt, wavs, outputs)
        tag = "conv_tasnet_causal_stream"
        log(f"== phase 4f: stream causal paper-config Conv-TasNet through cli/separate.py "
            f"--streaming_hop {STREAMING_HOP}")
        ckpt = os.path.join(tmp, f"{tag}.pth")
        make_checkpoint(ckpt, ConvTasNet(**dict(PAPER, causal=True), device="cuda",
                                         generator=torch.Generator().manual_seed(0)))
        outputs, path = serve(tag, ckpt, wavs, conv_stream_launches, flags=stream_flags)
        # The hops' decodes by dtype, as this run counted them: the kernels line's
        # streamed-hop rows.
        hop_launches = {dtype: path[width_key(decode_path(tag, dtype), str(dtype)[6:],
                                              PAPER["n_basis"], PAPER["kernel_size"])]
                        for dtype in (torch.float32, torch.bfloat16)}
        streamed[tag] = (ckpt, outputs)
        total = {k: v + path[k] for k, v in total.items()}
        phase_stream_offline(tag, ckpt, wavs, outputs, phase="4f")
        long_wav = write_long_mixture(tmp)
        long_out, path = phase_longform(conv_ckpt, long_wav)
        total = {k: v + path[k] for k, v in total.items()}
        path = phase_quantized_serve(conv_ckpt, wavs, conv_out)
        total = {k: v + path[k] for k, v in total.items()}
        phase_parity("Conv-TasNet", conv_ckpt, wavs, conv_out)
        for tag, (ckpt, outputs) in dprnn.items():
            phase_parity(tag, ckpt, wavs, outputs)
        for tag, (ckpt, outputs) in streamed.items():
            phase_parity(tag, ckpt, wavs, outputs, flags=stream_flags)
        phase_parity("Conv-TasNet long-form", conv_ckpt, [long_wav], long_out,
                     flags=["--chunk_duration", str(CHUNK_DURATION)])
        phase_throughput(conv_ckpt, wavs, card)
        for tag, (ckpt, _) in dprnn.items():
            phase_throughput_dprnn(tag, ckpt, wavs, card)
        for tag, (ckpt, _) in streamed.items():
            phase_throughput_stream(tag, ckpt, wavs, card)
        phase_throughput_longform(conv_ckpt, long_wav, card)
        phase_bench()
        phase_train_parity()
        trained, checkpoints = phase_train_cli(tmp, card)
        evaluated = phase_evaluate(tmp, checkpoints, card)
    phase_train_throughput(card)
    musdb = phase_musdb(card)  # its FMA launches are its own: not part of `total`
    for name in ("lstm_scan_bidir_bwd", "lstm_scan_bwd", "gru_scan_bidir_bwd", "gru_scan_bwd"):
        check(trained[name] >= 1, f"the training path never launched {name}")
    total = {k: v + trained[k] + evaluated[k] for k, v in total.items()}
    for name, n in total.items():
        if name.endswith("/fma"):  # every served and trained model has H = 128
            check(n == 0, f"the main path launched the FMA kernel: {name} {n} times")
        elif n < 1:
            raise AssertionError(f"the serving, training and evaluation paths never launched "
                                 f"{name}")
    check("jax" not in sys.modules and "flax" not in sys.modules, "jax was imported")
    check(not any(m.split(".")[0] == "dnn_based_source_separation_tpu" for m in sys.modules),
          "the JAX package was imported")

    f32, bf16 = torch.float32, torch.bfloat16
    H = DPRNN["sep_hidden_channels"]
    n_big = QUANT_BIG[0] * QUANT_BIG[1]
    # The recurrence forwards twice: the 3xTF32 kernel in f32 (its main-path
    # launches: the f32 forwards) and the tensor-core kernel in bf16 (the bf16
    # forwards), each beside the FMA kernel's time in the same run and cuDNN's
    # nn.LSTM / nn.GRU in the same dtype (it also does the input projection
    # the kernels take as given). einsum is fused_mask_decode's library call
    # in f32.
    forwards = [  # name, replaces, timings, timed shape, (B, T, chains), gates
        ("lstm_scan_bidir", "ops/pallas_lstm.py:323", lstm_timings, "intra", (2040, 250, 2), 4),
        ("lstm_scan", "ops/pallas_lstm.py:166", lstm_timings, "inter", (2000, 255, 1), 4),
        ("gru_scan_bidir", "ops/pallas_lstm.py:422", gru_timings, "intra", (2040, 250, 2), 3),
        # The one-chain instance of the same kernel: the JAX package runs the
        # unidirectional GRU in lax.scan, so it has no Pallas kernel of its own.
        ("gru_scan", "ops/pallas_lstm.py:422", gru_timings, "inter", (2000, 255, 1), 3),
    ]
    # fused_mask_decode once per served decoder width and dtype, on the path its
    # decodes take, with the launches of that width and dtype: `ms` one whole
    # wrapper call, `kernel_ms` the kernel alone; a "rows" or "mma" row also
    # carries the generic kernel's times from the same run (`generic_ms`,
    # `generic_kernel_ms`).
    # The streamed-hop rows carry phase 4f's counts of its hops' decodes in their dtype
    # (a subset of the serving rows' width count, which WIDTH_LAUNCHES keys by N and C·L).
    entries = []
    for which, dtype in (("serving shape", f32), ("serving shape", bf16),
                         ("DPRNN-TasNet decoder shape", f32),
                         ("DPRNN-TasNet decoder shape", bf16),
                         ("streamed hop shape", f32), ("streamed hop shape", bf16)):
        timing = timings[(which, dtype)]
        shape = DECODE_SHAPES[which]
        launches = (hop_launches[dtype] if which == "streamed hop shape" else
                    total[width_key(timing["path"], str(dtype)[6:], shape["N"], shape["CL"])])
        entry = kernel_entry("fused_mask_decode", "csrc/mask_decode.cu",
                             "ops/pallas_kernels.py:114", launches, timing,
                             mask_decode_bound(**shape, dtype=dtype),
                             timing["library_ms"], dtype=dtype)
        entry.update(path=timing["path"], shape=which,
                     **{k: timing[k] for k in ("kernel_ms", "generic_ms", "generic_kernel_ms")
                        if k in timing})
        entries.append(entry)
    for dtype, path, source, suffix in ((f32, "tf32x3", "csrc/recurrence_tf32.cuh", ""),
                                        (bf16, "mma", "csrc/recurrence_mma.cuh", "_bf16")):
        for name, replaces, times, shape, (B, T, chains), gates in forwards:
            route = recurrence_bound(B, T, H, gates, chains, bias=gates == 3, dtype=dtype,
                                     tf32=3 if path == "tf32x3" else 0)
            fma_bound = (recurrence_bound(B, T, H, gates, chains, bias=gates == 3, dtype=dtype)
                         if path == "tf32x3" else None)
            entries.append(kernel_entry(
                name, source, replaces, total[f"{name}/{path}"], times[(name, shape, dtype)],
                route, library[name + suffix], dtype=dtype, fma_bound=fma_bound))
    # The same forwards at UMX's serving shapes (phase 11: B = 1, a 10 s chunk, H = 256 a
    # direction, 512 causal), on the FMA kernel, with phase 11's launches (the two served
    # models' CLI runs on the card; the causal chunk) and cuDNN's nn.LSTM at the same shape.
    umx_launches = {"lstm_scan_bidir": sum(run["launches"] for run in musdb["served"].values()),
                    "lstm_scan": musdb["causal_launches"]}
    for name, replaces in (("lstm_scan_bidir", "ops/pallas_lstm.py:323"),
                           ("lstm_scan", "ops/pallas_lstm.py:166")):
        B, T, H_umx, chains = UMX_SCAN_SHAPES[name]
        timing = musdb["timings"][name]
        entry = kernel_entry(name, "csrc/lstm_scan.cu", replaces, umx_launches[name], timing,
                             recurrence_bound(B, T, H_umx, 4, chains, dtype=f32),
                             timing["library_ms"], dtype=f32)
        entry.update(path="fma", shape=f"UMX B={B} T={T} H={H_umx}")
        entries.append(entry)
    # The backwards of kernels 2-4 (`custom_vjp` _bidir_bwd and _lstm_bwd, both
    # _lstm_bwd_core; _gru_bidir_bwd, _gru_bwd_core) twice, f32 (three TF32
    # products) and bf16 (two), each at the training shape of its phase: `ms` is
    # the whole backward (the gate recompute, the kernel, the parameter
    # gradients), `kernel_ms` the kernel alone, each beside the FMA kernel's in
    # the same run (`fma_ms`, `fma_kernel_ms`) and its route's bounds; cuDNN's
    # backward in the same dtype (input projection included).
    backwards = [  # name, replaces, timings, timed shape, (B, T, chains), gates
        ("lstm_scan_bidir_bwd", "ops/pallas_lstm.py:339", bwd_timings, "intra", (510, 250, 2),
         4),
        ("lstm_scan_bwd", "ops/pallas_lstm.py:230", bwd_timings, "inter", (500, 255, 1), 4),
        ("gru_scan_bidir_bwd", "ops/pallas_lstm.py:473", gru_bwd_timings, "intra",
         (510, 250, 2), 3),
        ("gru_scan_bwd", "ops/pallas_lstm.py:431", gru_bwd_timings, "inter", (500, 255, 1), 3),
    ]
    for dtype, path, suffix in ((f32, "tf32x3", ""), (bf16, "tf32x2", "_bf16")):
        tf32 = 3 if dtype == f32 else 2
        for name, replaces, times, shape, (B, T, chains), gates in backwards:
            lstm = gates == 4
            timing = times[(name, shape, dtype)]
            entry = kernel_entry(
                name, "csrc/recurrence_bwd_tf32.cuh", replaces, total[f"{name}/{path}"], timing,
                recurrence_bound(B, T, H, gates, chains, backward=True, cell_state=lstm,
                                 bias=not lstm, dtype=dtype, tf32=tf32),
                library[name + suffix], dtype=dtype,
                fma_bound=recurrence_bound(B, T, H, gates, chains, backward=True,
                                           cell_state=lstm, bias=not lstm, dtype=dtype))
            entry.update(kernel_ms=timing["kernel_ms"], fma_kernel_ms=timing["fma_kernel_ms"],
                         kernel_bound_ms=backward_kernel_bound(B, T, H, gates, chains, dtype,
                                                               tf32)["bound_ms"])
            entries.append(entry)
    entries += [
        # Two reads of x and one int8 write; no single PyTorch call computes it.
        kernel_entry("quantize_int8", "csrc/quantize.cu", "ops/pallas_kernels.py:45",
                     total["quantize_int8"], quant_timing,
                     bound(3.0 * n_big, 9.0 * n_big + 4, f32)),
    ]
    log(card)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
