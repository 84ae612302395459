"""How far a model's f32 train step on a CUDA card lies from the f64 step, and why.

    PYTHONPATH=. python3 scripts/probe_step_precision.py [--model tdc-unet mm-densenet ...]

The steps are `chip_smoke.py`'s: TDCUNet2d at the CUNet recipe's widths on a B = 1 x 1 s
map (phase 19b), and phase 17's one-stem musdb18 models at their recipe widths
(`d3net`, `mm-densenet`, `mm-dense-lstm`, `hrnet`, `cunet`), seed-0 weights.

chip_smoke's reference is the step in f64 on the CPU, but `ops/norms.py:flax_batch_norm`
computes a BatchNorm's statistics in f32 whatever its input's dtype, so that reference
carries f32 rounding wherever a model has a flax BatchNorm. Here each step's gradients are
held to the true f64 step (every BatchNorm in f64 too) and to chip_smoke's reference, as the
whole gradient's relative L2 error, and, against the true step, the worst tensor's max
error over its scale (max|g|, at least SLICE_E_SMALL_GRAD x the largest, as the phases take
it) and the tensors with the largest shares of the squared error, for:
  * chip_smoke's f64 reference itself;
  * the CPU in f32 (its sums accumulate in f64);
  * the card in f32 as the port runs it (cuDNN, TF32 off, its heuristic's algorithms);
  * the card with `cudnn.deterministic`, with `cudnn.benchmark` (the fastest algorithm
    measured), and with cuDNN off (PyTorch's own convolutions);
  * the card in f32 with every BatchNorm computed in f64;
  * the card with TF32 on for cuDNN and matmuls;
  * the card in f64, every BatchNorm in f64 (not MMDenseLSTM: its recurrence kernels
    take f32 and bf16).
With `--kernels`, the device kernels of one f32 step as run are listed by name and count
(torch.profiler), so the convolution algorithms cuDNN chose can be read.

Needs a CUDA card; nothing here runs on the main path.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
from dnn_based_source_separation_torch.ops import norms  # noqa: E402

SHARES = 5  # tensors listed by their share of the squared error
MUSDB_KINDS = ("d3net", "mm-densenet", "mm-dense-lstm", "hrnet", "cunet")
RECURRENT = ("mm-dense-lstm",)  # the recurrence kernels take f32 and bf16: no card f64 step


class Case:
    """A model's step: make(device) -> (model, criterion or None); batch(device);
    step(model, criterion, batch) -> (loss, {name: gradient})."""

    def __init__(self, kind):
        self.kind = kind

    def make(self, device):
        if self.kind == "tdc-unet":
            return cs.tdc_unet_model(device), None
        return cs.slice_e_model(self.kind, device, *cs.slice_e_one_stem(self.kind))

    def batch(self, device):
        if self.kind == "tdc-unet":
            return cs.tdc_unet_batch(1, cs.TDC_PARITY_SECONDS, device)
        return cs.slice_e_parity_batch(self.kind, device)

    def step(self, model, criterion, batch):
        if criterion is None:
            return cs.tdc_unet_grads(model, batch)
        return cs.musdb_grads_of_step(model.train(), criterion, batch)


def errors(ref, got, null):
    """(relative L2 of the whole gradient, (worst tensor's max error over its scale, its
    name), [(share of the squared error, name)])."""
    top = max(float(g.abs().max()) for g in ref.values())
    sq, ref_sq, worst, shares = 0.0, 0.0, (0.0, ""), []
    for n, g in ref.items():
        if n in null:
            continue
        d = got[n].detach().cpu().double() - g
        sq += float(d.square().sum())
        ref_sq += float(g.square().sum())
        scale = max(float(g.abs().max()), cs.SLICE_E_SMALL_GRAD * top)
        worst = max(worst, (float(d.abs().max()) / scale, n))
        shares.append((float(d.square().sum()), n))
    shares.sort(reverse=True)
    return (sq / ref_sq) ** 0.5, worst, [(s / (sq or 1.0), n) for s, n in shares[:SHARES]]


@contextlib.contextmanager
def batch_norm_in(dtype):
    """Every flax BatchNorm's statistics and normalisation computed in `dtype`."""
    keep = norms.flax_batch_norm
    norms.flax_batch_norm = lambda x, norm, dim=-1: keep(x, norm, dim, dtype=dtype)
    try:
        yield
    finally:
        norms.flax_batch_norm = keep


@contextlib.contextmanager
def backends(tf32=False, deterministic=False, benchmark=False, cudnn=True):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.enabled = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.enabled) = flags


def cpu_step(case, dtype, bn_dtype=None):
    model, criterion = case.make("cpu")
    batch = tuple(t.to(dtype) if t.is_floating_point() else t for t in case.batch("cpu"))
    with batch_norm_in(bn_dtype) if bn_dtype else contextlib.nullcontext():
        return case.step(model.to(dtype), criterion, batch)


def card_step(case, dtype=torch.float32, bn_dtype=None, **flags):
    with backends(**flags), (batch_norm_in(bn_dtype) if bn_dtype else contextlib.nullcontext()):
        model, criterion = case.make("cuda")
        model = model.to(dtype)
        batch = tuple(t.to(dtype) if t.is_floating_point() else t for t in case.batch("cuda"))
        if flags.get("benchmark"):  # the first step measures the algorithms
            case.step(copy.deepcopy(model), criterion, batch)
        return case.step(model, criterion, batch)


def kernels_of_step(case):
    """The device kernels of one f32 step as the port runs it -> Counter of names."""
    with backends():
        model, criterion = case.make("cuda")
        batch = case.batch("cuda")
        case.step(model, criterion, batch)  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            case.step(model, criterion, batch)
            torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA)


def probe(kind, kernels):
    case = Case(kind)
    f64 = torch.float64
    true_loss, true = cpu_step(case, f64, f64)
    _, chip_ref = cpu_step(case, f64)
    null = {n for n, g in true.items() if not bool(g.abs().max() > 0)}
    print(f"== {kind}: f64 CPU loss {true_loss:.9f}; {len(true)} gradients, {len(null)} of "
          f"them 0 in f64 and left out", flush=True)
    runs = {
        "chip_smoke's f64 reference (BatchNorm in f32)": lambda: cpu_step(case, f64),
        "CPU f32": lambda: cpu_step(case, torch.float32),
        "card f32 as run (cuDNN heuristic, TF32 off)": lambda: card_step(case),
        "card f32, cudnn.deterministic": lambda: card_step(case, deterministic=True),
        "card f32, cudnn.benchmark": lambda: card_step(case, benchmark=True),
        "card f32, cuDNN off": lambda: card_step(case, cudnn=False),
        "card f32, BatchNorm in f64": lambda: card_step(case, bn_dtype=f64),
        "card f32, TF32 on": lambda: card_step(case, tf32=True),
        "card f64, BatchNorm in f64": lambda: card_step(case, f64, f64),
    }
    if kind in RECURRENT:
        del runs["card f64, BatchNorm in f64"]
    for label, run in runs.items():
        loss, grads = run()
        l2, (worst, worst_name), shares = errors(true, grads, null)
        print(f"  {label}: loss err {abs(loss - true_loss):.3e}; gradient relative L2 "
              f"{l2:.3e} against the true f64 step, {errors(chip_ref, grads, null)[0]:.3e} "
              f"against chip_smoke's reference (its limit {cs.GRAD_TOL_L2:g}, or 10x the "
              f"CPU's); worst tensor {worst_name} {worst:.3e} of its scale", flush=True)
        print("      largest shares of the squared error: "
              + ", ".join(f"{n} {s:.1%}" for s, n in shares))
    if kernels:
        counts = kernels_of_step(case)
        print(f"  device kernels of one f32 step as run ({sum(counts.values())} launches, "
              f"{len(counts)} kernels):")
        for name, n in counts.most_common():
            print(f"    {n:4d}  {name[:160]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", nargs="+", default=["tdc-unet"],
                        choices=("tdc-unet",) + MUSDB_KINDS)
    parser.add_argument("--kernels", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    for kind in args.model:
        probe(kind, args.kernels)


if __name__ == "__main__":
    main()
