"""How far a model's f32 train step on a CUDA card lies from the f64 step, and why.

    PYTHONPATH=. python3 scripts/probe_step_precision.py [--model tdc-unet mm-densenet ...]

The steps are `chip_smoke.py`'s: TDCUNet2d at the CUNet recipe's widths on a B = 1 x 1 s
map (phase 19b), and phase 17's one-stem musdb18 models at their recipe widths
(`d3net`, `mm-densenet`, `mm-dense-lstm`, `hrnet`, `cunet`), seed-0 weights.

chip_smoke's reference is the step in f64 on the CPU, its BatchNorm statistics in f64
(`ops/norms.py:flax_batch_norm` computes them in the input's precision). Here each step's
gradients are held to that true f64 step as the whole gradient's relative L2 error, the
worst tensor's max error over its scale (max|g|, at least SLICE_E_SMALL_GRAD x the
largest, as the phases take it) and the tensors with the largest shares of the squared
error, for:
  * the f64 step with its BatchNorm statistics in f32;
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
With `--convs`, every convolution of one f32 card step as run is taken apart: from the
input and output gradient it saw in that step, its output and its input and weight
gradients on the card (cuDNN, as autograd computes them) and on the CPU in f32, each against
f64 on the CPU (max error over max|f64|), and the device kernels of its forward and backward
alone (torch.profiler), which name cuDNN's algorithms; a convolution is at fault where the
card misses f64 by more than EXACT_OVER x the CPU f32's. Then the step with cuDNN off in the
forwards of every Conv2d, and of every ConvTranspose2d, against the true step.

With `--kinks`, every ReLU of the step (`torch.nn.functional.relu`) is recorded in the true
f64 step and in the card's f32 step (and the card's f64 one): the calls whose inputs' signs
differ, how many entries and how close to 0 the f64 values were; then the card's and the
CPU's f32 steps with every ReLU taking the f64 step's sign pattern (the gradient of the same
linear piece), against the true step.

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
EXACT_OVER = 10.0  # --convs: a card gradient this many times the CPU f32's error is at fault
KERNELS_OF = 8  # --convs: the convolutions (by card error) whose backward kernels are listed
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


def card_step(case, dtype=torch.float32, bn_dtype=None, cudnn_off_in=(), **flags):
    """One step on the card; `cudnn_off_in`: module types whose forwards run with cuDNN off
    (their backwards with it on: the flag is read when a backward runs)."""
    with backends(**flags), (batch_norm_in(bn_dtype) if bn_dtype else contextlib.nullcontext()):
        model, criterion = case.make("cuda")
        model = model.to(dtype)
        for mod in model.modules():
            if cudnn_off_in and isinstance(mod, cudnn_off_in):
                mod.register_forward_pre_hook(
                    lambda *_: setattr(torch.backends.cudnn, "enabled", False))
                mod.register_forward_hook(
                    lambda *_: setattr(torch.backends.cudnn, "enabled", True))
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


def conv_grads(conv, x, g):
    """(output, d_input, d_weight) of `conv` (an nn.Conv2d or nn.ConvTranspose2d) at input x
    and output gradient g, as autograd computes them on their device."""
    x = x.detach().clone().requires_grad_()
    w = conv.weight.detach().to(x).clone().requires_grad_()
    if isinstance(conv, torch.nn.ConvTranspose2d):
        y = torch.nn.functional.conv_transpose2d(x, w, None, conv.stride, conv.padding,
                                                 conv.output_padding, conv.groups, conv.dilation)
    else:
        y = conv._conv_forward(x, w, None)
    return (y.detach(), *torch.autograd.grad(y, (x, w), g.to(x)))


def conv_probe(case, true, true_loss, null):
    """--convs: each convolution of one card step apart (module docstring) -> the names of
    those at fault."""
    convs = {}
    with backends():
        model, criterion = case.make("cuda")
        batch = case.batch("cuda")
        hooks = []
        for name, mod in model.named_modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                hooks.append(mod.register_forward_hook(
                    lambda m, inp, out, name=name: convs.setdefault(name, {}).update(
                        mod=m, x=inp[0].detach())))
                hooks.append(mod.register_full_backward_hook(
                    lambda m, gin, gout, name=name: convs[name].update(g=gout[0].detach())))
        case.step(model, criterion, batch)
        for h in hooks:
            h.remove()
        rows = []
        for name, c in convs.items():
            mod, x, g = c["mod"], c["x"], c["g"]
            ref = conv_grads(copy.deepcopy(mod).double().cpu(), x.double().cpu(),
                             g.double().cpu())
            runs = {"card": conv_grads(mod, x, g),
                    "cpu": conv_grads(copy.deepcopy(mod).cpu(), x.cpu(), g.cpu())}
            err = {k: [float((a.detach().cpu().double() - b).abs().max() / b.abs().max().clamp_min(
                1e-30)) for a, b in zip(v, ref)] for k, v in runs.items()}
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                conv_grads(mod, x, g)
                torch.cuda.synchronize()
            kernels = sorted({e.name for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA})
            rows.append((name, mod, tuple(x.shape), err, kernels))
    rows.sort(key=lambda r: -max(r[3]["card"]))
    print(f"  every convolution of one f32 card step (cuDNN as run, TF32 off), its output and "
          f"gradients from the step's own input and output gradient against f64, max err / "
          f"max|f64| (output, d_input, d_weight):", flush=True)
    at_fault = []
    for rank, (name, mod, shape, err, kernels) in enumerate(rows):
        fault = any(c > EXACT_OVER * max(p, 1e-7) for c, p in zip(err["card"], err["cpu"]))
        if fault:
            at_fault.append(name)
        print(f"    {name} {type(mod).__name__}{tuple(mod.weight.shape)} stride {mod.stride} "
              f"dilation {mod.dilation} input {shape}: card "
              + " / ".join(f"{e:.2e}" for e in err["card"]) + ", CPU f32 "
              + " / ".join(f"{e:.2e}" for e in err["cpu"])
              + (" AT FAULT" if fault else "")
              + ("; backward kernels: " + " | ".join(k[:90] for k in kernels)
                 if fault or rank < KERNELS_OF else ""), flush=True)
    for t in (torch.nn.Conv2d, torch.nn.ConvTranspose2d):
        label = f"cuDNN off in the forwards of every {t.__name__}"
        loss, grads = card_step(case, cudnn_off_in=(t,))
        l2, (worst, worst_name), shares = errors(true, grads, null)
        print(f"  card f32, {label}: loss err {abs(loss - true_loss):.3e}; gradient relative "
              f"L2 {l2:.3e} against the true f64 step; worst tensor {worst_name} {worst:.3e} "
              f"of its scale; largest shares "
              + ", ".join(f"{n} {s:.1%}" for s, n in shares), flush=True)
    print(f"  at fault: {at_fault}", flush=True)
    return at_fault


def kink_probe(case, true, null):
    """--kinks (module docstring)."""
    f64 = torch.float64
    rec64 = []
    with cs.relu_dispatch(), cs.relu_branches(record=rec64):
        cpu_step(case, f64, f64)
    masks = [(r > 0).float() for r in rec64]
    runs = [("card f32", lambda **k: card_step(case, **k))]
    if case.kind not in RECURRENT:
        runs.append(("card f64", lambda **k: card_step(case, f64, f64, **k)))
    for label, run in runs:
        rec = []
        with cs.relu_dispatch(), cs.relu_branches(record=rec):
            run()
        flips = [(i, tuple(a.shape), int(((a > 0) != (b > 0)).sum()),
                  float(a[(a > 0) != (b > 0)].abs().max()) if ((a > 0) != (b > 0)).any()
                  else 0.0) for i, (a, b) in enumerate(zip(rec64, rec))]
        flipped = [f for f in flips if f[2]]
        print(f"  {label}: {len(rec)} ReLU calls ({len(rec64)} in f64); "
              f"{sum(f[2] for f in flipped)} entries on the other side of 0 than in the "
              f"true f64 step, in {len(flipped)} calls: "
              + ", ".join(f"call {i} {shape}: {n} (|f64| up to {m:.2e})"
                          for i, shape, n, m in flipped[:12]), flush=True)
    for label, run in (("card f32", lambda: card_step(case)),
                       ("CPU f32", lambda: cpu_step(case, torch.float32))):
        with cs.relu_dispatch(), cs.relu_branches(masks=masks):
            loss, grads = run()
        l2, (worst, worst_name), _ = errors(true, grads, null)
        print(f"  {label}, every ReLU on the f64 step's sign pattern: gradient relative L2 "
              f"{l2:.3e} against the true f64 step; worst tensor {worst_name} {worst:.3e} of "
              f"its scale", flush=True)


def probe(kind, kernels, convs=False, kinks=False):
    case = Case(kind)
    f64 = torch.float64
    true_loss, true = cpu_step(case, f64, f64)
    null = {n for n, g in true.items() if not bool(g.abs().max() > 0)}
    print(f"== {kind}: f64 CPU loss {true_loss:.9f}; {len(true)} gradients, {len(null)} of "
          f"them 0 in f64 and left out", flush=True)
    runs = {
        "the f64 step, BatchNorm statistics in f32": lambda: cpu_step(case, f64, torch.float32),
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
              f"{l2:.3e} against the true f64 step (chip_smoke's limit {cs.GRAD_TOL_L2:g}, or "
              f"10x the CPU's); worst tensor {worst_name} {worst:.3e} of its scale", flush=True)
        print("      largest shares of the squared error: "
              + ", ".join(f"{n} {s:.1%}" for s, n in shares))
    if convs:
        conv_probe(case, true, true_loss, null)
    if kinks:
        kink_probe(case, true, null)
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
    parser.add_argument("--convs", action="store_true")
    parser.add_argument("--kinks", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), flush=True)
    for kind in args.model:
        probe(kind, args.kernels, args.convs, args.kinks)


if __name__ == "__main__":
    main()
