"""Time DPTNet's recipe train step in one tree of the port, on one CUDA card.

    python3 scripts/time_dptnet_step.py [--root DIR] [--tag NAME]

Imports `dnn_based_source_separation_torch` from DIR (default: this checkout), so that
two trees, such as an unpacked parent commit and this one, can be timed in turns in one
run on the same card. The step is `chip_smoke.py` phase 13's: recipe-config DPTNet (N64
L2 K100, 6 blocks, 4 heads, bottleneck 64, H = 256; seed-0 weights) trained at
B = 2 x 4 s in f32 (TF32 off) on a PIT SI-SDR loss under the warmup schedule with
clipping at 5, on a batch of noise drawn from a seed. After 2 warm-up steps, 10 steps:

  p50_ms        the step's wall time, ended by a synchronise (median);
  forward_ms,   the forward with the loss, the backward and the optimizer between CUDA
  backward_ms,  events (medians);
  optimizer_ms
  backward_routes  the recurrence backward's launches a step, by kernel and route.

Prints one JSON line: {"tag", "card", "p50_ms", "forward_ms", "backward_ms",
"optimizer_ms", "backward_routes"}. Needs a CUDA card; builds the tree's kernels first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

STEPS, WARMUP = 10, 2
SAMPLE_RATE = 8000


def main() -> int:
    parser = argparse.ArgumentParser("time_dptnet_step")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--tag", default="this tree")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from dnn_based_source_separation_torch.bench import DPTNET
    from dnn_based_source_separation_torch.criterion import NegSISDR, PIT1d
    from dnn_based_source_separation_torch.models import DPTNet
    from dnn_based_source_separation_torch.ops import lstm_scan as ls
    from dnn_based_source_separation_torch.train import make_warmup_optimizer

    if not torch.cuda.is_available():
        print("time_dptnet_step: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ls.build()
    ls.build_backward()

    model = DPTNet(**DPTNET, generator=torch.Generator().manual_seed(0), device="cuda")
    model.train()
    optimizer = make_warmup_optimizer(0.2, 4e-4, DPTNET["sep_bottleneck_channels"], 40, 10,
                                      max_norm=5.0, params=model.parameters())
    criterion = PIT1d(NegSISDR(), n_sources=2)
    rng = np.random.default_rng(7)
    sources = 0.1 * rng.standard_normal((2, 2, 4 * SAMPLE_RATE), dtype=np.float32)
    mixture = torch.from_numpy(sources.sum(axis=1, keepdims=True)).cuda()
    sources = torch.from_numpy(sources).cuda()

    walls, splits = [], []
    for i in range(WARMUP + STEPS):
        before = {name: dict(paths) for name, paths in ls.BWD_PATH_LAUNCHES.items()}
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        start = time.perf_counter()
        events[0].record()
        optimizer.zero_grad()
        loss = criterion(model(mixture), sources)[0]
        events[1].record()
        loss.backward()
        events[2].record()
        optimizer.step()
        events[3].record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            walls.append((time.perf_counter() - start) * 1e3)
            splits.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])
        routes = {f"{name}/{path}": n - before[name][path]
                  for name, paths in ls.BWD_PATH_LAUNCHES.items()
                  for path, n in paths.items() if n > before[name][path]}
    forward, backward, opt = (float(np.median([s[j] for s in splits])) for j in range(3))
    print(json.dumps({"tag": args.tag, "card": card.strip(), "p50_ms": float(np.median(walls)),
                      "forward_ms": forward, "backward_ms": backward, "optimizer_ms": opt,
                      "backward_routes": routes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
