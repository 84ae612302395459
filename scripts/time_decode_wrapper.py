"""Time fused_mask_decode's wrapper, host time included, in one tree of the port.

    python3 scripts/time_decode_wrapper.py [--root DIR] [--tag NAME]

Imports `dnn_based_source_separation_torch` from DIR (default: this
checkout), so that two trees, such as an unpacked parent commit and this
one, can be timed in turns in one run on the same card. At the served
decoder widths (paper-config Conv-TasNet B=8, T'=3999, N=512, C·L=16 and
recipe-config DPRNN-TasNet B=8, T'=31999, N=64, C·L=2, each f32 and bf16,
the mask the strided (B, S, T', N) view the separator hands over) it times
only the public call `fused_mask_decode(w, mask, kernel)`:

  call_ms   one whole call between two CUDA events (median of 50), as the
            decoder makes it;
  host_us   the host time of a call: 200 calls issued back to back, timed on
            the host clock without waiting for the card (median of 5), over 200;
  busy_ms   200 calls back to back between two CUDA events, over 200: the
            larger of the host time and the kernel's.

Prints one JSON line: {"tag", "card", "rows": [{shape, dtype, call_ms,
host_us, busy_ms}, ...]}. Needs a CUDA card; builds the tree's kernel first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SHAPES = {"Conv-TasNet": (8, 2, 3999, 512, 16), "DPRNN-TasNet": (8, 2, 31999, 64, 2)}
BURST = 200


def main() -> int:
    parser = argparse.ArgumentParser("time_decode_wrapper")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--tag", default="this tree")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from dnn_based_source_separation_torch.ops import mask_decode as md

    if not torch.cuda.is_available():
        print("time_decode_wrapper: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    md.build()

    def events_ms(fn, repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(repeats):
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    rows = []
    for name, (B, S, T, N, CL) in SHAPES.items():
        rng = np.random.default_rng(T)
        w = torch.from_numpy(rng.standard_normal((B, T, N), dtype=np.float32))
        mask = torch.from_numpy(rng.uniform(0, 1, (B, T, S, N)).astype(np.float32))
        kernel = torch.from_numpy((0.1 * rng.standard_normal((N, CL))).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            wd, mk, kd = (t.to("cuda", dtype) for t in (w, mask, kernel))
            mk = mk.transpose(1, 2)
            with torch.no_grad():
                call = lambda: md.fused_mask_decode(wd, mk, kd)  # noqa: E731
                ref = md.fused_mask_decode_reference(wd, mk, kd)
                err = float((call() - ref).abs().max()) / float(ref.abs().max())
                if err > (1e-4 if dtype == torch.float32 else 2e-3):
                    raise AssertionError(f"{name} {dtype}: relative error {err}")
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
                call_ms = events_ms(call, 50)
                host = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(BURST):
                        call()
                    host.append((time.perf_counter() - t0) / BURST * 1e6)
                    torch.cuda.synchronize()
                busy_ms = events_ms(lambda: [call() for _ in range(BURST)], 5) / BURST
            rows.append(dict(shape=name, dtype=str(dtype)[6:], call_ms=call_ms,
                             host_us=float(np.median(host)), busy_ms=busy_ms))
    print(json.dumps({"tag": args.tag, "card": card.strip(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
