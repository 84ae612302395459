"""Where a step of the 3xTF32 recurrence kernel goes, on one CUDA card.

    python3 scripts/probe_tf32_recurrence.py            # both tables
    python3 scripts/probe_tf32_recurrence.py --tiles    # the tile table only

Two tables for PERF.md, both at the main path's f32 shapes (H = 128):

1. tiles: every (M, C) tile of the port's 3xTF32 kernel
   (`csrc/recurrence_tf32.cuh`, M rows on a cluster of C blocks), each
   checked against the plain version and timed with CUDA events, beside the
   tile `_plan` picks and the FMA kernel. It shows whether the plan's rule
   picks the fastest tile.
2. variants: copies of `csrc/` with one edit each to the 3xTF32 header,
   built side by side into the git-ignored build directory and timed at the
   planned tiles: the split by `cvt.rna.tf32.f32` (which the integer split
   replaced), the `.aligned` cluster barrier (which the plain form replaced),
   a cell update by `1 - 2 / (1 + e^2x)` and `__expf`, and four diagnostics
   whose outputs are wrong on purpose: one TF32 product instead of three, no
   cell update, no cluster barrier in the loop, no product. What each removes
   is what that part of a step costs.

Each tile, and each variant meant to be right, is launched many times with
every output checked (stress), since a race shows only in some launches.

Needs a CUDA card and nvcc; nothing here runs on the main path.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from dnn_based_source_separation_torch.ops import _build  # noqa: E402
from dnn_based_source_separation_torch.ops import gru_scan as gs  # noqa: E402
from dnn_based_source_separation_torch.ops import lstm_scan as ls  # noqa: E402

H = 128
SHAPES = [  # name, B, T, chains: the main path's f32 recurrence launches
    ("stream", 3, 250, 2),  # one streamed hop's intra-chunk RNN
    ("request", 255, 250, 2),  # one 4 s request's intra-chunk RNN
    ("train-inter", 500, 255, 1),  # causal inter-chunk RNN, B = 2 x 4 s
    ("train", 510, 250, 2),  # intra-chunk RNN, B = 2 x 4 s
    ("inter", 2000, 255, 1),  # causal inter-chunk RNN, B = 8 x 4 s
    ("intra", 2040, 250, 2),  # intra-chunk RNN, B = 8 x 4 s
]
HEADER = "recurrence_tf32.cuh"
CVT = [(HEADER, """  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;""",
        """  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;""")]
FAST_CELL = [
    ("recurrence_mma.cuh", "return __fdividef(1.f, 1.f + expf(-x)); }",
     "return __fdividef(1.f, 1.f + __expf(-x)); }"),
    ("lstm_scan.cu", """    const float gg = tanhf(acc[2][j]), go = mma_scan::sigmoid(acc[3][j]);
    c = gf * c + gi * gg;
    return go * tanhf(c);""", """    const float e = __expf(2.f * acc[2][j]);
    const float gg = 1.f - __fdividef(2.f, 1.f + e), go = mma_scan::sigmoid(acc[3][j]);
    c = gf * c + gi * gg;
    return go * (1.f - __fdividef(2.f, 1.f + __expf(2.f * c)));"""),
    ("gru_scan.cu", """    const float ng = tanhf(x[2][j] + rg * acc[2][j]);""",
     """    const float pre = x[2][j] + rg * acc[2][j];
    const float ng = 1.f - __fdividef(2.f, 1.f + __expf(2.f * pre));""")]
ONE_PASS = [(HEADER, """          mma_tf32(acc[mt][q], alo, bhi[q]);
          mma_tf32(acc[mt][q], ahi, blo[q]);
""", "")]
NO_CELL = [(HEADER, "hv[mt][j] = Cell::update(acc[mt], xv[mt], j, state[mt][j]);",
            "hv[mt][j] = 1e-3f * acc[mt][0][j] + 1e-3f * xv[mt][G - 1][j];")]
NO_BARRIER = [(HEADER, """    cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)""", """    if (t == T_len - 1) cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)"""), (HEADER, """    cluster_wait();
  }
}""", """    if (t == T_len - 1) cluster_wait();
  }
}""")]
NO_MMA = [(HEADER, """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));""",
           "  d[0] += 0.f * __uint_as_float(a[0] ^ b[0]);")]
ALIGNED = [(HEADER, 'asm volatile("barrier.cluster.arrive;\\n" ::: "memory");',
            'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");'),
           (HEADER, 'asm volatile("barrier.cluster.wait;\\n" ::: "memory");',
            'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");')]
VARIANTS = {"as built": [], "aligned barrier": ALIGNED, "cvt split": CVT, "fast cell": FAST_CELL,
            "one pass": ONE_PASS, "no cell": NO_CELL, "no barrier": NO_BARRIER,
            "no product": NO_MMA}
WRONG_ON_PURPOSE = {"one pass", "no cell", "no barrier", "no product"}
# Launches of each tile (and of each variant that should be right, at the
# small shapes) whose every output is checked: a race shows only in some runs.
STRESS_TILES, STRESS_VARIANTS = 20, 100


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def stress(call, hs, ref, n):
    """n launches, each output (first filled with NaN) held against the plain version
    -> (launches off by more than 1e-4, the largest error)."""
    bad, worst = 0, 0.0
    for _ in range(n):
        for h in hs:
            h.fill_(float("nan"))
        check(call() == 0, "a launch was refused")
        err = error(hs, ref)
        err = err if err == err else float("inf")
        worst = max(worst, err)
        bad += err > 1e-4
    return bad, worst


def median_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bind(lib, name):
    """The one- and two-chain launch functions of a library built from csrc/<name>.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for chains, suffix in ((1, "_launch"), (2, "_bidir_launch")):
        fn = getattr(lib, name + suffix)
        fn.argtypes = [p] * (4 * chains) + [i] * 7 + [p]
        fn.restype = i
        fns[chains] = fn
    return fns


def case(module, B, T, chains):
    """Seeded inputs on the card -> (outputs, launch pointers, plain result, inputs). The
    caller keeps the inputs alive while it launches: the pointers do not."""
    G = 4 if module is ls else 3
    gen = torch.Generator(device="cuda").manual_seed(B + T)
    xw = [0.5 * torch.randn(B, T, G * H, device="cuda", generator=gen) for _ in range(chains)]
    w = [(2 * torch.rand(H, G * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(chains)]
    b = [0.1 * torch.randn(G * H, device="cuda", generator=gen) for _ in range(chains)]
    hs = [torch.empty(B, T, H, device="cuda") for _ in range(chains)]
    if module is ls:
        ptrs = [t.data_ptr() for t in (*xw, *w, *hs)] + [None] * chains
        ref = [ls.lstm_scan_reference(x, ww) for x, ww in zip(xw, w)]
    else:
        ptrs = [t.data_ptr() for t in (*xw, *w, *b, *hs)]
        ref = [gs.gru_scan_reference(x, ww, bb) for x, ww, bb in zip(xw, w, b)]
    return hs, ptrs, ref, (xw, w, b)


def error(hs, ref):
    torch.cuda.synchronize()
    return max(float((h - r).abs().max()) for h, r in zip(hs, ref))


def planned(module, B, chains, path=None):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return module._plan(B, chains, H, torch.float32, sms, path,
                        module._tf32_clusters(H, "cuda"))


def tiles_table(stream):
    """Every tile at every shape: its time, and STRESS_TILES launches each checked."""
    print(f"clusters the card holds at once, by blocks a cluster: {ls._tf32_clusters(H, 'cuda')}")
    faults = []
    for name, B, T, chains in SHAPES:
        for module, kernel in ((ls, "lstm_scan"), (gs, "gru_scan")):
            fn = bind(module._library(), kernel)[chains]
            hs, ptrs, ref, _inputs = case(module, B, T, chains)
            tile = planned(module, B, chains)[1]
            row = []
            for m in (16, 32, 64):
                for c in ls.TF32_CLUSTER_SIZES:
                    call = lambda m=m, c=c: fn(*ptrs, 0, B, T, H, 2, m, c, stream)
                    bad, worst = stress(call, hs, ref, STRESS_TILES)
                    if bad:
                        faults.append((kernel, name, (m, c), bad, worst))
                    row.append(f"({m},{c}) {median_ms(call):.4f} [{bad} bad]")
            r = planned(module, B, chains, "fma")[1]
            fma = median_ms(lambda: fn(*ptrs, 0, B, T, H, 0, r, 1, stream))
            again = median_ms(lambda: fn(*ptrs, 0, B, T, H, 2, *tile, stream))
            print(f"  {kernel} {name} (B={B} x {chains} chains): plan {tile}; " + "; ".join(row)
                  + f"; FMA (R={r}) {fma:.4f}; plan again {again:.4f} ms", flush=True)
    print(f"  every tile launched {STRESS_TILES} times at every shape, each output checked "
          f"(limit 1e-4): {len(faults)} tiles with a bad launch {faults}")
    check(not faults, f"tiles gave wrong outputs: {faults}")


def build_variant(directory, source):
    library = directory / f"{source}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(library),
                           str(directory / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory / source}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(library))


def variants_table(stream):
    root = _build.BUILD_DIR / "tf32_variants"
    shutil.rmtree(root, ignore_errors=True)
    for variant, edits in VARIANTS.items():
        directory = root / variant.replace(" ", "_")
        shutil.copytree(_build.CSRC_DIR, directory)
        for file, old, new in edits:
            text = (directory / file).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {variant!r}: the edit of {file} no longer applies")
            (directory / file).write_text(text.replace(old, new))
    start = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        jobs = {(v, s): pool.submit(build_variant, root / v.replace(" ", "_"), s)
                for v in VARIANTS for s in ("lstm_scan", "gru_scan")}
        fns = {k: bind(job.result(), k[1]) for k, job in jobs.items()}
    print(f"built {len(fns)} variant libraries in {time.perf_counter() - start:.1f} s")
    for name, B, T, chains in SHAPES:
        if name in ("request", "train-inter"):
            continue
        for module, kernel in ((ls, "lstm_scan"), (gs, "gru_scan")):
            hs, ptrs, ref, _inputs = case(module, B, T, chains)
            tile = planned(module, B, chains)[1]
            row = []
            for variant in VARIANTS:
                call = lambda f=fns[(variant, kernel)][chains]: f(*ptrs, 0, B, T, H, 2, *tile,
                                                                 stream)
                check(call() == 0, (variant, kernel, name))
                err = error(hs, ref)
                check(variant in WRONG_ON_PURPOSE | {"aligned barrier"} or err <= 1e-4,
                      (variant, kernel, name, err))
                note = f"err {err:.1e}"
                if variant not in WRONG_ON_PURPOSE and name in ("stream", "train"):
                    bad, worst = stress(call, hs, ref, STRESS_VARIANTS)
                    note += f", {bad} of {STRESS_VARIANTS} launches off, worst {worst:.1e}"
                    check(variant == "aligned barrier" or not bad, (variant, kernel, name, bad))
                row.append(f"{variant} {median_ms(call):.4f} ({note})")
            print(f"  {kernel} {name} (B={B} x {chains} chains, tile {tile}): " + "; ".join(row)
                  + " ms", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("probe_tf32_recurrence")
    parser.add_argument("--tiles", action="store_true", help="the tile table only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_tf32_recurrence: needs a CUDA card", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    ls.build()
    gs.build()
    stream = torch.cuda.current_stream().cuda_stream
    print("== tiles: ms per launch of each (M, C), medians of 10, CUDA events")
    tiles_table(stream)
    if not args.tiles:
        print("== variants of the header at the planned tile: ms per launch, medians of 10")
        variants_table(stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
