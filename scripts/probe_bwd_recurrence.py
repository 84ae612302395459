"""Where a step of the split-TF32 backward recurrence kernel goes, on one CUDA card.

    python3 scripts/probe_bwd_recurrence.py              # both tables
    python3 scripts/probe_bwd_recurrence.py --variants   # the variants table only

Two tables for PERF.md, at the training shapes of recipe-config DPRNN-TasNet
(H = 128, B = 2 x 4 s), LSTM and GRU, f32 and bf16:

1. tiles: every (M, C) tile of `csrc/recurrence_bwd_tf32.cuh`, each launched
   STRESS times with every output held against the FMA kernel's, and timed
   with CUDA events beside the tile that `_plan_bwd` picks and the FMA kernel.
2. variants: copies of `csrc/` with one edit each to the header (or the
   cells), built side by side into the git-ignored build directory and timed
   at the planned tile: "L2 128B" and "L2 256B" (the cells' global loads
   with that L2 prefetch size), "prefetch 2" (the step's inputs loaded two
   steps ahead, not one), "one k-slice" (every warp over the whole of K for its own
   n8 tile), "unroll 1" (the product's k-loop rolled), and diagnostics whose
   outputs are wrong on purpose: no loads (the inputs of step T - 1 reused at
   every step), no product, no split (da and W taken
   as TF32 values unsplit), one product, no cell (the nonlinearities made
   linear), no exchange (no writes into the other blocks' tiles), no barrier
   (in the loop), no stores (das, d_xw, d_hw). What each removes is what that
   part of a step costs.

Needs a CUDA card and nvcc; nothing here runs on the main path.
"""
from __future__ import annotations

import ctypes
import re
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
SHAPES = [  # name, B, T, chains: the training path's backward launches
    ("train", 510, 250, 2),  # intra-chunk RNN, B = 2 x 4 s
    ("train-inter", 500, 255, 1),  # causal inter-chunk RNN
]
DTYPES = {torch.float32: (0, 2), torch.bfloat16: (1, 3)}  # dtype -> (dtype code, path code)
HEADER = "recurrence_bwd_tf32.cuh"
LOOP = ("    for (int kk = slice * (KH / S); kk < (slice + 1) * (KH / S); ++kk) {"
        "  // this warp's slice")
ONE_SLICE = [(HEADER, "inline int k_slices(int H, int C) { return (H / C / 8) % 2 ? 1 : 2; }",
              "inline int k_slices(int H, int C) { return 1; }")]
UNROLL_1 = [(HEADER, "#pragma unroll 4\n" + LOOP, "#pragma unroll 1\n" + LOOP)]
NO_PRODUCT = [(HEADER, LOOP, "    for (int kk = 0; kk < 0; ++kk) {")]
NO_SPLIT = [
    (HEADER, "for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ahi[mt][e], alo[mt][e]);",
     "for (int e = 0; e < 4; ++e) ahi[mt][e] = alo[mt][e] = a[e];"),
    (HEADER, """            split(w.x, bhi[0], blo[0]);
            split(w.y, bhi[1], blo[1]);""", """            bhi[0] = blo[0] = __float_as_uint(w.x);
            bhi[1] = blo[1] = __float_as_uint(w.y);""")]
ONE_PRODUCT = [(HEADER, """            mma_tf32(acc[mt][n][q], alo[mt], bhi);
            if (!Cell::kExactW) mma_tf32(acc[mt][n][q], ahi[mt], blo);
""", "")]
NO_CELL = [
    (HEADER, "return __fdividef(1.f, 1.f + expf(-x)); }", "return 0.25f * x + 0.5f; }"),
    *[(source, '#include "recurrence_bwd_tf32.cuh"\n',
       '#include "recurrence_bwd_tf32.cuh"\n#define tanhf(x) (x)\n')
      for source in ("lstm_scan_bwd.cu", "gru_scan_bwd.cu")]]
NO_EXCHANGE = [(HEADER, "st_cluster_f32x2(peer_tile[p] + 4u * (off + q * H), v.x, v.y);", ";")]
NO_BARRIER = [  # the first step's barrier and the last one's stay
    (HEADER, """    cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)""", """    if (t == T_len - 1 || t == 0) cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)"""),
    (HEADER, """    cluster_wait();
    if (t == 0) break;""", """    if (t == T_len - 1 || t == 0) cluster_wait();
    if (t == 0) break;""")]
NO_STORES = [(HEADER, "if (b < B) cell.store(out[mt][half], b, t, u);",
              "if (b < 0) cell.store(out[mt][half], b, t, u);")]
NO_LOADS = [(HEADER, "    if (t > 0) load_step(nxt, t - 1);", "")]
PREFETCH_2 = [  # the step's inputs loaded two steps ahead instead of one
    (HEADER, """  In nxt[MT][2];
  load_step(nxt, T_len - 1);""", """  In nxt[MT][2], nxt2[MT][2];
  load_step(nxt, T_len - 1);
  if (T_len > 1) load_step(nxt2, T_len - 2);"""),
    (HEADER, "      for (int half = 0; half < 2; ++half) cur[mt][half] = nxt[mt][half];\n"
             "    if (t > 0) load_step(nxt, t - 1);",
     "      for (int half = 0; half < 2; ++half) {\n"
     "        cur[mt][half] = nxt[mt][half];\n"
     "        nxt[mt][half] = nxt2[mt][half];\n"
     "      }\n"
     "    if (t > 1) load_step(nxt2, t - 2);")]
LDG = """__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  return unpack(__ldg(reinterpret_cast<const unsigned*>(p)));
}"""


def l2_prefetch(size):
    """The cells' global loads with an L2 prefetch-size hint of `size` bytes."""
    new = f"""__device__ __forceinline__ float2 ldg_pair(const float* p) {{
  float2 v;
  asm("ld.global.nc.L2::{size}B.v2.f32 {{%0, %1}}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}}
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {{
  unsigned w;
  asm("ld.global.nc.L2::{size}B.b32 %0, [%1];" : "=r"(w) : "l"(p));
  return unpack(w);
}}"""
    return [(source, LDG, new) for source in ("lstm_scan_bwd.cu", "gru_scan_bwd.cu")]


VARIANTS = {"as built": [], "L2 128B": l2_prefetch(128), "L2 256B": l2_prefetch(256),
            "prefetch 2": PREFETCH_2, "one k-slice": ONE_SLICE,
            "unroll 1": UNROLL_1, "no loads": NO_LOADS, "no product": NO_PRODUCT,
            "no split": NO_SPLIT,
            "one product": ONE_PRODUCT, "no cell": NO_CELL, "no exchange": NO_EXCHANGE,
            "no barrier": NO_BARRIER, "no stores": NO_STORES}
WRONG_ON_PURPOSE = {"no loads", "no product", "no split", "one product", "no cell",
                    "no exchange", "no barrier", "no stores"}
STRESS = 20  # launches of each tile and each right variant, each output checked
BWD_TOL = 1e-4  # chip_smoke.py's f32 limit, relative to max|FMA|; bf16 outputs are f32 too


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


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


def bind(lib, name, gru):
    """The one- and two-chain launch functions of a library built from csrc/<name>.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for chains, suffix in ((1, "_bwd_launch"), (2, "_bidir_bwd_launch")):
        fn = getattr(lib, name + suffix)
        fn.argtypes = [p] * ((7 if gru else 6) * chains) + [i] * 7 + [p]
        fn.restype = i
        fns[chains] = fn
    return fns


def pointers(staged, gru):
    """A staged backward's arrays as its C entry point takes them (`_staged_backward`)."""
    if gru:
        return [s[k].data_ptr() for k in range(1, 8) for s in staged]
    return ([s[k].data_ptr() for k in range(1, 6) for s in staged]
            + [None if s[6] is s[5] else s[6].data_ptr() for s in staged])


class Case:
    """Seeded inputs of one backward launch, staged for the tensor-core kernel, and the FMA
    kernel's f32 output (das or d_hw) as the reference. Holds every array it points at."""

    def __init__(self, module, B, T, chains, dtype):
        self.gru = module is gs
        G = 3 if self.gru else 4
        gen = torch.Generator(device="cuda").manual_seed(B + T)
        xw = [0.5 * torch.randn(B, T, G * H, device="cuda", generator=gen) for _ in range(chains)]
        w = [(2 * torch.rand(H, G * H, device="cuda", generator=gen) - 1) * H ** -0.5
             for _ in range(chains)]
        b = [0.1 * torch.randn(G * H, device="cuda", generator=gen) for _ in range(chains)]
        g = [torch.randn(B, T, H, device="cuda", generator=gen) for _ in range(chains)]
        xw, w, b, g = ([t.to(dtype) for t in ts] for ts in (xw, w, b, g))
        if self.gru:
            hs = gs._forward_cuda(list(zip(xw, w, b)))
            self.chains = list(zip(xw, w, b, hs, g))
        else:
            hs, cs = ls._forward_cuda(list(zip(xw, w)), True)
            self.chains = list(zip(xw, w, hs, cs, g))
        self.module, self.B, self.T, self.dtype = module, B, T, dtype
        ref_staged, launch = module._staged_backward(self.chains, "fma")
        launch()
        self.ref = [s[-1 if self.gru else 5].clone() for s in ref_staged]
        self.staged, _ = module._staged_backward(self.chains)
        self.ptrs = pointers(self.staged, self.gru)
        self.outs = [s[-1 if self.gru else 5] for s in self.staged]

    def call(self, fn, tile):
        code, path = DTYPES[self.dtype]
        return lambda: fn(*self.ptrs, code, self.B, self.T, H, path, *tile,
                          torch.cuda.current_stream().cuda_stream)

    def error(self):
        torch.cuda.synchronize()
        return max(float((o - r).abs().max() / r.abs().max()) for o, r in zip(self.outs, self.ref))

    def stress(self, call, n=STRESS):
        """n launches, each output first filled with NaN -> (launches off the limit, worst)."""
        bad, worst = 0, 0.0
        for _ in range(n):
            for o in self.outs:
                o.fill_(float("nan"))
            check(call() == 0, "a launch was refused")
            err = self.error()
            err = err if err == err else float("inf")
            worst = max(worst, err)
            bad += err > BWD_TOL
        return bad, worst


def planned(module, B, chains, dtype):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return module._plan_bwd(B, chains, H, dtype, sms, None,
                            module._tf32_bwd_clusters(H, "cuda"))[1]


def tiles_table():
    faults = []
    for name, B, T, chains in SHAPES:
        for module, kernel in ((ls, "lstm_scan"), (gs, "gru_scan")):
            fns = bind(module._bwd_library(), kernel, module is gs)
            for dtype in DTYPES:
                case = Case(module, B, T, chains, dtype)
                tile = planned(module, B, chains, dtype)
                row = []
                for m in ls.BWD_TILE_ROWS:
                    for c in ls.TF32_CLUSTER_SIZES:
                        call = case.call(fns[chains], (m, c))
                        bad, worst = case.stress(call)
                        if bad:
                            faults.append((kernel, name, str(dtype), (m, c), bad, worst))
                        row.append(f"({m},{c}) {median_ms(call):.4f} [{bad} bad, worst "
                                   f"{worst:.1e}]")
                fma_tile = ls._fma_tile(B, chains, H,
                                        torch.cuda.get_device_properties(0).multi_processor_count)
                code, _ = DTYPES[dtype]
                fma_staged, _ = module._staged_backward(case.chains, "fma")  # kept alive
                fma_ptrs = pointers(fma_staged, module is gs)
                fma = median_ms(lambda: fns[chains](*fma_ptrs, code, B, T, H, 0, fma_tile, 1,
                                                    torch.cuda.current_stream().cuda_stream))
                again = median_ms(case.call(fns[chains], tile))
                print(f"  {kernel}_bwd {name} (B={B} x {chains} chains) {str(dtype)[6:]}: plan "
                      f"{tile}; " + "; ".join(row) + f"; FMA (R={fma_tile}) {fma:.4f}; plan "
                      f"again {again:.4f} ms", flush=True)
    print(f"  every tile launched {STRESS} times at every shape, each output checked (limit "
          f"{BWD_TOL:g} x max|FMA|): {len(faults)} tiles with a bad launch {faults}")
    check(not faults, f"tiles gave wrong outputs: {faults}")


def build_variant(directory, source):
    library = directory / f"{source}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(library),
                           str(directory / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory / source}:\n{proc.stderr[-3000:]}")
    log = proc.stdout + proc.stderr
    stack = max(int(n) for n in re.findall(r"(\d+) bytes stack frame", log))
    regs = max(int(n) for n in re.findall(r"Used (\d+) registers", log))
    return ctypes.CDLL(str(library)), stack, regs


def variants_table():
    root = _build.BUILD_DIR / "bwd_variants"
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
        jobs = {(v, s): pool.submit(build_variant, root / v.replace(" ", "_"), s + "_bwd")
                for v in VARIANTS for s in ("lstm_scan", "gru_scan")}
        built = {}
        for k, job in jobs.items():
            try:
                built[k] = job.result()
            except RuntimeError as err:  # a variant nvcc refuses is reported, not timed
                print(f"variant {k[0]!r} did not build: {str(err)[:600]}")
    fns = {k: bind(lib, k[1], k[1] == "gru_scan") for k, (lib, _, _) in built.items()}
    print(f"built {len(fns)} variant libraries in {time.perf_counter() - start:.1f} s; most "
          f"stack bytes and registers of a kernel: " + ", ".join(
              f"{v} {s}: {stack} B, {regs}" for (v, s), (_, stack, regs) in built.items()))
    for name, B, T, chains in SHAPES:
        for module, kernel in ((ls, "lstm_scan"), (gs, "gru_scan")):
            for dtype in DTYPES:
                case = Case(module, B, T, chains, dtype)
                tile = planned(module, B, chains, dtype)
                row = []
                for variant in VARIANTS:
                    if (variant, kernel) not in fns:
                        continue
                    call = case.call(fns[(variant, kernel)][chains], tile)
                    check(call() == 0, (variant, kernel, name))
                    err = case.error()
                    note = f"err {err:.1e}"
                    if variant not in WRONG_ON_PURPOSE:
                        bad, worst = case.stress(call)
                        note += f", {bad} of {STRESS} off, worst {worst:.1e}"
                        check(not bad, (variant, kernel, name, str(dtype), bad))
                    row.append(f"{variant} {median_ms(call):.4f} ({note})")
                print(f"  {kernel}_bwd {name} (B={B} x {chains} chains, tile {tile}) "
                      f"{str(dtype)[6:]}: " + "; ".join(row) + " ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bwd_recurrence: needs a CUDA card", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    for module in (ls, gs):
        module.build()
        module.build_backward()
    if "--variants" not in sys.argv:
        print("== tiles: ms per launch of each (M, C), medians of 10, CUDA events")
        tiles_table()
    print("== variants of the header at the planned tile: ms per launch, medians of 10")
    variants_table()
    return 0


if __name__ == "__main__":
    sys.exit(main())
