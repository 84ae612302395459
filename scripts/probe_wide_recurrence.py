"""Where a step of the LSTM forward's wide kernel goes, on one CUDA card.

    python3 scripts/probe_wide_recurrence.py

At DPTNet's shapes (B = 8 x 4 s: 5112 sequences of 100 steps, 800 of 639; two chains)
and at B = 16 (musdb18 training's), H = 256, bf16 and f32, each on the tile the plan
gives it on this card, copies of `csrc/` with one edit each to
`csrc/recurrence_wide.cuh` are built side by side into the git-ignored build directory
and timed from CUDA graphs:

- "as built": h published by one cp.async.bulk of each rank's block to each other rank,
  onto its mbarrier;
- the two exchanges it replaced: "st.async" (each pair sent with st.async onto every
  rank's mbarrier, as csrc/recurrence_cluster.cuh does) and "barrier.cluster" (each pair
  stored with st.shared::cluster, published by one cluster barrier a step, as
  csrc/recurrence_tf32.cuh does);
- three diagnostics whose outputs are wrong on purpose: "no exchange" (no copies and no
  waits: every rank reads its own stale copies of the other ranks' blocks), "no
  product" (no mma) and "no cell" (the gates summed instead of the LSTM cell). What
  each removes is what that part of a step costs.

Each variant meant to be right is launched STRESS times, each output checked against the
plain version.

Needs a CUDA card and nvcc; nothing here runs on the main path.
"""
from __future__ import annotations

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
from dnn_based_source_separation_torch.ops import lstm_scan as ls  # noqa: E402

H = ls.WIDE_HIDDEN
SHAPES = [  # name, B, T, chains, dtype
    ("DPTNet intra", 5112, 100, 2, torch.bfloat16),
    ("DPTNet inter", 800, 639, 2, torch.bfloat16),
    ("B=16", 16, 259, 2, torch.bfloat16),
    ("DPTNet intra", 5112, 100, 2, torch.float32),
    ("DPTNet inter", 800, 639, 2, torch.float32),
    ("B=16", 16, 259, 2, torch.float32),
]
HEADER = "recurrence_wide.cuh"
HELPERS_AT = "// Fragment position j of m16 tile mt of a warp is row"
KBYTES = "    constexpr unsigned kBytes = (unsigned)((C - 1) * BLOCK * sizeof(T));\n"
EXPECT = ("    if (tid == 0 && t + 1 < T_len) cluster_scan::mbar_expect(mbar + next_mbar, "
          "kBytes);\n")
WAIT = ("    if (t > 0) cluster_scan::mbar_wait(mbar + 8u * (unsigned)(t & 1), "
        "(unsigned)((t - 1) >> 1) & 1u);\n")
LOCAL_WRITE = ("        *reinterpret_cast<PT*>(htile + off) = P::pack(hv[mt][2 * half], "
               "hv[mt][2 * half + 1]);\n")
COPY = ("        copy_bulk(there + own, base + own, (unsigned)(BLOCK * sizeof(T)), "
        "there + next_mbar);\n")
BULK_BLOCK = """    if (t + 1 < T_len) {
      // The block's writes, seen by the async proxy that copies them, and by the other
      // warps of this rank at the next step, before its copies to the other ranks.
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      __syncthreads();
      if (tid < C && tid != (int)rank) {
        const unsigned own = h_off + (unsigned)((next + (int)rank * BLOCK) * (int)sizeof(T));
        const unsigned there = tf32_scan::map_to_rank(base, (unsigned)tid);
""" + COPY + """      }
    }
"""
LOOP_END = """      }
  }
  // No block leaves while another may still write to its shared memory."""
REMOTE = "tf32_scan::map_to_rank(base, (unsigned)p) + h_off + (unsigned)(off * (int)sizeof(T))"
PAIR = "P::pack(hv[mt][2 * half], hv[mt][2 * half + 1])"
# Each pair sent with st.async onto every rank's mbarrier (this one's included).
ST_ASYNC = [
    (HEADER, HELPERS_AT, """__device__ __forceinline__ void put_async(unsigned a, unsigned v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\\n"
               ::"r"(a), "r"(v), "r"(mbar) : "memory");
}
__device__ __forceinline__ void put_async(unsigned a, float2 v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\\n"
               ::"r"(a), "f"(v.x), "f"(v.y), "r"(mbar) : "memory");
}

""" + HELPERS_AT),
    (HEADER, KBYTES, "    constexpr unsigned kBytes = (unsigned)(M * H * sizeof(T));\n"),
    (HEADER, LOCAL_WRITE, f"""        if (t + 1 < T_len) {{
#pragma unroll
          for (int p = 0; p < C; ++p)
            put_async({REMOTE}, {PAIR},
                      tf32_scan::map_to_rank(base, (unsigned)p) + next_mbar);
        }}
"""),
    (HEADER, BULK_BLOCK, ""),
]
# Each pair stored into the other ranks with st.shared::cluster, published by one
# barrier.cluster a step (arrive before the hs stores, wait after them).
BARRIER = [
    (HEADER, HELPERS_AT, """__device__ __forceinline__ void put(unsigned a, unsigned v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void put(unsigned a, float2 v) {
  tf32_scan::st_cluster_f32x2(a, v.x, v.y);
}

""" + HELPERS_AT),
    (HEADER, EXPECT, ""),
    (HEADER, WAIT, ""),
    (HEADER, LOCAL_WRITE, LOCAL_WRITE + f"""#pragma unroll
        for (int p = 0; p < C; ++p)
          if (p != (int)rank) put({REMOTE}, {PAIR});
"""),
    (HEADER, BULK_BLOCK, "    tf32_scan::cluster_arrive();\n"),
    (HEADER, LOOP_END, """      }
    tf32_scan::cluster_wait();
  }
  // No block leaves while another may still write to its shared memory."""),
]
NO_EXCHANGE = [(HEADER, WAIT, ""), (HEADER, EXPECT, ""), (HEADER, COPY, "")]
NO_PRODUCT = [
    (HEADER, """#pragma unroll 2
      for (int ks = 0; ks < KS; ++ks) {""", """#pragma unroll 2
      for (int ks = 0; ks < 0; ++ks) {"""),
    (HEADER, """#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {""", """#pragma unroll 4
      for (int ks = 0; ks < 0; ++ks) {"""),
]
NO_CELL = [(HEADER, """        const float gi = mma_scan::sigmoid(acc[mt][0][j]), gf = mma_scan::sigmoid(acc[mt][1][j]);
        const float gg = tanhf(acc[mt][2][j]), go = mma_scan::sigmoid(acc[mt][3][j]);
        c[mt][j] = gf * c[mt][j] + gi * gg;
        hv[mt][j] = go * tanhf(c[mt][j]);""", """        c[mt][j] = 1e-3f * (acc[mt][0][j] + acc[mt][1][j] + acc[mt][2][j]);
        hv[mt][j] = 1e-3f * acc[mt][3][j] + c[mt][j];""")]
VARIANTS = {"as built": [], "st.async": ST_ASYNC, "barrier.cluster": BARRIER,
            "no exchange": NO_EXCHANGE, "no product": NO_PRODUCT, "no cell": NO_CELL}
WRONG_ON_PURPOSE = {"no exchange", "no product", "no cell"}
STRESS = 5  # checked launches of each variant meant to be right, at each shape


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def graph_ms(call, iters=20):
    """ms of one call() on the card alone: one call captured in a CUDA graph, the median
    of `iters` replays (CUDA events)."""
    err = call()
    check(err == 0, f"a launch was refused: cudaError {err}")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def build_variant(directory):
    library = directory / "lstm_scan.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(library),
                           str(directory / "lstm_scan.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_bidir_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.lstm_scan_bidir_launch.restype = i
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wide_recurrence: needs a CUDA card", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    root = _build.BUILD_DIR / "wide_variants"
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
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {v: pool.submit(build_variant, root / v.replace(" ", "_")) for v in VARIANTS}
        libs = {v: job.result() for v, job in jobs.items()}
    print(f"built {len(libs)} variant libraries in {time.perf_counter() - start:.1f} s")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"== ms per launch and us per step, CUDA graphs, medians of 20 [{card}]")
    for name, B, T, chains, dtype in SHAPES:
        M, C = ls._plan(B, chains, H, dtype, sms, "wide", None, ls.ROUTES,
                        ls._wide_counts(H, dtype, "cuda"))[1]
        gen = torch.Generator(device="cuda").manual_seed(B + T)
        xw = [(0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen)).to(dtype)
              for _ in range(chains)]
        w = [((2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5).to(dtype)
             for _ in range(chains)]
        hs = [torch.empty(B, T, H, device="cuda", dtype=dtype) for _ in range(chains)]
        ref = [ls.lstm_scan_reference(x, ww) for x, ww in zip(xw, w)]
        ptrs = ([x.data_ptr() for x in xw] + [ww.data_ptr() for ww in w]
                + [h.data_ptr() for h in hs] + [None, None])
        code = ls._DTYPE_CODE[dtype]
        limit = 1e-4 if dtype == torch.float32 else 3e-2  # chip_smoke.py's LSTM_TOL
        rows = []
        for variant, lib in libs.items():
            call = (lambda lib=lib: lib.lstm_scan_bidir_launch(
                *ptrs, code, B, T, H, ls._PATH_CODE["wide"], M, C,
                torch.cuda.current_stream().cuda_stream))
            note = ""
            if variant not in WRONG_ON_PURPOSE:
                worst = 0.0
                for _ in range(STRESS):
                    for h in hs:
                        h.fill_(float("nan"))
                    check(call() == 0, f"{variant} at {name}: refused")
                    torch.cuda.synchronize()
                    err = max(float((h.float() - r.float()).abs().max())
                              for h, r in zip(hs, ref))
                    worst = max(worst, err if err == err else float("inf"))
                check(worst <= limit, f"{variant} at {name}: {worst} > {limit}")
                note = f", worst of {STRESS} checked launches {worst:.1e}"
            ms = graph_ms(call)
            rows.append(f"{variant} {ms:.4f} ms ({ms / T * 1e3:.3f} us a launch-step{note})")
        waves = -(-chains * -(-B // M) // ls._wide_counts(H, dtype, "cuda")[(M, C)])
        print(f"  {name} (B={B}, T={T}, {chains} chain(s)) {str(dtype)[6:]}, tile (M={M}, C={C}), "
              f"{waves} wave(s):\n    " + "\n    ".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
