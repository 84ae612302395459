"""Where a step of the LSTM backward's cluster kernel goes, on one CUDA card.

    python3 scripts/probe_cluster_bwd.py

At musdb18 training's shape (UMX / X-UMX: B = 16 x 6 s, T = 259, H = 256 on two
chains, on clusters of 8 and of 16 blocks), at one sequence (B = 1) and at
H = 512 on one chain, f32, copies of `csrc/` with one edit each to
`csrc/recurrence_cluster_bwd.cuh` are built side by side into the git-ignored
build directory and timed from CUDA graphs, each beside its serial floor (the
same kernel with the product compiled out):

- "as built": each unit's four gate derivatives sent to every rank as one
  16-byte st.async, each rank waiting on its own mbarrier for 16 H bytes;
- diagnostics whose outputs are wrong on purpose: "4-byte exchange" (one float
  a unit sent, 4 H bytes awaited: the bytes a reduce-scatter of partial dh_rec
  would exchange, in as many messages), "no exchange" (no sends and no waits:
  every rank reads the zeros of its own da), "no cell" (the cell derivative
  made linear) and "no stores" (das and d_xw not written). What each removes
  is what that part of a step costs.

"as built" is launched STRESS times at each shape with every output checked
against lstm_scan_bwd_reference, since a race shows only in some launches.

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

SHAPES = [  # name, B, T, H, chains, C
    ("UMX train", 16, 259, 256, 2, 8),
    ("UMX train", 16, 259, 256, 2, 16),
    ("one sequence", 1, 259, 256, 2, 16),
    ("H=512", 16, 259, 512, 1, 16),
]
HEADER = "recurrence_cluster_bwd.cuh"
EXPECT = "cluster_scan::mbar_expect(mbar + next_mbar, 16u * (unsigned)H);"
WAIT = """    if (s > 0)
      cluster_scan::mbar_wait(mbar + 8u * (unsigned)(s & 1), (unsigned)((s - 1) >> 1) & 1u);
"""
SEND = ("    if (p < C && s + 1 < T_len) cluster_scan::st_async_v4(peer + next, da, "
        "peer_mbar + next_mbar);\n")
CELL = """    const float gi = cluster_scan::sigmoid(cur.a[0]);
    const float gf = cluster_scan::sigmoid(cur.a[1]);
    const float gg = tanhf(cur.a[2]);
    const float go = cluster_scan::sigmoid(cur.a[3]);
    const float tc = tanhf(cur.c);
    const float dh = cur.g + dh_rec;
    const float dc = dc_rec + dh * go * (1.f - tc * tc);
    const float4 da = make_float4(dc * gg * gi * (1.f - gi), dc * cur.cp * gf * (1.f - gf),
                                  dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go));
    dc_rec = dc * gf;
"""
STORES = """    if (p < 4) {
      const float v = p == 0 ? da.x : p == 1 ? da.y : p == 2 ? da.z : da.w;
      const long long o = (b * T_len + t) * G4 + (long long)p * H + unit;
      das[o] = v;
      if (d_xw != nullptr) cluster_scan::store(d_xw + o, v);
    }
"""
VARIANTS = {
    "as built": [],
    "4-byte exchange": [
        (EXPECT, EXPECT.replace("16u", "4u")),
        (SEND, "    if (p < C && s + 1 < T_len) cluster_scan::st_async_f32(peer + next, da.x, "
               "peer_mbar + next_mbar);\n")],
    "no exchange": [(EXPECT, ";"), (WAIT, ""), (SEND, "")],
    "no cell": [(CELL, """    const float dh = cur.g + dh_rec;
    const float dc = dc_rec + dh * cur.a[3];
    const float4 da = make_float4(1e-3f * dc, 1e-3f * cur.a[0] * cur.cp, 1e-3f * cur.a[1],
                                  1e-3f * cur.a[2] + dh);
    dc_rec = 0.5f * dc * cur.c;
""")],
    "no stores": [(STORES, "")],
}
STRESS = 20  # checked launches of "as built" at each shape
REPEATS = 5  # launches in a timed CUDA graph
TOL = 1e-4  # relative to max|plain|: the recurrent sums run in another order


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def graph_ms(call, repeats=REPEATS, iters=20):
    """ms of one call() on the card alone: `repeats` calls captured in one CUDA graph,
    the median of `iters` replays (CUDA events) over `repeats`."""
    err = call()
    check(err == 0, f"a launch was refused: cudaError {err}")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
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
    return sorted(times)[len(times) // 2] / repeats


def bind(lib):
    """The one- and two-chain backward launches and the serial floor of a library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_bwd_launch.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.lstm_scan_bidir_bwd_launch.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.lstm_scan_bwd_cluster_floor_launch.argtypes = [p] * 12 + [i] * 5 + [p]
    for fn in (lib.lstm_scan_bwd_launch, lib.lstm_scan_bidir_bwd_launch,
               lib.lstm_scan_bwd_cluster_floor_launch):
        fn.restype = i
    return lib


def build_variant(directory):
    library = directory / "lstm_scan_bwd.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(library),
                           str(directory / "lstm_scan_bwd.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory}:\n{proc.stderr[-3000:]}")
    return bind(ctypes.CDLL(str(library)))


def stream():
    return torch.cuda.current_stream().cuda_stream


def inputs(B, T, H, chains):
    """Per chain (gates, cs, g_hs, W_hh, das) on the card and the plain das."""
    gen = torch.Generator(device="cuda").manual_seed(B + T + H)
    out = []
    for _ in range(chains):
        xw = 0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen)
        w = (2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5
        hs, cs, g = (torch.randn(B, T, H, device="cuda", generator=gen) for _ in range(3))
        hs = torch.tanh(hs)
        gates = ls._staged_gates(xw, w, ls._shifted(hs))
        das = torch.empty(B, T, 4 * H, device="cuda")
        out.append(((gates, cs, g, w, das), ls.lstm_scan_bwd_reference(xw, w, hs, cs, g)[0]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cluster_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    root = _build.BUILD_DIR / "cluster_bwd_variants"
    shutil.rmtree(root, ignore_errors=True)
    for variant, edits in VARIANTS.items():
        directory = root / variant.replace(" ", "_")
        shutil.copytree(_build.CSRC_DIR, directory)
        text = (directory / HEADER).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {variant!r}: the edit of {HEADER} no longer applies")
            text = text.replace(old, new)
        (directory / HEADER).write_text(text)
    start = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {v: pool.submit(build_variant, root / v.replace(" ", "_")) for v in VARIANTS}
        libs = {v: job.result() for v, job in jobs.items()}
    print(f"built {len(libs)} variant libraries in {time.perf_counter() - start:.1f} s")
    print(f"co-resident clusters by H: "
          f"{ {H: ls._cluster_bwd_counts(H, 'cuda') for H in sorted({s[3] for s in SHAPES})} }")
    print(f"== ms per launch, f32, the kernel alone, CUDA graphs of {REPEATS} launches, medians "
          f"of 20 [{card}]")
    for name, B, T, H, chains, C in SHAPES:
        data = inputs(B, T, H, chains)
        arrays = [a for a, _ in data]
        # gates, cs, g_hs, W, das of each chain in turn, then d_xw (none in f32).
        ptrs = [arrays[c][k].data_ptr() for k in range(5) for c in range(chains)]
        ptrs += [None] * chains
        floor_ptrs = [None] * 12
        for k in range(5):
            for c in range(chains):
                floor_ptrs[2 * k + c] = arrays[c][k].data_ptr()
        waves = -(-chains * B // ls._cluster_bwd_counts(H, "cuda")[C])
        rows = []
        for variant, lib in libs.items():
            fn = lib.lstm_scan_bidir_bwd_launch if chains == 2 else lib.lstm_scan_bwd_launch
            call = lambda fn=fn: fn(*ptrs, 0, B, T, H, 4, 1, C, stream())
            floor = lambda lib=lib: lib.lstm_scan_bwd_cluster_floor_launch(*floor_ptrs, 0, B, T,
                                                                           H, C, stream())
            note = ""
            if variant == "as built":
                worst = 0.0
                for _ in range(STRESS):
                    for a in arrays:
                        a[4].fill_(float("nan"))
                    err = call()
                    check(err == 0, f"{variant} at {name} C={C}: cudaError {err}")
                    torch.cuda.synchronize()
                    err = max(float((a[4] - ref).abs().max() / ref.abs().max())
                              for a, (_, ref) in zip(arrays, data))
                    worst = max(worst, err if err == err else float("inf"))
                check(worst <= TOL, f"{variant} at {name} C={C}: {worst} of max|plain| off")
                note = f", worst of {STRESS} checked launches {worst:.1e} of max|plain|"
            ms, floor_ms = graph_ms(call), graph_ms(floor)
            step = 1e3 / (T * waves)
            rows.append(f"{variant} {ms:.4f} ms ({ms * step:.3f} us a step of a wave; floor "
                        f"{floor_ms:.4f} ms, {floor_ms * step:.3f} us{note})")
        print(f"  {name} (B={B}, T={T}, H={H}, {chains} chain(s), C={C}, {waves} wave(s)):\n    "
              + "\n    ".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
