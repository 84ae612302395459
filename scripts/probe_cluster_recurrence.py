"""Where a step of the LSTM forward's cluster kernel goes, on one CUDA card.

    python3 scripts/probe_cluster_recurrence.py

At musdb18 serving's shapes (UMX: a 10 s chunk, B = 1, T = 431; H = 256 on two
chains, on clusters of 8 and of 16 blocks, and H = 512 on one chain, 16
blocks), f32, copies of `csrc/` with one edit each to
`csrc/recurrence_cluster.cuh` are built side by side into the git-ignored
build directory and timed from CUDA graphs, each beside its serial floor
(the same kernel with the product compiled out):

- "as built": h sent with st.async, each rank waiting on its own mbarrier;
- "cluster barrier": h stored with st.shared::cluster and published by one
  barrier.cluster arrive / wait a step, the exchange the mbarriers replaced;
- two diagnostics whose outputs are wrong on purpose: "no cell" (the gates
  summed instead of the LSTM cell) and "no exchange" (no sends and no waits:
  every rank reads the zeros of its own h). What each removes is what that
  part of a step costs.

Each variant meant to be right is launched STRESS times with every output
checked against the plain version, since a race shows only in some launches.

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
    ("UMX", 1, 431, 256, 2, 8),
    ("UMX", 1, 431, 256, 2, 16),
    ("causal UMX", 1, 431, 512, 1, 16),
]
HEADER = "recurrence_cluster.cuh"
WAIT = """    if (tid == 0 && t + 1 < T_len) mbar_expect(mbar + next_mbar, 4u * (unsigned)H);
    if (t > 0) mbar_wait(mbar + 8u * (unsigned)(t & 1), (unsigned)((t - 1) >> 1) & 1u);
"""
SEND = """    if (p < C && t + 1 < T_len) st_async_f32(peer + next, rounded(h, whh), peer_mbar + next_mbar);
    if (p == 0) {
      const long long o = (b * T_len + t) * H + unit;
      store(hs + o, h);
      if (cs != nullptr) store(cs + o, c);
    }
"""
BARRIER = [(HEADER, WAIT, ""), (HEADER, SEND, """    if (p < C)
      asm volatile("st.shared::cluster.f32 [%0], %1;\\n" ::"r"(peer + next), "f"(rounded(h, whh))
                   : "memory");
    tf32_scan::cluster_arrive();
    if (p == 0) {
      const long long o = (b * T_len + t) * H + unit;
      store(hs + o, h);
      if (cs != nullptr) store(cs + o, c);
    }
    tf32_scan::cluster_wait();
""")]
NO_CELL = [(HEADER, """    c = sigmoid(gf) * c + sigmoid(gi) * tanhf(gg);
    const float h = sigmoid(go) * tanhf(c);""", """    c = 1e-3f * (gf + gi + gg);
    const float h = 1e-3f * go + c;""")]
NO_EXCHANGE = [(HEADER, WAIT, ""), (HEADER, SEND, """    if (p == 0) {
      const long long o = (b * T_len + t) * H + unit;
      store(hs + o, h);
      if (cs != nullptr) store(cs + o, c);
    }
""")]
VARIANTS = {"as built": [], "cluster barrier": BARRIER, "no cell": NO_CELL,
            "no exchange": NO_EXCHANGE}
WRONG_ON_PURPOSE = {"no cell", "no exchange"}
STRESS = 50  # checked launches of each variant meant to be right, at each shape
REPEATS = 5  # launches in a timed CUDA graph


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
    """The one- and two-chain launches and the serial floor of a lstm_scan library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_launch.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.lstm_scan_bidir_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.lstm_scan_cluster_floor_launch.argtypes = [p] * 6 + [i] * 5 + [p]
    for fn in (lib.lstm_scan_launch, lib.lstm_scan_bidir_launch,
               lib.lstm_scan_cluster_floor_launch):
        fn.restype = i
    return lib


def build_variant(directory):
    library = directory / "lstm_scan.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(library),
                           str(directory / "lstm_scan.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {directory}:\n{proc.stderr[-3000:]}")
    return bind(ctypes.CDLL(str(library)))


def stream():
    return torch.cuda.current_stream().cuda_stream


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cluster_recurrence: needs a CUDA card", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    root = _build.BUILD_DIR / "cluster_variants"
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
    counts = {H: ls._cluster_counts(H, "cuda") for H in {s[3] for s in SHAPES}}
    print(f"co-resident clusters by H: {counts}")
    print(f"== ms per launch and per step, f32, CUDA graphs of {REPEATS} launches, medians of "
          f"20 [{card}]")
    for name, B, T, H, chains, C in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(T + H)
        xw = [0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen) for _ in range(chains)]
        w = [(2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5
             for _ in range(chains)]
        hs = [torch.empty(B, T, H, device="cuda") for _ in range(chains)]
        ref = [ls.lstm_scan_reference(x, ww) for x, ww in zip(xw, w)]
        ptrs = [t.data_ptr() for t in (*xw, *w, *hs)] + [None] * chains
        pad = [None] * (2 - chains)
        floor_ptrs = ([x.data_ptr() for x in xw] + pad + [ww.data_ptr() for ww in w] + pad
                      + [h.data_ptr() for h in hs] + pad)
        rows = []
        for variant, lib in libs.items():
            fn = lib.lstm_scan_bidir_launch if chains == 2 else lib.lstm_scan_launch
            call = lambda fn=fn: fn(*ptrs, 0, B, T, H, 4, 1, C, stream())
            floor = lambda lib=lib: lib.lstm_scan_cluster_floor_launch(*floor_ptrs, 0, B, T, H,
                                                                       C, stream())
            note = ""
            if variant not in WRONG_ON_PURPOSE:
                bad, worst = 0, 0.0
                for _ in range(STRESS):
                    for h in hs:
                        h.fill_(float("nan"))
                    err = call()
                    check(err == 0, f"{variant} at {name} C={C}: cudaError {err}")
                    torch.cuda.synchronize()
                    err = max(float((h - r).abs().max()) for h, r in zip(hs, ref))
                    err = err if err == err else float("inf")
                    worst = max(worst, err)
                    bad += err > 1e-4
                check(not bad, f"{variant} at {name} C={C}: {bad} of {STRESS} launches off")
                note = f", worst of {STRESS} checked launches {worst:.1e}"
            ms, floor_ms = graph_ms(call), graph_ms(floor)
            rows.append(f"{variant} {ms:.4f} ms ({ms / T * 1e3:.3f} us a step; floor "
                        f"{floor_ms:.4f} ms, {floor_ms / T * 1e3:.3f} us{note})")
        print(f"  {name} (B={B}, T={T}, H={H}, {chains} chain(s), C={C}):\n    "
              + "\n    ".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
