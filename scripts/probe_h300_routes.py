"""The H = 300 recurrences' routes over B, and DPTNet's H = 256 wide kernels, on one CUDA card.

    PYTHONPATH=. python3 scripts/probe_h300_routes.py [--sweep] [--dptnet]

`--sweep`: `lstm_scan_bidir` and its backward at H = 300 (DANet's, ADANet's and deep
clustering's width), two chains, T = 101 (recipe training's 0.8 s at hop 64) and 501 (a
4 s utterance), B in BATCHES, float32 and bfloat16, on the three routes that can take it:
the FMA kernel at H = 300, the cluster kernel and the wide kernel on the call zero-padded to
384 (`ops/lstm_scan.py:cluster_width`), each on the tile the plan would force. The forward
writes hs alone (a request's) and, in float32, with cs (a training step's). Each kernel is
timed alone from CUDA graphs, in turns (FMA, cluster, wide, wide, cluster, FMA: the means
of each pair), and each output is held to the plain version at chip_smoke's limits. The
least B from which a route wins at every larger B of the sweep is what the plan's
`CLUSTER_MAX_BATCH_PADDED`, `CLUSTER_MAX_BATCH_BWD_PADDED`, `WIDE_MIN_BATCH[384]` and
`WIDE_MIN_BATCH_BWD[384]` encode.

`--dptnet`: the wide kernels at DPTNet's shapes (chip_smoke.py phase 13's, H = 256: the
forwards at serving's B = 8 x 4 s, the backwards at recipe training's B = 2 x 4 s) on the
plan's tiles, alone from CUDA graphs, each output held to the plain version's first steps.
It calls only what a tree without the H = 384 kernels has too, so a copy of this script in
an unpacked parent tree times the parent's kernels: run parent, this tree, this tree,
parent in one call to compare the H = 256 instantiation across a change.

Every line carries the card's name and power limit. Needs a CUDA card and nvcc; nothing
here runs on the main path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dnn_based_source_separation_torch.ops import lstm_scan as ls  # noqa: E402

H = 300
STEPS = (101, 501)
BATCHES = (1, 4, 16, 32, 64, 128)
ROUTES = ("fma", "cluster", "wide")
DPT_CHECK_STEPS = 8  # the plain version over each chain's first steps at DPTNet's shapes
OUT = os.path.join(ROOT, "chiprun_out")


def turns(calls: dict) -> dict:
    """{route: ms} of each launch call alone from CUDA graphs, in turns (the routes in order,
    then reversed; the mean of the two)."""
    order = list(calls) + list(reversed(calls))
    times = {r: [] for r in calls}
    for r in order:
        times[r].append(cs.graph_ms(calls[r], 1, iters=5))
    return {r: sum(v) / len(v) for r, v in times.items()}


def least_winner(rows, route):
    """The least B of the sweep from which `route` is the fastest route at every larger B
    and every T, or None."""
    wins = {(r["T"], r["B"]): min(r["ms"], key=r["ms"].get) == route for r in rows}
    for B in BATCHES:
        if all(wins[(T, b)] for T in STEPS for b in BATCHES if b >= B):
            return B
    return None


def forward_row(B, T, dtype, with_cs):
    inputs = cs.lstm_chains(B, T, H, 2, dtype, seed=B + T)
    plain = ls.lstm_forward_reference if with_cs else (
        lambda xw, w: (ls.lstm_scan_reference(xw, w), None))
    refs = [plain(xw, w) for xw, w in inputs]
    calls, tiles = {}, {}
    for route in ROUTES:
        tiles[route] = cs.plan(ls, B, 2, H, dtype, route)[1]
        hs, c, launch = ls._staged_forward(inputs, with_cs, route)
        launch()
        err, limit = cs.forward_error_of(refs, hs, c if with_cs else None, dtype)
        cs.check(err <= limit, f"forward {route} B={B} T={T} {dtype}: {err} > {limit}")
        calls[route] = launch
    return dict(B=B, T=T, dtype=str(dtype)[6:], cs=with_cs, plan=cs.plan(ls, B, 2, H, dtype)[0],
                tiles={r: cs.tile_label(t) for r, t in tiles.items()}, ms=turns(calls))


def backward_errors(staged, chains, refs, dtype):
    """[(max|kernel - plain|, limit)] of d_xw and d_W_hh of each chain of a staged backward,
    sliced back from a padded launch's arrays."""
    got = []
    for (h_prev, *_, das, d_xw), (_, w_hh, *_) in zip(staged, chains):
        got += [ls.unpad_gates(d_xw, H),
                ls.unpad_weight_grad(ls._weight_grad(h_prev, das, w_hh.dtype), H)]
    return cs.grad_errors("lstm_scan_bidir_bwd", got, [t for r in refs for t in r], dtype)


def backward_row(B, T, dtype):
    chains = cs.bwd_chains(B, T, H, 2, dtype, seed=B + T + 1)
    refs = [ls.lstm_scan_bwd_reference(*c) for c in chains]
    calls, tiles = {}, {}
    for route in ROUTES:
        tiles[route] = cs.plan_bwd(ls, B, 2, H, dtype, route)[1]
        staged, launch = ls._staged_backward(chains, route)
        launch()
        errs = backward_errors(staged, chains, refs, dtype)
        cs.check(all(x <= lim for x, lim in errs),
                 f"backward {route} B={B} T={T} {dtype}: {errs}")
        calls[route] = launch
    return dict(B=B, T=T, dtype=str(dtype)[6:], plan=cs.plan_bwd(ls, B, 2, H, dtype)[0],
                tiles={r: cs.tile_label(t) for r, t in tiles.items()}, ms=turns(calls))


def sweep(card):
    print(f"== H = {H}, two chains: the FMA kernel at {H} against the cluster and wide "
          f"kernels at {ls.cluster_width(H)} (padded), kernels alone from CUDA graphs in turns "
          f"[{card}]", flush=True)
    print(f"  co-resident clusters at {ls.cluster_width(H)}: cluster "
          f"{ls._cluster_counts(ls.cluster_width(H), 'cuda')}, cluster backward "
          f"{ls._cluster_bwd_counts(ls.cluster_width(H), 'cuda')}, wide "
          + ", ".join(f"{str(d)[6:]} {ls._wide_counts(ls.cluster_width(H), d, 'cuda')} / "
                      f"backward {ls._wide_counts(ls.cluster_width(H), d, 'cuda', True)}"
                      for d in (torch.float32, torch.bfloat16)), flush=True)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        for what in ("forward", "forward with cs", "backward"):
            if what == "forward with cs" and dtype != torch.float32:
                continue
            rows = []
            for T in STEPS:
                for B in BATCHES:
                    row = (backward_row(B, T, dtype) if what == "backward" else
                           forward_row(B, T, dtype, what == "forward with cs"))
                    rows.append(row)
                    print(f"  {what} {row['dtype']} T={T} B={B}: "
                          + ", ".join(f"{r} ({row['tiles'][r]}) {ms:.4f} ms"
                                      for r, ms in row["ms"].items())
                          + f"; the plan takes {row['plan']} [{card}]", flush=True)
            wide_from = least_winner(rows, "wide")
            last_cluster = max((r["B"] for r in rows if all(
                x["ms"]["cluster"] < x["ms"]["fma"] for x in rows
                if x["B"] <= r["B"])), default=None)
            print(f"  {what} {str(dtype)[6:]}: the wide kernel fastest from B = {wide_from} "
                  f"of the sweep on; the cluster kernel under the FMA kernel at every B up to "
                  f"{last_cluster} (both T)", flush=True)
            result[f"{what} {str(dtype)[6:]}"] = dict(rows=rows, wide_from=wide_from,
                                                      cluster_up_to=last_cluster)
    return result


def dptnet(card):
    """The H = 256 wide kernels at DPTNet's shapes, alone from CUDA graphs -> {label: ms}."""
    print(f"== DPTNet's wide kernels at H = 256 (kernels alone from CUDA graphs) [{card}]",
          flush=True)
    shapes = [(label, B, T, chains, dtype, training) for label, (B, T, chains), dtypes, training
              in cs.DPT_SHAPES for dtype in dtypes]
    shapes += [("train intra", 1278, 100, 2, torch.bfloat16, True)]
    result = {}
    for label, B, T, chains, dtype, training in shapes:
        what = f"{label} (B={B}, T={T}, chains={chains}) {str(dtype)[6:]}"
        inputs = cs.lstm_chains(B, T, 256, chains, dtype, seed=B + T)
        path, tile = cs.plan(ls, B, chains, 256, dtype)
        if path == "wide" and not (training and dtype == torch.bfloat16):
            hs, _, launch = ls._staged_forward(inputs, False, "wide", tile=tile)
            launch()
            refs = [(ls.lstm_scan_reference(xw[:, :DPT_CHECK_STEPS], w), None)
                    for xw, w in inputs]
            err, limit = cs.forward_error_of(refs, [h[:, :DPT_CHECK_STEPS] for h in hs], None,
                                             dtype)
            cs.check(err <= limit, f"{what} forward: {err} > {limit}")
            ms = cs.graph_ms(launch, 1, iters=5)
            result[f"forward {what}"] = ms
            print(f"  forward {what} wide ({cs.tile_label(tile)}): {ms:.4f} ms [{card}]",
                  flush=True)
        if not training:
            continue
        path, tile = cs.plan_bwd(ls, B, chains, 256, dtype)
        if path != "wide":
            continue
        chains_b = cs.bwd_chains(B, T, 256, chains, dtype, seed=B + T)
        staged, launch = ls._staged_backward(chains_b, "wide", tile=tile)
        launch()
        short = [tuple(t[:, T - DPT_CHECK_STEPS:] if t.dim() == 3 else t for t in c)
                 for c in chains_b]
        # The reverse recurrence's last steps depend on those steps alone, but for the first
        # of them, which reads the step before (h_prev, c_prev): hold the others.
        refs = [ls.lstm_scan_bwd_reference(*c)[0][:, 1:] for c in short]
        for (*_, das, d_xw), ref in zip(staged, refs):
            got = d_xw[:, T - DPT_CHECK_STEPS + 1:]
            err = float((got.float() - ref.float()).abs().max())
            limit = cs.bwd_limit(dtype, float(ref.float().abs().max()))
            cs.check(err <= limit, f"{what} backward: {err} > {limit}")
        ms = cs.graph_ms(launch, 1, iters=5)
        result[f"backward {what}"] = ms
        print(f"  backward {what} wide ({cs.tile_label(tile)}): {ms:.4f} ms [{card}]",
              flush=True)
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--dptnet", action="store_true")
    parser.add_argument("--tag", default="tree", help="names this run's JSON in chiprun_out/")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    ls.build()
    ls.build_backward()
    out = {"card": card}
    if args.dptnet:
        out["dptnet"] = dptnet(card)
    if args.sweep:
        out["sweep"] = sweep(card)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"probe_h300_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
