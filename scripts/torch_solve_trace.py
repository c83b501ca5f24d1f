#!/usr/bin/env python3
"""Trace one solve of the port iteration by iteration, with a time cap.

    python3 scripts/torch_solve_trace.py --family RoadNet \\
        --params n=48000,w=2,m=1200,k=4 --n-search 64 --n-target 16 \\
        --target 0 [--dtype float64] [--cap-s 150] [--device cuda]

Runs ``FilterDiag`` (kernels on, stack layout, tol 1e-10) one outer
iteration at a time and prints one JSON line an iteration: its number,
converged count, filter degree, search interval, best residual and wall
seconds (ending in a device synchronisation). It stops when the solve is
done or the cap is passed, and prints the launches of each kernel and the
card's name and power limit. For finding how a family's degrees and
iterations grow before sizing a cell (``chip_smoke.py`` runs the cells).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", required=True)
    ap.add_argument("--params", default="")
    ap.add_argument("--n-search", type=int, default=64)
    ap.add_argument("--n-target", type=int, default=16)
    ap.add_argument("--target", type=float, default=0.0)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--max-iters", type=int, default=1000)
    ap.add_argument("--cap-s", type=float, default=150.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core import FDConfig, FilterDiag
    from repro_torch.kernels import build
    from repro_torch.launch.solve import parse_params
    from repro_torch.matrices import get_family

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    cfg = FDConfig(n_target=args.n_target, n_search=args.n_search,
                   target=args.target, tol=1e-10, max_iters=args.max_iters,
                   layout="stack", spmv_kernel=True, dtype=args.dtype)
    fd = FilterDiag(get_family(args.family, **parse_params(args.params)), cfg,
                    device=args.device)
    build.reset_launches()
    t0 = time.perf_counter()
    state = fd.init_state()
    sync()
    print(json.dumps(dict(lanczos=state.lam,
                          s=time.perf_counter() - t0)), flush=True)
    while not state.done and time.perf_counter() - t0 < args.cap_s:
        t1 = time.perf_counter()
        state = fd.step(state)
        sync()
        h = state.history[-1]
        print(json.dumps(dict(it=h["iter"], n_conv=h["n_conv"],
                              degree=h.get("degree"), search=h["search"],
                              best_res=h["best_res"],
                              s=time.perf_counter() - t1)), flush=True)
    print(json.dumps(dict(done=state.done, wall_s=time.perf_counter() - t0,
                          launches=dict(build.launches))), flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
