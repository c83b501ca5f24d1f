#!/usr/bin/env python3
"""The control of a cell's comparison: the program's own lower-precision
path, judged as a run is judged.

    python3 portbench/control.py --workload hubbard_stack_1x1 \\
        --seeds 101 102 103 [--device cuda]

Builds the cell's solver as a run does, with the configuration's dtype one
step down (float64 -> float32: complex64 for a complex operator), solves
once from each seed's first draws, judges each solve's pairs against the
float64 reference (``reference/check.py``) and prints one JSON line a
seed with each number compared and its limit. Every line must read at
least one number over its limit: the comparison has to fail the lower
precision. The limits were set between these readings and the largest the
program's sound runs give (PERF.md). A solve that cannot reach the
tolerance in the lower precision runs to ``max_iters`` and returns its
best pairs; one that raises has failed and gives no number.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOWER = {"float64": "float32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench.drivers import fd_solve
    from portbench.harness import spec
    from portbench.reference import check

    cell = spec.cell(spec.load_benchmark(), args.workload)
    config = cell["config"]
    lower = dict(config, fd=dict(config["fd"],
                                 dtype=LOWER[config["fd"]["dtype"]]))
    fd = fd_solve.build(lower, cell["traffic"], torch.device(args.device))
    A = check.operator(config)
    lam = check.reference_eigenvalues(config, A, int(config["reference_k"]))
    failed_all = True
    for seed in args.seeds:
        _, solves, results = fd_solve.window(fd, seed, 0.0, False)
        v = check.judge(A, lam, results, int(config["fd"]["n_target"]),
                        float(config["fd"]["target"]))
        over = [k for k in check.NUMBERS if v[k] > config["limits"][k]]
        fails = bool(over) or v["failed"] > 0
        failed_all &= fails
        print(json.dumps(dict(
            workload=args.workload, seed=seed, dtype=lower["fd"]["dtype"],
            iterations=solves[0]["iterations"] if solves else None,
            failed=v["failed"], over_limit=over, fails=fails,
            compared={k: dict(value=v[k], limit=config["limits"][k])
                      for k in check.NUMBERS})), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
