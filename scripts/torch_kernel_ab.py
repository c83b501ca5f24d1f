#!/usr/bin/env python3
"""Time the port's main-path kernels of two checkouts on one card, in turns.

    python3 scripts/torch_kernel_ab.py --other PATH [--other PATH2 ...]
        [--order BAAB] [--out F]

Each ``PATH`` is the root of another checkout of the repository (for
example the parent commit, unpacked with ``git archive``): B, C, ... in
the order given, A being this checkout. Each turn runs in a
subprocess of its own, which imports ``repro_torch`` from one checkout's
``src`` (building its kernels there), builds the Hubbard(12,6, U = 25,
ranpot = 1) operator in fp64 and times, with CUDA events after a warm-up:

* ``step``: one fused Chebyshev step at n_b = 512 as that checkout's filter
  runs it (its ``make_fused_cheb_step``);
* ``filter``: ``chebyshev_filter`` of degree 40 at n_b = 512, per step;
* ``spmv512`` / ``spmv1``: ``make_spmv`` with the kernels on, n_b = 512, 1;
* ``p8_step``: the RoadNet(48000) fused step at n_b = 64 over 8 row
  shards through the compressed-cyclic split-phase engine (kernels on),
  the launch- and host-bound step of the 8-shard solves, with no
  ``CommTrace`` attached; ``p8_step_traced`` the same with one attached
  (cleared after each step), where the checkout has ``CommTrace``;
* ``p8_sstep``: a degree-9 s = 3 filter on the same operator and block
  through the compressed-cyclic split-phase s-step groups (three groups,
  kernels on), per filter, with no ``CommTrace`` attached, and
  ``p8_sstep_traced`` with one attached, as above.

Turns go in the order given, so that a drift of the card shows as a
difference between two turns of one checkout. One JSON line per turn,
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, SRC)
from repro_torch.core import (build_dist_ell, build_sstep_ell,
                              chebyshev_filter, make_fused_cheb_step,
                              make_spmv, make_sstep_cheb)
from repro_torch.matrices import Hubbard, RoadNet

def ms(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

torch.backends.cuda.matmul.allow_tf32 = False
ell = build_dist_ell(Hubbard(12, 6, U=25.0, ranpot=1.0), 1, dtype="float64",
                     device="cuda")
g = torch.Generator(device="cuda").manual_seed(7)
x, w2 = (torch.randn((ell.R, 512), generator=g, device="cuda",
                     dtype=torch.float64) for _ in range(2))
step = make_fused_cheb_step(ell, use_kernel=True)
spmv = make_spmv(ell, use_kernel=True)
out = dict(src=SRC)
out["step"] = ms(lambda: step(x, w2, 0.013, -0.4), 10)
mu = np.random.default_rng(0).standard_normal(41) * 1e-3
t = ms(lambda: chebyshev_filter(spmv, mu, 0.013, -0.4, x, fused_step=step), 1)
out["filter"] = t / 39
out["spmv512"] = ms(lambda: spmv(x), 10)
x1 = x[:, :1].contiguous()
out["spmv1"] = ms(lambda: spmv(x1), 50)
del ell, step, spmv, x, w2, x1
rn = build_dist_ell(RoadNet(n=48000, w=2, m=1200, k=4), 8, dtype="float64",
                    split_halo=True, device="cuda")
xr, wr = (torch.randn((rn.D_pad, 64), generator=g, device="cuda",
                      dtype=torch.float64) for _ in range(2))
p8 = make_fused_cheb_step(rn, use_kernel=True, overlap=True,
                          comm="compressed", pipeline=False)
out["p8_step"] = ms(lambda: p8(xr, wr, 0.013, -0.4), 200)
sell = build_sstep_ell(RoadNet(n=48000, w=2, m=1200, k=4), 8, 3,
                       dtype="float64", d_pad=rn.D_pad, split_halo=True,
                       device="cuda")
ss = make_sstep_cheb(sell, use_kernel=True, overlap=True, comm="compressed",
                     schedule="cyclic")
mu9 = np.linspace(1.0, 0.5, 10)
out["p8_sstep"] = ms(lambda: ss(xr, mu9, 0.013, -0.4), 50)
try:
    from repro_torch.core.shards import CommTrace
except ImportError:
    CommTrace = None
if CommTrace is not None:
    for key, fn, group, reps in (
            ("p8_step", lambda: p8(xr, wr, 0.013, -0.4), p8.group, 200),
            ("p8_sstep", lambda: ss(xr, mu9, 0.013, -0.4), ss.group, 50)):
        trace = CommTrace().attach(group)

        def traced():
            fn()
            trace.clear()

        out[key + "_traced"] = ms(traced, reps)
        CommTrace.detach(group)
print(json.dumps(out), flush=True)
"""


def turn(root: str) -> dict:
    src = os.path.join(os.path.abspath(root), "src")
    res = subprocess.run([sys.executable, "-c", f"SRC = {src!r}\n" + TURN],
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise SystemExit(f"turn in {root} failed:\n{res.stdout}{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of another checkout (B, then C, ...)")
    ap.add_argument("--order", default="BAAB",
                    help="turns, A = this checkout, B, C, ... the others")
    ap.add_argument("--out", default=None, help="also write the turns here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the A/B run needs one card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    roots = {"A": HERE}
    roots.update({chr(ord("B") + k): p for k, p in enumerate(args.other)})
    turns = []
    for k in args.order:
        rec = dict(turn=k, **turn(roots[k]))
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, turns=turns), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
