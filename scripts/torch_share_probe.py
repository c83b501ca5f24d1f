#!/usr/bin/env python3
"""What a step costs when several processes share one card: the probe
behind the ranks phase of ``chip_smoke.py`` (gloo ranks on one card).

    python3 scripts/torch_share_probe.py

Each line is one measurement, the processes started with ``spawn``:

1. sync — a device round trip of the rank transport's staging
   (``index_select`` of 1,200 rows × 64 fp64, a copy to pinned host
   memory, which waits for the card, and a queued copy back), ms an
   iteration over 400, in 1 and in 4 processes on the card, with CUDA's
   default (spinning) and with its blocking sync;
2. heavy — bandwidth-bound elementwise kernels on [63,504 × 128] fp64
   blocks: 800 iterations in one process against 200 in each of 4
   processes on the card, seconds;
3. gloo — ``all_to_all_single`` of 76,800 fp64 a rank (614 kB, three
   quarters of it to the other ranks) among 4 CPU processes over a
   ``file://`` store, ms a call over 300: the host's loopback TCP.

Needs a CUDA device for 1 and 2; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import time

import torch
import torch.multiprocessing as mp

BLOCKING_SYNC = 4  # cudaDeviceScheduleBlockingSync


def sync_loop(rank, blocking, q):
    if blocking:  # before the process's first CUDA call
        ctypes.CDLL("libcudart.so.12").cudaSetDeviceFlags(BLOCKING_SYNC)
    torch.cuda.set_device(0)
    x = torch.randn(12000, 64, device="cuda", dtype=torch.float64)
    idx = torch.randint(0, 12000, (1200,), device="cuda")
    h = torch.empty(1200, 64, dtype=torch.float64, pin_memory=True)
    for _ in range(2):  # the second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(400):
            h.copy_(x.index_select(0, idx))
            x[:1200].copy_(h, non_blocking=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 400 * 1e3
    q.put(ms)


def heavy(rank, reps, q):
    torch.cuda.set_device(0)
    a = torch.randn(63504, 128, device="cuda", dtype=torch.float64)
    b = torch.randn(63504, 128, device="cuda", dtype=torch.float64)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            b.add_(a * 0.5 + b * 0.25 - a, alpha=1e-3)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    q.put(s)


def gloo_a2a(rank, store, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=4)
    x = torch.zeros(76800, dtype=torch.float64)
    y = torch.empty_like(x)
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(300):
            dist.all_to_all_single(y, x)
        ms = (time.perf_counter() - t0) / 300 * 1e3
    q.put(ms)
    dist.destroy_process_group()


def run(fn, n, *args) -> list:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=fn, args=(r,) + args + (q,))
             for r in range(n)]
    for p in procs:
        p.start()
    out = sorted(q.get() for _ in procs)
    for p in procs:
        p.join()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for n in (1, 4):
        for blocking in (0, 1):
            ms = run(sync_loop, n, blocking)
            print(f"sync: {n} process(es), {'blocking' if blocking else 'spin'}"
                  f" sync: {', '.join(f'{v:.4f}' for v in ms)} ms an "
                  "iteration", flush=True)
    one = run(heavy, 1, 800)
    four = run(heavy, 4, 200)
    print(f"heavy: 1 process x 800 {one[0]:.4f} s; 4 processes x 200 "
          f"{', '.join(f'{v:.4f}' for v in four)} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ms = run(gloo_a2a, 4, os.path.join(tmp, "store"))
    print(f"gloo: all_to_all_single of 614 kB a rank among 4 CPU processes: "
          f"{', '.join(f'{v:.3f}' for v in ms)} ms a call", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
