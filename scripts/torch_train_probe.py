#!/usr/bin/env python3
"""Probes of the LM training path on one card (``repro_torch.models.steps``
and ``repro_torch.optim``).

    python3 scripts/torch_train_probe.py [--out PROBE.json]

1. qwen: qwen3-0.6b at full width and depth in bf16 with fp32 moments,
   B = 2 × 512 tokens of ``TokenPipeline``: a step split into the loss's
   forward and backward and the AdamW update (CUDA events), the host's ms
   to enqueue a step and to finish it, and from ``torch.profiler`` over
   one step its kernel launches and device ms;
2. granite: granite-moe-3b-a800m at full width and depth in bf16 with
   int8 moments, the same batch shape: the update of its large leaves
   taken a few layers at a time (``adamw.UPDATE_CHUNK``, the default)
   against whole stacked leaves, in turns (chunk, whole, whole, chunk),
   each a warm step and two timed ones, with its peak device memory.

Needs a CUDA device; TF32 is off throughout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEQ, BATCH = 512, 2


def split_step(cfg, ocfg, model, state, batch):
    """One train step as ``make_train_step`` takes it, with CUDA events
    between its parts: returns (state, loss, forward + backward ms, update
    ms, host ms to enqueue, host ms to finish)."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.steps import grad_tree, param_tree
    from repro_torch.optim import adamw

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    model.zero_grad(set_to_none=True)
    loss, _ = tfm.loss_fn(model, cfg, batch)
    loss.backward()
    ev[1].record()
    params = param_tree(model)
    state, _ = adamw.apply_updates(ocfg, params, grad_tree(params), state)
    ev[2].record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (state, float(loss.detach()), ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]), 1e3 * (t1 - t0), 1e3 * (t2 - t0))


def probe_qwen(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import adamw

    cfg = get_config("qwen3-0.6b")
    ocfg = adamw.AdamWConfig(moment_dtype=cfg.optimizer_dtype, lr=3e-3,
                             warmup_steps=10, total_steps=10)
    model, state = init_train_state(
        cfg, ocfg, torch.Generator(device=dev).manual_seed(0), dev)
    pipe = TokenPipeline(cfg, device=dev)
    batches = [pipe.batch(i, BATCH, SEQ) for i in range(6)]
    for b in batches[:2]:  # warm
        state = split_step(cfg, ocfg, model, state, b)[0]
    rows = []
    for b in batches[2:5]:
        state, *r = split_step(cfg, ocfg, model, state, b)
        rows.append(r[1:])
    step = make_train_step(cfg, ocfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model, state, _ = step(model, state, batches[5])
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel",
                                                      "cuLaunchKernelEx"))
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type is not None
                    and str(e.device_type).endswith("CUDA"))
    fb, upd, enq, fin = (min(r[i] for r in rows) for i in range(4))
    out = dict(fwd_bwd_ms=fb, update_ms=upd, enqueue_ms=enq, finish_ms=fin,
               launches=launches, device_ms=device_us / 1e3,
               steps=[dict(zip(("fwd_bwd_ms", "update_ms", "enqueue_ms",
                                "finish_ms"), r)) for r in rows])
    print(f"[qwen] qwen3-0.6b bf16, fp32 moments, B = {BATCH} x {SEQ}: "
          f"forward + backward {fb:.3f} ms, update {upd:.3f} ms (min of 3); "
          f"host {enq:.3f} ms to enqueue a step, {fin:.3f} to finish; "
          f"{launches} launches and {out['device_ms']:.3f} device ms a step "
          "(profiler)", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return out


def probe_granite(dev) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.steps import init_train_state
    from repro_torch.optim import adamw

    cfg = get_config("granite-moe-3b-a800m")
    ocfg = adamw.AdamWConfig(moment_dtype="int8")
    model, state = init_train_state(
        cfg, ocfg, torch.Generator(device=dev).manual_seed(0), dev)
    pipe = TokenPipeline(cfg, device=dev)
    batches = [pipe.batch(i, BATCH, SEQ) for i in range(3)]
    default = adamw.UPDATE_CHUNK
    out = []
    for name in ("chunk", "whole", "whole", "chunk"):
        adamw.UPDATE_CHUNK = default if name == "chunk" else 1 << 62
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for b in batches:
            state, *r = split_step(cfg, ocfg, model, state, b)
            rows.append(r)
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss, fb, upd, enq, fin = (min(r[i] for r in rows[1:])
                                   for i in range(5))
        out.append(dict(update=name, fwd_bwd_ms=fb, update_ms=upd,
                        enqueue_ms=enq, finish_ms=fin, peak_gb=peak))
        print(f"[granite] int8 moments, update by {name}: forward + "
              f"backward {fb:.3f} ms, update {upd:.3f} ms, host "
              f"{enq:.3f} ms to enqueue, {fin:.3f} to finish (min of 2), "
              f"peak {peak:.2f} GB", flush=True)
    adamw.UPDATE_CHUNK = default
    return dict(runs=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the probes here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the probes need one card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               qwen=probe_qwen(dev), granite=probe_granite(dev))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
