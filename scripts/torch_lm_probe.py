#!/usr/bin/env python3
"""Probes of the LM serving path on one card (``repro_torch.models``).

    python3 scripts/torch_lm_probe.py [--out PROBE.json]

1. decode: qwen3-0.6b at full width in bf16, B = 2, after a 512-token
   prefill: the host's ms per token to enqueue and to finish, and from
   ``torch.profiler`` over 3 tokens the kernel launches and device ms per
   token;
2. mamba: the Mamba recurrence at hymba-1.5b's prefill shape (B = 2,
   S = 2,040, d_inner 3,200, N = 16, fp32), the port's sequential scan
   (``ssm._mamba_scan``) against a doubling scan over time, CUDA events;
3. rwkv: rwkv6-1.6b at full width, random weights, per-token WKV: each
   layer's output (12 layers, 256 tokens) against fp64 in fp32 on the
   card and on the host CPU; then at full depth decode after a 512-token
   prefill against the full forward of the grown sequence in fp32 and
   fp64 on the card and in fp32 on the CPU, the same weights.

Needs a CUDA device; TF32 is off throughout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rel(got, want) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def probe_decode(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import (init_params, make_batch,
                                    make_decode_step, make_prefill_step)

    cfg = get_config("qwen3-0.6b")
    m = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                    dev).requires_grad_(False)
    toks = make_batch(cfg, 2, 512, device=dev)["tokens"]
    lg, st = make_prefill_step(cfg, 600)(m, {"tokens": toks})
    step = make_decode_step(cfg)
    pos = 512
    for _ in range(4):  # warm
        lg, st = step(m, st, lg.argmax(-1), pos)
        pos += 1
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        lg, st = step(m, st, lg.argmax(-1), pos)
        pos += 1
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lg, st = step(m, st, lg.argmax(-1), pos)
            pos += 1
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel",
                                                      "cuLaunchKernelEx"))
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type is not None
                    and str(e.device_type).endswith("CUDA"))
    out = dict(enqueue_ms=1e3 * (t1 - t0) / n, finish_ms=1e3 * (t2 - t0) / n,
               launches_per_token=launches / 3,
               device_ms_per_token=device_us / 1e3 / 3,
               layers=cfg.n_layers)
    print(f"[decode] qwen3-0.6b bf16 B=2: host {out['enqueue_ms']:.2f} ms a "
          f"token to enqueue, {out['finish_ms']:.2f} to finish; "
          f"{out['launches_per_token']:.0f} launches and "
          f"{out['device_ms_per_token']:.2f} device ms a token "
          f"({out['launches_per_token'] / cfg.n_layers:.0f} a layer)",
          flush=True)
    return out


def probe_mamba(dev) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    hc = get_config("hymba-1.5b")
    B, S, di, N = 2, 2040, hc.d_inner, hc.ssm_state
    g = torch.Generator(device=dev).manual_seed(1)
    A = -torch.rand((di, N), generator=g, device=dev) * N
    dt = torch.rand((B, S, di), generator=g, device=dev)
    Bv = torch.randn((B, S, N), generator=g, device=dev)
    Cv = torch.randn((B, S, N), generator=g, device=dev)
    xv = torch.randn((B, S, di), generator=g, device=dev)
    h0 = torch.zeros((B, di, N), device=dev)

    def doubling():
        a = torch.exp(dt[..., None] * A)
        b = (dt * xv)[..., None] * Bv[:, :, None, :]
        b = torch.cat([torch.addcmul(b[:, :1], a[:, :1], h0[:, None]),
                       b[:, 1:]], dim=1)
        d = 1
        while d < S:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                                   b[:, :-d])], dim=1)
            if 2 * d < S:
                a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
            d *= 2
        return torch.einsum("bsdn,bsn->bsd", b, Cv)

    out = {}
    ys = {}
    for name, fn in (("sequential", lambda: ssm._mamba_scan(
            A, dt, Bv, Cv, xv, h0)[0]), ("doubling", doubling)):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ys[name] = fn()
        ev[1].record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = ev[0].elapsed_time(ev[1])
    out["rel"] = rel(ys["doubling"], ys["sequential"])
    print(f"[mamba] B={B} S={S} d_inner={di} N={N} fp32: sequential "
          f"{out['sequential_ms']:.2f} ms, doubling {out['doubling_ms']:.2f}"
          f" ms a layer (rel {out['rel']:.2e})", flush=True)
    return out


def probe_rwkv(dev) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (init_params, make_batch,
                                    make_decode_step, make_prefill_step)
    from repro_torch.models import transformer as tfm

    base = dataclasses.replace(get_config("rwkv6-1.6b"), ssm_chunk=0)
    out = {}

    # per layer, 12 layers, 256 tokens: fp32 against fp64
    cfg = dataclasses.replace(base, n_layers=12)
    m = init_params(cfg, torch.Generator(device=dev).manual_seed(4), dev,
                    dtype=torch.float32).requires_grad_(False)
    toks = make_batch(cfg, 2, 256, key=4, device=dev)["tokens"]

    def layers(model, t):
        with torch.no_grad():
            x = model.embed(t)
            pos = torch.arange(t.shape[1], device=t.device)
            ys = []
            for lp in model.segments[0]:
                x, _, _ = tfm.block_forward(lp, cfg, x, pos, window=0)
                ys.append(x.cpu())
            return ys

    ref = layers(m.double(), toks)
    m.float()
    for where in ("card", "cpu"):
        mm = m if where == "card" else m.cpu()
        got = layers(mm, toks.to(mm.embed.table.device))
        out[f"layers_{where}"] = [rel(a, b) for a, b in zip(got, ref)]
        print(f"[rwkv] fp32 against fp64, layers 1-12, {where}: "
              + " ".join(f"{e:.1e}" for e in out[f"layers_{where}"]),
              flush=True)
    del m, mm

    # full depth: decode against the full forward
    cfg = base
    m = init_params(cfg, torch.Generator(device=dev).manual_seed(4), dev,
                    dtype=torch.float32).requires_grad_(False)
    toks = make_batch(cfg, 2, 512, key=4, device=dev)["tokens"]
    for where, dt in (("card", torch.float32), ("card", torch.float64),
                      ("cpu", torch.float32)):
        t0 = time.perf_counter()
        d = dev if where == "card" else torch.device("cpu")
        mm = m.to(device=d, dtype=dt)
        t = toks.to(d)
        lg, st = make_prefill_step(cfg, 528)(mm, {"tokens": t})
        step = make_decode_step(cfg)
        for pos in range(512, 528):
            nxt = lg.argmax(-1)
            lg, st = step(mm, st, nxt, pos)
            t = torch.cat([t, nxt[:, None].to(t.dtype)], dim=1)
        with torch.no_grad():
            x, positions, _, _ = tfm.embed_batch(mm, cfg, {"tokens": t})
            h, _ = tfm.backbone(mm, cfg, x, positions)
            full = h[:, -1] @ tfm.lm_head_table(mm, cfg).T
        key = f"decode_vs_full_{where}_{str(dt).removeprefix('torch.')}"
        out[key] = dict(max_abs=float((lg - full).abs().max()),
                        rel=rel(lg, full), seconds=time.perf_counter() - t0)
        print(f"[rwkv] 24 layers, {where} {dt}: decode step 16 against the "
              f"full forward: max |d| {out[key]['max_abs']:.3e} rel "
              f"{out[key]['rel']:.3e}", flush=True)
        del st
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the probes here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the probes need one card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = dict(device=torch.cuda.get_device_name(0),
               decode=probe_decode(dev), mamba=probe_mamba(dev),
               rwkv=probe_rwkv(dev))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
