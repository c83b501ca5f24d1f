#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--out RECORD.json] [--kernels-only]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device — the card's name and power limit (a CUDA device is required);
2. build  — ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``
   (the ptxas report is printed);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes: ``ell_gather`` on the Hubbard(12,6)
   operator at n_b = 1 and 512 and on SpinChainXXZ(24,12) at n_b = 64,
   ``cheb_dia`` on the Hubbard(12,6) DIA form at n_b = 512, each in fp64
   (≤ 1e-13 relative to max|y|) and fp32 (≤ 1e-5); times from CUDA events
   beside the bound (bytes over 3.35 TB/s or operations over the peak) and,
   for the SpMV, a cuSPARSE CSR product as the library yardstick. The DIA
   step's bound counts the compact operator its kernel reads, once; the
   earlier formula, which counted the dense dvals, is kept beside it as
   ``bound_ms_dense``. Each
   case also prints the slab width the rule chose (``kernels/plan.py``),
   the bytes of its schedule with x read once and the effective bytes
   (ms × 3.35 TB/s). A sweep of forced slab widths (fp64, Hubbard n_b =
   512, each held to the plain version) is what ``plan.SLAB_ROW_BYTES``
   is set from, and the filter's ``Y.add_(T, alpha=mu)`` is timed at the
   same shape;
4. solve — ``repro_torch.launch.solve`` in-process on Hubbard(12,6, U=25,
   ranpot=1) at N_s = 512, fp64, kernels on, τ just below the spectrum,
   with both launch counts set to 0 before and required > 0 after; every
   returned pair is re-checked on the host against a scipy CSR of the
   port's own generator (‖A·x − θ·x‖ ≤ 1e-8).

The last two lines of standard output are the card's ``nvidia-smi`` name
and power limit, then ``{"ok": true, "device": {...}}``; the line before
them is the ``kernels`` record. ``--kernels-only`` stops after phase 3 and
prints no result line (for tuning the kernels; the full run is the check).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float64": 33.5e12, "float32": 67e12}  # outside the tensor cores
TOL = {"float64": 1e-13, "float32": 1e-5}
HUBBARD = dict(n_sites=12, n_fermions=6, U=25.0, ranpot=1.0)
SPIN = dict(n_sites=24, n_up=12)
N_SEARCH = 512
N_TARGET = 16
MAX_ITERS = 60  # ~53 needed: residuals halve per iteration once locked on
# forced slab widths timed at Hubbard n_b = 512 (fp64)
SLAB_SWEEP = {"cheb_dia": (4, 8, 16, 32, 64, 128, N_SEARCH),
              "ell_gather": (32, 128, N_SEARCH)}
REPLACES = {
    "ell_gather": "src/repro/kernels/ell_gather.py:172",
    "cheb_dia": "src/repro/kernels/cheb_dia.py:125",
}
SOURCES = {
    "ell_gather": "src/repro_torch/kernels/csrc/ell_gather.cu",
    "cheb_dia": "src/repro_torch/kernels/csrc/cheb_dia.cu",
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, case, dtype, kernel, plain, n_bytes, n_ops, library=None,
            reps=(10, 3), slab=None, extra=None):
    """Run the kernel and its plain version on the same inputs, hold them
    to the tolerance, time both (and the library call). ``slab`` is the
    rule's (c, modelled bytes) for the launch; ``extra`` is added to the
    record."""
    import torch

    y = kernel()
    y_ref = plain()
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    rel = err / scale if scale else err
    bitwise = bool(torch.equal(y, y_ref))
    finite = bool(torch.isfinite(y).all())
    del y, y_ref
    ms = time_ms(kernel, reps[0])
    plain_ms = time_ms(plain, reps[1])
    lib_ms = time_ms(library, reps[0]) if library is not None else None
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    c, model = slab if slab is not None else (None, None)
    rec = dict(name=name, case=case, dtype=dtype, max_abs_err=err,
               max_rel_err=rel, bitwise=bitwise, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, tol=TOL[dtype], slab=c,
               model_bytes=model, effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S,
               **(extra or {}))
    log(f"[kernels] {name} {case} {dtype}: max|err|={err:.3e} "
        f"rel={rel:.3e} bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
        f"bound_ms={b_ms:.4f} ({b_by}) slab={c} "
        f"model_GB={model if model is None else round(model / 1e9, 3)} "
        f"effective_GB={rec['effective_bytes'] / 1e9:.3f}"
        + "".join(f" {k}={v:.4f}" for k, v in (extra or {}).items()))
    if not finite or not rel <= TOL[dtype]:
        raise SmokeFailure(f"{name} {case} {dtype} disagrees with its plain "
                           f"version: rel {rel:.3e} > {TOL[dtype]:.0e}")
    torch.cuda.empty_cache()
    return rec


def csr_library(cols, vals):
    """cuSPARSE CSR of the same operator (the yardstick, not the port)."""
    import torch

    R = cols.shape[0]
    nz = vals != 0
    crow = torch.zeros(R + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(nz.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols[nz].to(torch.int64), vals[nz],
                                   size=(R, R))


def ell_slab(cp, nb, S, c=None):
    """The ELL kernel's slab width (the rule's unless ``c``) and the bytes
    of its schedule, over the padding-free form ``cp``."""
    from repro_torch.kernels import plan
    from repro_torch.kernels.ell_gather import slab_for

    c = slab_for(nb, c)
    return c, plan.model_bytes(cp.R, nb, S, c, plan.ell_bytes_per_row(cp),
                               streams=1)


def dia_slab(dia, nb, S, c=None):
    """The DIA kernel's slab width (the rule's unless ``c``) and the bytes
    of its schedule."""
    from repro_torch.kernels import plan
    from repro_torch.kernels.cheb_dia import slab_for

    c = slab_for(dia.compact.dtype, dia.span, nb, c)
    return c, plan.model_bytes(dia.compact.R, nb, S, c,
                               dia.compact.bytes_per_row)


def slab_sweep(records: list, name: str, launch, want, n_bytes,
               model) -> None:
    """Time ``launch(c)`` at each forced slab width of ``SLAB_SWEEP``,
    each result held to the plain version's ``want`` bit for bit."""
    import torch

    for c in SLAB_SWEEP[name]:
        y = launch(c)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(y, want))
        del y
        ms = time_ms(lambda: launch(c), 5)
        b_ms, _ = bound_ms(n_bytes, 0.0, "float64")
        rec = dict(name=name, case=f"sweep Hubbard n_b={N_SEARCH} c={c}",
                   dtype="float64", slab=c, ms=ms, bitwise=bitwise,
                   bound_ms=b_ms, share_of_bound=b_ms / ms,
                   model_bytes=model(c),
                   effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S)
        records.append(rec)
        log(f"[sweep] {name} c={c}: ms={ms:.4f} bitwise={bitwise} "
            f"model_GB={rec['model_bytes'] / 1e9:.3f} "
            f"effective_GB={rec['effective_bytes'] / 1e9:.3f} "
            f"share_of_bound={b_ms / ms:.3f}")
        if not bitwise:
            raise SmokeFailure(f"{name} at slab width {c} differs from its "
                               "plain version")


def phase_kernels(records: list) -> None:
    import torch

    from repro_torch.core import build_dist_ell
    from repro_torch.kernels import ops, plan, ref
    from repro_torch.kernels.cheb_dia import cheb_dia as k_dia
    from repro_torch.kernels.ell_gather import ell_gather_spmv as k_ell
    from repro_torch.matrices import Hubbard, SpinChainXXZ

    gen = torch.Generator(device="cuda").manual_seed(2024)
    for fam, params, nbs in ((Hubbard, HUBBARD, (N_SEARCH, 1)),
                             (SpinChainXXZ, SPIN, (64,))):
        t0 = time.perf_counter()
        mat = fam(**params)
        ell64 = build_dist_ell(mat, 1, dtype="float64", device="cuda")
        log(f"[kernels] {mat.describe()}: ELL R={ell64.R} W={ell64.W} "
            f"span={ell64.span} built in {time.perf_counter() - t0:.2f} s")
        for dtype in ("float64", "float32"):
            tdt = getattr(torch, dtype)
            S = torch.finfo(tdt).bits // 8
            cols = ell64.cols
            vals = ell64.vals.to(tdt)
            nnz = int((vals != 0).sum())
            A = csr_library(cols, vals)
            cpe = plan.compact_ell(cols, vals)  # built once, as make_spmv does
            for nb in nbs:
                x = torch.randn((ell64.R, nb), generator=gen, device="cuda",
                                dtype=torch.float64).to(tdt)
                n_bytes = ell64.R * nb * S * 2 + nnz * (4 + S)
                records.append(compare(
                    "ell_gather", f"{fam.name} n_b={nb}", dtype,
                    lambda: k_ell(cols, vals, x, compact=cpe),
                    lambda: ref.ell_spmv_ref(cols, vals, x),
                    n_bytes, 2.0 * nnz * nb, library=lambda: A @ x,
                    slab=ell_slab(cpe, nb, S)))
                if fam is Hubbard and nb == N_SEARCH and dtype == "float64":
                    want = ref.ell_spmv_ref(cols, vals, x)
                    slab_sweep(
                        records, "ell_gather",
                        lambda c: k_ell(cols, vals, x, compact=cpe, slab=c),
                        want, n_bytes, lambda c: ell_slab(cpe, nb, S, c)[1])
                    del want
                del x
            if fam is Hubbard:
                dia = ops.plan_dia(cols, vals, ell64.R, device="cuda")
                if dia is None or len(dia.offsets) > ops.DIA_MAX_DIAGS:
                    raise SmokeFailure("Hubbard(12,6) has no DIA form")
                cp = dia.compact
                log(f"[kernels] {mat.describe()}: DIA form, "
                    f"{len(dia.offsets)} diagonals, span {dia.span}; compact "
                    f"{cp.nnz} entries, {cp.bytes_per_row:.2f} B a row, "
                    f"at most {cp.max_row} in a row, "
                    f"{0 if cp.table is None else len(cp.table)} table values")
                nb = N_SEARCH
                x, w2 = (torch.randn((ell64.R, nb), generator=gen, device="cuda",
                                     dtype=torch.float64).to(tdt) for _ in range(2))
                # x (= w1), w2 and y once, and the compact operator the
                # kernel reads, once; the earlier formula counted dense dvals
                n_bytes = 3 * ell64.R * nb * S + cp.bytes_per_row * cp.R
                dense_ms, _ = bound_ms(
                    3 * ell64.R * nb * S + dia.dvals.numel() * S, 0.0, dtype)

                def step(c=None):
                    return k_dia(dia.offsets, dia.dvals, x, x, w2, 0.013, -0.4,
                                 compact=cp, span=dia.span, slab=c)

                records.append(compare(
                    "cheb_dia", f"Hubbard n_b={nb}", dtype, step,
                    lambda: ref.cheb_dia_ref(dia.offsets, dia.dvals, x, x, w2,
                                             0.013, -0.4),
                    n_bytes, 2.0 * nnz * nb + 4.0 * ell64.R * nb, reps=(5, 2),
                    slab=dia_slab(dia, nb, S),
                    extra=dict(bound_ms_dense=dense_ms)))
                if dtype == "float64":
                    want = ref.cheb_dia_ref(dia.offsets, dia.dvals, x, x, w2,
                                            0.013, -0.4)
                    slab_sweep(records, "cheb_dia", step, want, n_bytes,
                               lambda c: dia_slab(dia, nb, S, c)[1])
                    del want
                    # the filter's Y += mu_k·T_k, one torch call a step
                    ms = time_ms(lambda: x.add_(w2, alpha=1e-30), 5)
                    b_ms, _ = bound_ms(3 * ell64.R * nb * S, 0.0, dtype)
                    records.append(dict(name="Y.add_", case=f"Hubbard n_b={nb}",
                                        dtype=dtype, ms=ms, bound_ms=b_ms,
                                        share_of_bound=b_ms / ms))
                    log(f"[kernels] Y.add_(T, alpha=mu) Hubbard n_b={nb} "
                        f"{dtype}: ms={ms:.4f} bound_ms={b_ms:.4f}")
                del x, w2, dia, cp
            del A, vals, cpe
            torch.cuda.empty_cache()
        del ell64


def phase_solve() -> dict:
    import numpy as np
    import scipy.sparse.linalg as sla
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import solve as cli
    from repro_torch.matrices import Hubbard

    t0 = time.perf_counter()
    A = Hubbard(**HUBBARD).build_csr().to_scipy()
    # a Ritz value from above: τ = estimate − 0.1 lies below the spectrum
    # as long as the estimate is within 0.1 of the lowest eigenvalue
    lam_min = float(sla.eigsh(A, k=1, which="SA", tol=1e-6, ncv=64,
                              return_eigenvectors=False)[0])
    target = lam_min - 0.1
    log(f"[solve] host CSR + eigsh lower edge {lam_min:.10f} in "
        f"{time.perf_counter() - t0:.2f} s; target {target:.10f}")
    params = ",".join(f"{k}={v:g}" for k, v in HUBBARD.items())
    argv = ["--family", "Hubbard", "--params", params,
            "--n-search", str(N_SEARCH), "--n-target", str(N_TARGET),
            "--target", repr(target), "--tol", "1e-10",
            "--max-iters", str(MAX_ITERS), "--layout", "stack",
            "--spmv-kernel", "--device", "cuda"]
    log("[solve] python -m repro_torch.launch.solve " + " ".join(argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    degrees = [h.get("degree") for h in res.history if "degree" in h]
    log(f"[solve] wall {wall:.3f} s, iterations {res.iterations}, "
        f"converged {res.n_converged}/{N_TARGET}, degrees {degrees}, "
        f"max_memory_allocated {peak} B, launches {launches}")
    if res.n_converged < N_TARGET:
        raise SmokeFailure(f"solve converged {res.n_converged} < {N_TARGET}")
    for k, n in launches.items():
        if n <= 0:
            raise SmokeFailure(f"kernel {k} was never launched on the main path")
    X, theta = res.eigenvectors, res.eigenvalues
    if not (np.isfinite(theta).all() and np.isfinite(X).all()
            and X.shape == (A.shape[0], len(theta))):
        raise SmokeFailure(f"bad result: eigenvalues {theta.shape}, "
                           f"vectors {X.shape}")
    resid = np.linalg.norm(A @ X - X * theta, axis=0)
    log(f"[solve] host re-check: max ||A x - theta x|| = {resid.max():.3e} "
        f"over {len(theta)} pairs; lowest eigenvalue {theta.min():.12f} "
        f"(eigsh {lam_min:.12f})")
    if not (resid <= 1e-8).all():
        raise SmokeFailure(f"host residual {resid.max():.3e} > 1e-8")
    return dict(wall_s=wall, iterations=res.iterations,
                n_converged=res.n_converged, degrees=degrees,
                total_spmvs=res.total_spmvs, max_memory_allocated=peak,
                launches=launches, host_residual_max=float(resid.max()),
                eigenvalues=[float(t) for t in theta], eigsh_lower_edge=lam_min,
                target=target)


def write_record(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: the smoke run needs one card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(f"{SRC}/repro_torch not found: run chip_smoke.py "
                           "from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build.load()
    log(f"[build] {build.build_seconds:.2f} s\n{build.build_log}")

    t0 = time.perf_counter()
    records: list = []
    phase_kernels(records)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi),
                                        build_seconds=build.build_seconds,
                                        checks=records))
        return 0

    solve = phase_solve()
    main_case = f"Hubbard n_b={N_SEARCH}"  # the shape of the filter's steps
    line = []
    for k in ("ell_gather", "cheb_dia"):
        r = next(r for r in records if r["name"] == k
                 and r["case"] == main_case and r["dtype"] == "float64")
        line.append(dict(
            name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
            launches=solve["launches"][k],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    if args.out:
        write_record(args.out, dict(device=dict(name=name, count=count,
                                                nvidia_smi=smi),
                                    build_seconds=build.build_seconds,
                                    checks=records, solve=solve, kernels=line))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the full record (every check, the solve) here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase (no result line)")
    args = ap.parse_args(argv)
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
