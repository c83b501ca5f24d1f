#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--out RECORD.json] [--kernels-only]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device — the card's name and power limit (a CUDA device is required);
2. build  — ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``
   (the ptxas report is printed);
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card, at the main paths' shapes, with times from CUDA events beside the
   bound (bytes over 3.35 TB/s or operations over the peak of the dtype;
   a complex multiply-add counts 8 flops) and a cuSPARSE CSR product
   (``A @ x``) as the library yardstick of each SpMV:

   * real: ``ell_gather`` on the Hubbard(12,6) operator at n_b = 1 and 512
     and on SpinChainXXZ(24,12) at n_b = 64, ``cheb_dia`` on the Hubbard
     DIA form at n_b = 512, each in fp64 (≤ 1e-13 relative to max|y|) and
     fp32 (≤ 1e-5); ``ell_gather`` on RoadNet(48000) at n_b = 64 in fp64;
   * complex: ``ell_gather`` and ``cheb_dia`` on Exciton(L=30) at n_b = 1
     and 384 in complex128 (bit-equal required) and complex64 (≤ 1e-5),
     ``cheb_dia`` on TopIns(40) at n_b = 384 in complex128.

   The DIA step's bound counts the compact operator its kernel reads,
   once (the earlier formula, which counted the dense dvals, is kept
   beside it as ``bound_ms_dense``). Each case also prints the slab width
   the rule chose (``kernels/plan.py``), the bytes of its schedule with x
   read once and the effective bytes (ms × 3.35 TB/s). Sweeps of forced
   slab widths (Hubbard n_b = 512 fp64, the step and the ELL product;
   Exciton n_b = 384 complex128, the step; each held to the plain version)
   are what ``plan.SLAB_ROW_BYTES`` is set from, and the filter's
   ``Y.add_(T, alpha=mu)`` is timed at both steps' shapes;
4. solves — ``repro_torch.launch.solve`` in-process, kernels on, each with
   the launch counts set to 0 just before it and read just after, every
   returned pair re-checked on the host against a scipy CSR of the port's
   own generator (‖A·x − θ·x‖ ≤ 1e-8):

   * Hubbard(12,6, U=25, ranpot=1) at N_s = 512, fp64, τ just below the
     spectrum; both kernels must launch;
   * Exciton(L=30) (the exciton200 config cut to one card) at N_s = 384,
     n_target = 100, complex128, τ just below the spectrum; both kernels
     must launch;
   * RoadNet(48000) (the roadnet48k config's matrix) at N_s = 64,
     n_target = 16, fp64, τ just above the spectrum: no DIA form, so the
     ELL kernel must launch and the DIA kernel must not.

The last two lines of standard output are the card's ``nvidia-smi`` name
and power limit, then ``{"ok": true, "device": {...}}``; the line before
them is the ``kernels`` record (both kernels, each with its launches on
the three solves and its dtype cases). ``--kernels-only`` stops after
phase 3 and prints no result line (for tuning the kernels; the full run is
the check).
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
# outside the tensor cores; a complex dtype at the peak of its planes' type
PEAK_FLOPS = {"float64": 33.5e12, "float32": 67e12, "complex128": 33.5e12,
              "complex64": 67e12}
TOL = {"float64": 1e-13, "float32": 1e-5, "complex128": 1e-13,
       "complex64": 1e-5}
BITWISE = ("complex128",)  # held bit for bit to the plain version
HUBBARD = dict(n_sites=12, n_fermions=6, U=25.0, ranpot=1.0)
SPIN = dict(n_sites=24, n_up=12)
N_SEARCH = 512
N_TARGET = 16
MAX_ITERS = 60  # ~53 needed: residuals halve per iteration once locked on
# the exciton200 config cut to one card (L = 200 -> 30), its N_s and N_t
EXCITON = dict(L=30)
EX_N_SEARCH, EX_N_TARGET = 384, 100
EX_MAX_ITERS = 300  # ~195 needed
TOPINS = dict(Lx=40)  # D = 256,000
# the roadnet48k config's matrix and N_s, N_t
ROADNET = dict(n=48000, w=2, m=1200, k=4)
RN_N_SEARCH, RN_N_TARGET = 64, 16
RN_MAX_ITERS = 400  # ~150 needed at the upper edge
# forced slab widths timed at Hubbard n_b = 512 (fp64) and Exciton
# n_b = 384 (complex128)
SLAB_SWEEP = {"cheb_dia": (4, 8, 16, 32, 64, 128, N_SEARCH),
              "ell_gather": (32, 128, N_SEARCH),
              "cheb_dia complex": (4, 8, 16, 32, 64, EX_N_SEARCH)}
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
    lib_ms, lib_note = None, None
    if library is not None:
        try:
            lib_ms = time_ms(library, reps[0])
        except RuntimeError as e:  # no such library call for this dtype
            lib_note = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
            torch.cuda.synchronize()
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    c, model = slab if slab is not None else (None, None)
    rec = dict(name=name, case=case, dtype=dtype, max_abs_err=err,
               max_rel_err=rel, bitwise=bitwise, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, tol=TOL[dtype], slab=c,
               model_bytes=model, effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S,
               **(extra or {}))
    if lib_note:
        rec["library_note"] = lib_note
    log(f"[kernels] {name} {case} {dtype}: max|err|={err:.3e} "
        f"rel={rel:.3e} bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
        f"bound_ms={b_ms:.4f} ({b_by}) slab={c} "
        f"model_GB={model if model is None else round(model / 1e9, 3)} "
        f"effective_GB={rec['effective_bytes'] / 1e9:.3f}"
        + "".join(f" {k}={v:.4f}" for k, v in (extra or {}).items())
        + (f" library: {lib_note}" if lib_note else ""))
    if not finite or not rel <= TOL[dtype]:
        raise SmokeFailure(f"{name} {case} {dtype} disagrees with its plain "
                           f"version: rel {rel:.3e} > {TOL[dtype]:.0e}")
    if dtype in BITWISE and not bitwise:
        raise SmokeFailure(f"{name} {case} {dtype} is not bit-equal to its "
                           f"plain version (max|err| {err:.3e})")
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
               model, case=f"Hubbard n_b={N_SEARCH}", dtype="float64",
               widths=None) -> None:
    """Time ``launch(c)`` at each forced slab width (``SLAB_SWEEP[name]``
    unless ``widths``), each result held to the plain version's ``want``
    bit for bit."""
    import torch

    for c in widths or SLAB_SWEEP[name]:
        y = launch(c)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(y, want))
        del y
        ms = time_ms(lambda: launch(c), 5)
        b_ms, _ = bound_ms(n_bytes, 0.0, dtype)
        rec = dict(name=name, case=f"sweep {case} c={c}",
                   dtype=dtype, slab=c, ms=ms, bitwise=bitwise,
                   bound_ms=b_ms, share_of_bound=b_ms / ms,
                   model_bytes=model(c),
                   effective_bytes=ms * 1e-3 * HBM_BYTES_PER_S)
        records.append(rec)
        log(f"[sweep] {name} {case} {dtype} c={c}: ms={ms:.4f} bitwise={bitwise} "
            f"model_GB={rec['model_bytes'] / 1e9:.3f} "
            f"effective_GB={rec['effective_bytes'] / 1e9:.3f} "
            f"share_of_bound={b_ms / ms:.3f}")
        if not bitwise:
            raise SmokeFailure(f"{name} at slab width {c} differs from its "
                               "plain version")


def time_add(records: list, case: str, x, w2, dtype: str) -> None:
    """The filter's ``Y += mu_k·T_k``, one torch call a step."""
    ms = time_ms(lambda: x.add_(w2, alpha=1e-30), 5)
    b_ms, _ = bound_ms(3 * x.numel() * x.element_size(), 0.0, dtype)
    records.append(dict(name="Y.add_", case=case, dtype=dtype, ms=ms,
                        bound_ms=b_ms, share_of_bound=b_ms / ms))
    log(f"[kernels] Y.add_(T, alpha=mu) {case} {dtype}: ms={ms:.4f} "
        f"bound_ms={b_ms:.4f}")


def ell_case(records: list, label: str, cols, vals, nb: int, dtype: str,
             gen, sweep: bool = False) -> None:
    """``ell_gather`` against its plain version on ``x [R, nb]``;
    ``sweep`` times the forced slab widths of ``SLAB_SWEEP``."""
    import torch

    from repro_torch.kernels import plan, ref
    from repro_torch.kernels.ell_gather import ell_gather_spmv as k_ell

    tdt = getattr(torch, dtype)
    S = tdt.itemsize
    nnz = int((vals != 0).sum())
    cpe = plan.compact_ell(cols, vals)  # built once, as make_spmv does
    A = csr_library(cols, vals)
    x = torch.randn((cols.shape[0], nb), generator=gen, device="cuda",
                    dtype=torch.complex128 if tdt.is_complex
                    else torch.float64).to(tdt)
    flops = (8.0 if tdt.is_complex else 2.0) * nnz * nb
    n_bytes = cols.shape[0] * nb * S * 2 + nnz * (4 + S)
    records.append(compare(
        "ell_gather", f"{label} n_b={nb}", dtype,
        lambda: k_ell(cols, vals, x, compact=cpe),
        lambda: ref.ell_spmv_ref(cols, vals, x), n_bytes, flops,
        library=lambda: A @ x, slab=ell_slab(cpe, nb, S)))
    if sweep:
        want = ref.ell_spmv_ref(cols, vals, x)
        slab_sweep(records, "ell_gather",
                   lambda c: k_ell(cols, vals, x, compact=cpe, slab=c),
                   want, n_bytes, lambda c: ell_slab(cpe, nb, S, c)[1],
                   case=f"{label} n_b={nb}", dtype=dtype)
        del want
    del x, A, cpe


def dia_case(records: list, label: str, dia, nb: int, dtype: str, gen,
             sweep: str | None = None, add: bool = False) -> None:
    """``cheb_dia`` against its plain version on ``x = w1, w2 [R, nb]``;
    ``sweep`` names the forced slab widths to time, ``add`` times the
    filter's ``Y.add_`` at the same shape."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cheb_dia import cheb_dia as k_dia

    tdt = getattr(torch, dtype)
    S = tdt.itemsize
    cp = dia.compact
    R = cp.R
    x, w2 = (torch.randn((R, nb), generator=gen, device="cuda",
                         dtype=torch.complex128 if tdt.is_complex
                         else torch.float64).to(tdt) for _ in range(2))
    # x (= w1), w2 and y once, and the compact operator the kernel reads,
    # once; the earlier formula counted dense dvals
    n_bytes = 3 * R * nb * S + cp.bytes_per_row * R
    dense_ms, _ = bound_ms(3 * R * nb * S + dia.dvals.numel() * S, 0.0, dtype)
    flops = ((8.0 * cp.nnz + 8.0 * R) if tdt.is_complex
             else (2.0 * cp.nnz + 4.0 * R)) * nb

    def step(c=None):
        return k_dia(dia.offsets, dia.dvals, x, x, w2, 0.013, -0.4,
                     compact=cp, span=dia.span, slab=c)

    def plain():
        return ref.cheb_dia_ref(dia.offsets, dia.dvals, x, x, w2, 0.013, -0.4)

    records.append(compare(
        "cheb_dia", f"{label} n_b={nb}", dtype, step, plain, n_bytes, flops,
        reps=(5, 2), slab=dia_slab(dia, nb, S),
        extra=dict(bound_ms_dense=dense_ms)))
    if sweep:
        want = plain()
        slab_sweep(records, "cheb_dia", step, want, n_bytes,
                   lambda c: dia_slab(dia, nb, S, c)[1],
                   case=f"{label} n_b={nb}", dtype=dtype,
                   widths=SLAB_SWEEP[sweep])
        del want
    if add:
        time_add(records, f"{label} n_b={nb}", x, w2, dtype)
    del x, w2
    torch.cuda.empty_cache()


def log_dia(mat, dtype: str, dia) -> None:
    cp = dia.compact
    log(f"[kernels] {mat.describe()} {dtype}: DIA form, "
        f"{len(dia.offsets)} diagonals, span {dia.span}; compact "
        f"{cp.nnz} entries, {cp.bytes_per_row:.2f} B a row, at most "
        f"{cp.max_row} in a row, "
        f"{0 if cp.table is None else len(cp.table)} table values")


def phase_kernels(records: list) -> None:
    """The Hubbard path's cases (both kernels, fp64 and fp32, with the
    slab sweeps and ``Y.add_`` in fp64) and SpinChainXXZ(24,12)'s ELL
    product (paper Table 5, scattered rank jumps)."""
    import torch

    from repro_torch.core import build_dist_ell
    from repro_torch.kernels import ops
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
            vals = ell64.vals.to(getattr(torch, dtype))
            main = fam is Hubbard and dtype == "float64"
            for nb in nbs:
                ell_case(records, fam.name, ell64.cols, vals, nb, dtype, gen,
                         sweep=main and nb == N_SEARCH)
            if fam is Hubbard:
                dia = ops.plan_dia(ell64.cols, vals, ell64.R, device="cuda")
                if dia is None or len(dia.offsets) > ops.DIA_MAX_DIAGS:
                    raise SmokeFailure("Hubbard(12,6) has no DIA form")
                log_dia(mat, dtype, dia)
                dia_case(records, "Hubbard", dia, N_SEARCH, dtype, gen,
                         sweep="cheb_dia" if main else None, add=main)
                del dia
            del vals
            torch.cuda.empty_cache()
        del ell64


def phase_kernels_families(records: list) -> None:
    """The cases of the families added after the Hubbard path: the ELL
    route of RoadNet(48000) in fp64, Exciton(L=30) in complex128 and
    complex64 on both kernels, TopIns(40)'s step in complex128."""
    import torch

    from repro_torch.core import build_dist_ell
    from repro_torch.kernels import ops
    from repro_torch.matrices import Exciton, RoadNet, TopIns

    gen = torch.Generator(device="cuda").manual_seed(2025)
    t0 = time.perf_counter()
    mat = RoadNet(**ROADNET)
    ell = build_dist_ell(mat, 1, dtype="float64", device="cuda")
    log(f"[kernels] {mat.describe()}: ELL R={ell.R} W={ell.W} span={ell.span}"
        f", DIA form: {ops.plan_dia(ell.cols, ell.vals, ell.R) is not None}; "
        f"built in {time.perf_counter() - t0:.2f} s")
    ell_case(records, "RoadNet", ell.cols, ell.vals, RN_N_SEARCH, "float64",
             gen)
    del ell

    for fam, params, label, dtypes, nbs_ell, nbs_dia in (
            (Exciton, EXCITON, "Exciton", ("complex128", "complex64"),
             (1, EX_N_SEARCH), (1, EX_N_SEARCH)),
            (TopIns, TOPINS, "TopIns", ("complex128",), (), (EX_N_SEARCH,))):
        t0 = time.perf_counter()
        mat = fam(**params)
        ell = build_dist_ell(mat, 1, dtype="complex128", device="cuda")
        log(f"[kernels] {mat.describe()}: ELL R={ell.R} W={ell.W} "
            f"span={ell.span} built in {time.perf_counter() - t0:.2f} s")
        for dtype in dtypes:
            vals = ell.vals.to(getattr(torch, dtype))
            for nb in nbs_ell:
                ell_case(records, label, ell.cols, vals, nb, dtype, gen)
            dia = ops.plan_dia(ell.cols, vals, ell.R, device="cuda")
            if dia is None:
                raise SmokeFailure(f"{mat.describe()} has no DIA form")
            log_dia(mat, dtype, dia)
            for nb in nbs_dia:
                main = (fam is Exciton and dtype == "complex128"
                        and nb == EX_N_SEARCH)
                dia_case(records, label, dia, nb, dtype, gen,
                         sweep="cheb_dia complex" if main else None,
                         add=main)
            del vals, dia
        del ell
        torch.cuda.empty_cache()


def host_operator(fam, params: dict, which: str):
    """The family's scipy CSR and the host eigsh estimate of its lowest
    (``which="SA"``) or highest (``"LA"``) eigenvalue."""
    import scipy.sparse.linalg as sla

    t0 = time.perf_counter()
    A = fam(**params).build_csr().to_scipy()
    lam = float(sla.eigsh(A, k=1, which=which, tol=1e-6, ncv=64,
                          return_eigenvectors=False)[0])
    log(f"[solve] {fam.__name__} host CSR + eigsh {which} {lam:.10f} in "
        f"{time.perf_counter() - t0:.2f} s")
    return A, lam


def run_solve(label: str, family: str, params: dict, A, *, n_search: int,
              n_target: int, target: float, max_iters: int,
              launched: dict, dtype: str = "float64") -> dict:
    """One solve through the CLI, its launch counts set to 0 just before
    and read just after (``launched`` maps each kernel to whether it must
    launch), every returned pair re-checked on the host against ``A``."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import solve as cli

    argv = ["--family", family,
            "--params", ",".join(f"{k}={v:g}" for k, v in params.items()),
            "--n-search", str(n_search), "--n-target", str(n_target),
            "--target", repr(target), "--tol", "1e-10",
            "--max-iters", str(max_iters), "--layout", "stack",
            "--dtype", dtype, "--spmv-kernel", "--device", "cuda"]
    log(f"[solve {label}] python -m repro_torch.launch.solve " + " ".join(argv))
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
    log(f"[solve {label}] wall {wall:.3f} s, iterations {res.iterations}, "
        f"converged {res.n_converged}/{n_target}, degrees {degrees}, "
        f"max_memory_allocated {peak} B, launches {launches}")
    if res.n_converged < n_target:
        raise SmokeFailure(f"{label} solve converged {res.n_converged} < "
                           f"{n_target}")
    for k, must in launched.items():
        if must and launches[k] <= 0:
            raise SmokeFailure(f"kernel {k} was never launched on the "
                               f"{label} path")
        if not must and launches[k] != 0:
            raise SmokeFailure(f"kernel {k} launched {launches[k]} times on "
                               f"the {label} path, which should not take it")
    X, theta = res.eigenvectors, res.eigenvalues
    if not (np.isfinite(theta).all() and np.isfinite(X).all()
            and X.shape == (A.shape[0], len(theta))
            and len(theta) >= n_target):
        raise SmokeFailure(f"{label}: bad result: eigenvalues {theta.shape}, "
                           f"vectors {X.shape}")
    resid = np.linalg.norm(A @ X - X * theta, axis=0)
    log(f"[solve {label}] host re-check: max ||A x - theta x|| = "
        f"{resid.max():.3e} over {len(theta)} pairs; eigenvalues "
        f"{theta.min():.12f} .. {theta.max():.12f}")
    if not (resid <= 1e-8).all():
        raise SmokeFailure(f"{label}: host residual {resid.max():.3e} > 1e-8")
    return dict(wall_s=wall, iterations=res.iterations,
                n_converged=res.n_converged, degrees=degrees,
                total_spmvs=res.total_spmvs, max_memory_allocated=peak,
                launches=launches, host_residual_max=float(resid.max()),
                eigenvalues=[float(t) for t in theta], target=target,
                dtype=str(X.dtype))


def phase_solves() -> dict:
    from repro_torch.matrices import Exciton, Hubbard, RoadNet

    both = dict(ell_gather=True, cheb_dia=True)
    out = {}
    # a Ritz value from above: τ = estimate − 0.1 lies below the spectrum
    # as long as the estimate is within 0.1 of the lowest eigenvalue
    A, lam = host_operator(Hubbard, HUBBARD, "SA")
    out["hubbard"] = run_solve(
        "hubbard", "Hubbard", HUBBARD, A, n_search=N_SEARCH,
        n_target=N_TARGET, target=lam - 0.1, max_iters=MAX_ITERS,
        launched=both)
    out["hubbard"]["eigsh_lower_edge"] = lam
    del A
    A, lam = host_operator(Exciton, EXCITON, "SA")
    out["exciton"] = run_solve(
        "exciton", "Exciton", EXCITON, A, n_search=EX_N_SEARCH,
        n_target=EX_N_TARGET, target=lam - 0.1, max_iters=EX_MAX_ITERS,
        launched=both)
    out["exciton"]["eigsh_lower_edge"] = lam
    del A
    # the upper edge: the lowest eigenvalues of a 48,000-node Laplacian lie
    # within 1e-5 of 0 and hold every filter degree at its 200,000 cap
    A, lam = host_operator(RoadNet, ROADNET, "LA")
    out["roadnet"] = run_solve(
        "roadnet", "RoadNet", ROADNET, A, n_search=RN_N_SEARCH,
        n_target=RN_N_TARGET, target=lam + 0.1, max_iters=RN_MAX_ITERS,
        launched=dict(ell_gather=True, cheb_dia=False))
    out["roadnet"]["eigsh_upper_edge"] = lam
    return out


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
    phase_kernels_families(records)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        if args.out:
            write_record(args.out, dict(device=dict(name=name, count=count,
                                                    nvidia_smi=smi),
                                        build_seconds=build.build_seconds,
                                        checks=records))
        return 0

    t0 = time.perf_counter()
    solves = phase_solves()
    log(f"[solve] phase {time.perf_counter() - t0:.1f} s")
    main_case = f"Hubbard n_b={N_SEARCH}"  # the shape of the filter's steps
    line = []
    for k in ("ell_gather", "cheb_dia"):
        r = next(r for r in records if r["name"] == k
                 and r["case"] == main_case and r["dtype"] == "float64")
        cases = [dict(case=c["case"], dtype=c["dtype"], ms=c["ms"],
                      plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                      bound_by=c["bound_by"], library_ms=c["library_ms"],
                      max_abs_err=c["max_abs_err"], bitwise=c["bitwise"])
                 for c in records
                 if c["name"] == k and not c["case"].startswith("sweep")]
        by_solve = {s: v["launches"][k] for s, v in solves.items()}
        line.append(dict(
            name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
            launches=sum(by_solve.values()), launches_by_solve=by_solve,
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            dtypes=sorted({c["dtype"] for c in cases}), cases=cases))
    if args.out:
        write_record(args.out, dict(device=dict(name=name, count=count,
                                                nvidia_smi=smi),
                                    build_seconds=build.build_seconds,
                                    checks=records, solves=solves,
                                    kernels=line))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the full record (every check, the solves) here")
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
