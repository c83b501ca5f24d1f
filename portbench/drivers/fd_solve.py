"""The FD driver: filter-diagonalization solves of one configuration, back
to back, for ``--seconds``.

Set-up builds the solver once, as ``python -m repro_torch.launch.solve``
does (``FilterDiag(matrix, FDConfig, device, n_row, n_col)``, kernels on),
from the configuration (matrix, N_s, N_t, target, tolerance, dtype) and
the traffic mix (layout, grid, halo engine, row map), and warms it up with
one solve from fixed draws, cut at two iterations: every kernel, the dense
layer and the finish of a solve run once before the window.

Solve i of a run starts from a Lanczos vector ``[D, 1]`` and a search
block ``[D, N_s]`` of standard normals, drawn on the device from
``(--seed, i)`` and handed to ``FilterDiag.solve(V0=..., v0=...)``: the
program draws nothing itself. Solves run one after another (one client,
closed loop) until ``--seconds`` have passed; the solve in flight then
finishes, so every solve counted is whole, and each ends with a device
synchronisation.

With ``--trace 1`` the same solves run through the public halves of
``FilterDiag.step`` (``init_state``, ``step_analyze``, ``step_filter``,
as ``solve`` runs them), each inside a span of the harness's own that
ends with ``torch.cuda.synchronize()``, under ``torch.profiler``.

Once the window has closed and the memory peak is read, the solver is
freed and every solve's eigenpairs are judged against the plain reference
(``portbench/reference/check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from contextlib import contextmanager

import numpy as np

from ..harness.record import Run, seed_of
from ..reference import check

#: the label of the warm-up solve's draws: the same for every seed, so set-up
#: does the same work in every run
WARMUP = "warmup"
HALO = ("all_to_all", "ppermute")


def fd_config(config: dict, traffic: dict):
    """The ``FDConfig`` of a cell: the configuration's solver settings
    and the traffic's layout and engine, kernels on."""
    from repro_torch.core import FDConfig

    fields = {f.name for f in dataclasses.fields(FDConfig)}
    fd = dict(config["fd"], **traffic["fd"], spmv_kernel=True)
    unknown = sorted(set(fd) - fields)
    if unknown:
        raise ValueError(f"not FDConfig fields: {unknown}")
    return FDConfig(**fd)


def build(config: dict, traffic: dict, device):
    from repro_torch.core import FilterDiag
    from repro_torch.matrices import get_family

    params = dict(config["matrix"])
    matrix = get_family(params.pop("family"), **params)
    return FilterDiag(matrix, fd_config(config, traffic), device=device,
                      n_row=traffic["n_row"], n_col=traffic["n_col"])


def draws(fd, seed: int, i):
    """The Lanczos vector and the search block of solve ``i``."""
    import torch

    g = torch.Generator(device=fd.device).manual_seed(seed_of(seed, i))
    v0 = torch.randn((fd.D, 1), generator=g, dtype=torch.float64,
                     device=fd.device)
    V0 = torch.randn((fd.D, fd.cfg.n_search), generator=g,
                     dtype=torch.float64, device=fd.device)
    return V0, v0


def sync(fd) -> None:
    import torch

    if fd.device.type == "cuda":
        torch.cuda.synchronize(fd.device)


def warm_up(fd) -> None:
    """One solve from the fixed warm-up draws, cut at two iterations (its
    third analysis takes the best-effort finish)."""
    V0, v0 = draws(fd, 0, WARMUP)
    cap = dataclasses.replace(fd.cfg, max_iters=2)
    state = fd.init_state(V0=V0, v0=v0)
    while not state.done:
        state = fd.step_analyze(state, cfg=cap)
        if not state.done:
            state = fd.step_filter(state, cfg=cap)
    sync(fd)


def halo_bytes(exchange: dict) -> int:
    """The halo bytes of both levels in an ``exchange`` summary."""
    levels = [exchange] + ([exchange["panel"]] if exchange["panel"] else [])
    return sum(int(lv["bytes"][k]) for lv in levels for k in HALO)


def _solve_traced(fd, V0, v0, spans: dict):
    """``fd.solve(V0=V0, v0=v0)`` through its public halves, each in a
    span that ends in a device synchronisation."""
    from torch.profiler import record_function

    @contextmanager
    def span(name):
        t0 = time.perf_counter()
        with record_function(f"portbench::{name}"):
            yield
            sync(fd)
        spans[name] += time.perf_counter() - t0

    with span("init"):
        state = fd.init_state(V0=V0, v0=v0)
    while not state.done:
        with span("analyze"):
            state = fd.step_analyze(state)
        if not state.done:
            with span("filter"):
                state = fd.step_filter(state)
    return state.result


def window(fd, seed: int, seconds: float, traced: bool) -> tuple:
    """Solve until ``seconds`` have passed; returns ``(window_s, solves,
    results)``, ``results[i]`` the eigenpairs of solve i or its error."""
    solves, results = [], []
    before = halo_bytes(fd.exchange_summary())
    t_first = t_end = time.perf_counter()
    i = 0
    while True:
        V0, v0 = draws(fd, seed, i)
        spans = dict(init=0.0, analyze=0.0, filter=0.0)
        t0 = time.perf_counter()
        try:
            res = (_solve_traced(fd, V0, v0, spans) if traced
                   else fd.solve(V0=V0, v0=v0))
            sync(fd)
        except Exception as e:  # noqa: BLE001 — a failed solve is counted
            results.append(dict(error=f"{type(e).__name__}: {e}"))
            break
        t1 = t_end = time.perf_counter()
        del V0, v0
        after = halo_bytes(res.exchange)
        rec = dict(wall_s=t1 - t0, iterations=int(res.iterations),
                   total_spmvs=int(res.total_spmvs),
                   degrees=[int(h["degree"]) for h in res.history
                            if "degree" in h],
                   redist_s=float(res.redist_time),
                   halo_bytes=after - before)
        if traced:
            rec["spans"] = spans
        before = after
        solves.append(rec)
        results.append(dict(eigenvalues=np.asarray(res.eigenvalues),
                            eigenvectors=res.eigenvectors))
        i += 1
        if t1 - t_first >= seconds:
            break
    return t_end - t_first, solves, results


def run(cell: dict, seed: int, seconds: float, traced: bool,
        t_start: float, device) -> dict:
    """One run of the cell: set-up, the window, then the judgement."""
    import torch

    config, traffic = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    fd = build(config, traffic, device)
    warm_up(fd)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(fd.device)
        torch.cuda.reset_peak_memory_stats(fd.device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function("portbench::window"):
            window_s, solves, results = window(fd, seed, seconds, True)
        t0 = time.perf_counter()
        prof.stop()
        print(f"portbench: profiler stopped in {time.perf_counter() - t0:.1f}"
              " s", file=sys.stderr)
    else:
        window_s, solves, results = window(fd, seed, seconds, False)
    peak = torch.cuda.max_memory_allocated(fd.device) if cuda else 0
    summary = None
    if prof is not None:
        from ..harness.trace import summarize

        t0 = time.perf_counter()
        summary = summarize(prof)
        del prof
        print(f"portbench: trace read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    del fd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference: its own operator and eigenvalues, then every pair
    A = check.operator(config)
    n_target = int(config["fd"]["n_target"])
    lam = check.reference_eigenvalues(config, A, int(config["reference_k"]))
    verdict = check.judge(A, lam, results, n_target,
                          float(config["fd"]["target"]))
    limits = config["limits"]
    compared = {k: dict(value=verdict[k], limit=limits[k])
                for k in check.NUMBERS}
    failed = verdict["failed"]
    correct = bool(failed == 0 and solves
                   and all(c["value"] <= c["limit"]
                           for c in compared.values()))
    return dict(correct=correct, attempted=len(results), failed=failed,
                compared=compared,
                memory_peak_bytes=max(setup_peak, peak) if cuda else 0,
                run=Run(config=config, traffic=traffic, setup_s=setup_s,
                        window_s=window_s, solves=solves,
                        peak_mem_bytes=peak, A=A, trace=summary))
