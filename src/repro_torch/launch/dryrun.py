"""Machine-model fitting: the port's counterpart of ``repro.launch.dryrun
--fit-machine`` (``repro/launch/dryrun.py:778-875``). The rest of the
reference's dry-run (lowering the eigen cells on a production mesh) is
not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --fit-machine fit.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --fit-machine fit.json \\
        --family Hubbard --params n_sites=12,n_fermions=6,U=25,ranpot=1 \\
        --n-devices 4 --n-search 512

The fitted model is what ``python -m repro_torch.launch.solve --layout
auto --machine fit.json`` plans with.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import perf_model as pm
from ..core.planner import comm_plan, estimate_nnzr
from ..core.shards import ShardGroup
from ..core.spmv import build_dist_ell, make_fused_cheb_step
from ..device import resolve_device
from ..matrices import get_family
from ..matrices.sparse import CSR
from .solve import parse_params

__all__ = ["fit_machine", "stream_copy_rate"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_copy_rate(device=None, n_bytes: int = 1 << 30,
                     reps: int = 10) -> float:
    """Memory bandwidth b_m [B/s] from a STREAM-style copy: a block of
    ``n_bytes`` copied ``reps`` times, the bytes read plus the bytes
    written over the fastest copy's time (STREAM's convention)."""
    device = resolve_device(device)
    n = max(int(n_bytes) // 8, 1)
    src = torch.ones(n, dtype=torch.float64, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    _sync(device)
    best = float("inf")
    for _ in range(max(int(reps), 1)):
        t0 = time.perf_counter()
        dst.copy_(src)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * 8 * n / best


def fit_machine(matrix=None, out_path: str | None = "machine_fit.json", *,
                n_devices: int = 8, n_search: int = 16, reps: int = 20,
                device=None, stream_bytes: int = 1 << 30,
                verbose: bool = True):
    """Calibrate the planner's machine constants from measured step times.

    Runs the real fused Chebyshev step in fp64 (the a2a engine, kernels
    on) of ``matrix`` (default SpinChainXXZ(12,6), as the reference)
    across the splits ``n_row × n_col`` with ``n_row ∈ {n_devices,
    n_devices/2, n_devices/4}`` and ``n_col = n_devices / n_row``: the
    operator at ``n_row`` row shards of one ``ShardGroup``, the block in
    ``n_col`` bundles of ``width / n_col`` columns, each bundle's step in
    turn.
    Each split is timed at the full width ``n_search`` and, where it has
    a halo (``n_row > 1``), at a *tiny* width ``n_col`` whose exchange
    moves almost nothing but launches the same rounds, so that the α
    column of ``MachineModel.fit`` is not collinear with the χ·bytes
    column. Each sample carries one round per step when ``n_row > 1``
    (one all_to_all). ``MachineModel.fit`` then fits κ, b_c and α.

    Two departures from the reference, both forced by one card:

    * **b_m is measured here**, by :func:`stream_copy_rate` on a block of
      ``stream_bytes`` (at least 1 GB on the card), as the paper fixes
      b_m from STREAM. The reference keeps b_m from its TPU base model.
    * **A sample's ``t`` is the step's wall time over ``n_devices``.**
      In the reference ``t`` is one device's time, the devices running
      at once; on one card the shards and bundles run one after
      another, so the wall time covers all ``n_devices`` of them.

    Writes the model to ``out_path`` (:func:`perf_model.save_machine`;
    None: not written) and returns ``(model, samples)``; each sample
    holds the fit's inputs, its split and width, and ``t_model``, the
    fitted model's Eq. 12 time for it.
    """
    device = resolve_device(device)
    if matrix is None:
        matrix = get_family("SpinChainXXZ", n_sites=12, n_up=6)
    csr = matrix if isinstance(matrix, CSR) else matrix.build_csr()
    label = (matrix.describe() if hasattr(matrix, "describe")
             else f"CSR{csr.shape}")
    D = csr.shape[0]
    n_nzr = estimate_nnzr(csr)
    D_pad = -(-D // n_devices) * n_devices
    b_m = stream_copy_rate(device, stream_bytes)
    if verbose:
        print(f"[fit-machine] b_m = {b_m / 1e9:.1f} GB/s (copy of "
              f"{stream_bytes} B on {device}); timing {label} fused "
              f"Chebyshev steps over {n_devices} shards", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    samples = []
    splits = sorted({n for n in (n_devices, n_devices // 2, n_devices // 4)
                     if n >= 1}, reverse=True)
    for n_row in splits:
        n_col = n_devices // n_row
        if n_search % n_col:
            continue
        ell = build_dist_ell(csr, n_row, dtype="float64", d_pad=D_pad,
                             device=device)
        S_d = int(ell.vals.element_size())
        cp = comm_plan(csr, n_row, d_pad=D_pad)
        chi_eng = pm.engine_chi(cp.moved_entries_per_device("a2a"), D, n_row)
        step = make_fused_cheb_step(ell, group=ShardGroup(n_row, device),
                                    use_kernel=True)
        rounds = 1.0 if n_row > 1 else 0.0  # one all_to_all per step
        widths = [n_search] + ([n_col] if n_row > 1 else [])
        for width in widths:
            n_b = width // n_col

            def block():
                x = torch.randn((n_col, D_pad, n_b), generator=gen,
                                dtype=torch.float64, device=device)
                x[:, D:] = 0
                return x.to(ell.vals.dtype)

            w1, w2 = block(), block()

            def run():
                return [step(w1[j], w2[j], 0.7, -0.2) for j in range(n_col)]

            y = run()  # first launches outside the timing
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                y = run()
            _sync(device)
            wall = (time.perf_counter() - t0) / reps
            del y, w1, w2
            samples.append(dict(t=wall / n_devices, D=D, N_p=n_row, n_b=n_b,
                                chi=chi_eng, n_nzr=n_nzr, S_d=S_d,
                                rounds=rounds, n_col=n_col, width=width,
                                wall=wall, route=step.kind))
            if verbose:
                print(f"[fit-machine] {n_row}x{n_col} n_b={n_b} "
                      f"({step.kind}): chi_eng={chi_eng:.3f} "
                      f"rounds={rounds:g} step wall={wall * 1e6:.1f}us "
                      f"t={wall / n_devices * 1e6:.1f}us", flush=True)
        del ell, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    fitted = pm.MachineModel.fit(samples, b_m=b_m, name="fitted-local")
    for s in samples:
        s["t_model"] = pm.cheb_iter_time(
            fitted, D=s["D"], N_p=s["N_p"], n_b=s["n_b"], chi=s["chi"],
            n_nzr=s["n_nzr"], S_d=s["S_d"], rounds=s["rounds"])
    if out_path is not None:
        pm.save_machine(fitted, out_path)
    if verbose:
        for s in samples:
            print(f"[fit-machine] {s['N_p']}x{s['n_col']} n_b={s['n_b']}: "
                  f"measured t={s['t'] * 1e6:.1f}us, model "
                  f"{s['t_model'] * 1e6:.1f}us")
        bc = fitted.b_c / 1e9
        print(f"[fit-machine] fitted b_c={bc:.2f} GB/s "
              f"kappa={fitted.kappa:.3f} alpha={fitted.alpha * 1e6:.2f}us "
              f"(b_m measured {fitted.b_m / 1e9:.1f} GB/s)"
              + (f" -> {out_path}" if out_path else ""), flush=True)
    return fitted, samples


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--fit-machine", required=True, metavar="PATH",
                    help="fit the machine model on measured fused-step "
                         "times and write it here as JSON (for "
                         "`solve --layout auto --machine PATH`)")
    ap.add_argument("--family", default=None,
                    help="fit on this family (with --params); default "
                         "SpinChainXXZ(12,6)")
    ap.add_argument("--params", default="")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="shards P of the splits P x 1, P/2 x 2, P/4 x 4")
    ap.add_argument("--n-search", type=int, default=16,
                    help="full block width of the timed steps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    matrix = (get_family(args.family, **parse_params(args.params))
              if args.family else None)
    fitted, _ = fit_machine(matrix, args.fit_machine,
                            n_devices=args.n_devices,
                            n_search=args.n_search, device=args.device,
                            stream_bytes=(1 << 30) if args.device == "cuda"
                            else 1 << 26)
    return fitted


if __name__ == "__main__":
    main()
