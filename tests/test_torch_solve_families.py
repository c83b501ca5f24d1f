"""Whole solves of the four families added after the first slice, port
against the JAX reference on the CPU, and the CLI on each.

Exciton(L=2) and TopIns(4) solve in complex128 (a complex family with
``dtype="float64"``), with the port's kernels on (the DIA route) and off;
RoadNet and HubNet at the matrices of their configs' ``SMOKE`` entries in
fp64 on the ELL route (no DIA form). The reference runs its stack-layout FD
with the kernels off on a (1, 1) Auto-axis mesh; the port starts from the
reference's ``jax.random`` draws, handed over as numpy arrays.

Targets: the complex cases sit 0.1 below the lowest eigenvalue. The graph
Laplacians' lowest eigenvalues (their configs' target 0) lie within 1e-5 of
each other at n = 4000, which drives every filter degree to the 200,000
cap (a port solve of RoadNet's took about 10 minutes on a CPU), so the
graph cases take the upper end of the spectrum instead: RoadNet 0.1 above
its largest eigenvalue, HubNet at 18.0, above its cluster of hub states
and below its two corridor states (21.99), where four targets do not
straddle the gap.
"""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import AxisType

from repro.core import FDConfig as JFDConfig, FilterDiag as JFilterDiag
from repro.matrices import get_family as jget_family

from repro_torch.configs import get_smoke_config
from repro_torch.core import FDConfig, FilterDiag
from repro_torch.launch import solve as cli
from repro_torch.matrices import get_family

CASES = {
    "exciton": ("Exciton", dict(L=2), "below"),
    "topins": ("TopIns", dict(Lx=4), "below"),
    "roadnet": ("RoadNet", None, "above"),
    "hubnet": ("HubNet", None, 18.0),
}
FD = dict(n_target=4, n_search=16, tol=1e-8, max_iters=40, layout="stack")


def _matrix(key):
    fam, params, _ = CASES[key]
    if params is None:  # the SMOKE config's matrix
        m = dict(get_smoke_config(f"{fam.lower()}48k")["matrix"])
        assert m.pop("family") == fam
        params = m
    return fam, params


def _target(key, w):
    side = CASES[key][2]
    if side == "below":
        return float(w[0]) - 0.1
    if side == "above":
        return float(w[-1]) + 0.1
    return float(side)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The reference's solve of one case, its draws, and dense eigh."""
    key = request.param
    fam, params = _matrix(key)
    jm = jget_family(fam, **params)
    w = np.linalg.eigvalsh(jm.build_csr().to_dense())
    cfg = JFDConfig(target=_target(key, w), **FD)
    k0, k1 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    draws = dict(v0=np.asarray(jax.random.normal(k0, (jm.D, 1))),
                 V0=np.asarray(jax.random.normal(k1, (jm.D, cfg.n_search))))
    mesh = jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2)
    with mesh:
        fd = JFilterDiag(jm, mesh, cfg)
        # compiled once: called eagerly, each Lanczos SpMV re-dispatches
        fd.spmv_stack = jax.jit(fd.spmv_stack)
        res = fd.solve(jax.random.PRNGKey(cfg.seed))
    return dict(key=key, fam=fam, params=params, cfg=cfg, draws=draws,
                res=res, w=w, complex=jm.is_complex)


def _nearest(w, target, k):
    return np.sort(w[np.argsort(np.abs(w - target))[:k]])


@pytest.mark.parametrize("kernel", [True, False])
def test_solve_matches_reference_and_eigh(case, kernel):
    """Both converge; eigenvalues within 1e-9 of the reference's and 1e-7
    of dense eigh; every returned pair re-checked on the host
    (‖A·x − θ·x‖ ≤ 1e-8). The complex cases run in complex128 and take
    the DIA route when the kernels are on; the graph cases take the ELL
    route either way. The iteration counts are not held equal: the two
    trajectories agree to 1e-15 in every search interval, but Exciton's
    triply degenerate pairs stall at residuals of 1e-9 to 5e-9, so which
    iteration first has all four under the tol of 1e-8 is rounding
    noise (the port stops at 28, the reference at 27)."""
    jres, cfg = case["res"], case["cfg"]
    mat = get_family(case["fam"], **case["params"])
    fd = FilterDiag(mat, FDConfig(target=cfg.target, spmv_kernel=kernel, **FD),
                    device="cpu")
    assert fd.dtype == (torch.complex128 if case["complex"] else torch.float64)
    takes_dia = getattr(fd.fused_step, "dia", None) is not None
    assert takes_dia == (kernel and case["complex"])
    res = fd.solve(**case["draws"])
    assert res.n_converged >= FD["n_target"] and jres.n_converged >= FD["n_target"]
    assert abs(res.iterations - jres.iterations) <= 1
    got = np.sort(res.eigenvalues)
    np.testing.assert_allclose(got, np.sort(jres.eigenvalues), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:4], _nearest(case["w"], cfg.target, 4),
                               rtol=0, atol=1e-7)
    A = mat.build_csr().to_scipy()
    X = res.eigenvectors
    assert np.linalg.norm(A @ X - X * res.eigenvalues, axis=0).max() <= 1e-8
    assert res.residuals.max() <= 1e-8


def test_cli_solves_each_family_on_cpu(case, capsys):
    """``python -m repro_torch.launch.solve --family ... --spmv-kernel
    --device cpu`` converges on each family (its own draws)."""
    params = ",".join(f"{k}={v}" for k, v in case["params"].items())
    res = cli.main(["--family", case["fam"], "--params", params,
                    "--n-target", "4", "--n-search", "16",
                    "--target", repr(case["cfg"].target), "--tol", "1e-8",
                    "--max-iters", "40", "--spmv-kernel", "--device", "cpu"],
                   verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4 and "kernel launches: ell_gather=" in out
    np.testing.assert_allclose(
        np.sort(res.eigenvalues)[:4],
        _nearest(case["w"], case["cfg"].target, 4), rtol=0, atol=1e-7)
