"""``layout="auto"`` and ``plan_mode="sampled"`` end to end on the CPU,
the port against the JAX reference.

* ``FDConfig(layout="auto")`` on one shard is numerics-neutral: the same
  eigenvalues, bit for bit, as the explicit layout.
* ``--layout auto`` on RoadNet(4000) at P = 8 under the reference's
  ``tpu-v5e`` model (its values written with ``save_machine`` and passed
  as ``--machine PATH``) picks the candidate the reference CLI's auto
  solve picks, and its eigenvalues match that solve's to 1e-9.
* A ``plan_mode="sampled"`` commvol solve of HubNet(4000) at P = 4 plans
  the reference's row map and, from the reference's draws, matches its
  eigenvalues to 1e-9 over eight outer iterations (an interior target of
  HubNet(4000) takes 18+ iterations and 20–40 s to converge on the CPU,
  so the pairs are compared as the driver returns them at ``max_iters``),
  and so does the CLI's plan with ``--plan-mode sampled``.

The reference runs once, in one subprocess with 8 fake CPU devices, on
Auto-axis ``row × col`` meshes (ROADMAP, "Parity recipes"): the
reference CLI's planning steps (``repro/launch/solve.py:70-112``) are
replayed there on such a mesh, since the CLI's own mesh has Explicit
axes.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import perf_model as ref_pm
from repro.core.partition import plan_rowmap as ref_plan_rowmap
from repro.matrices import get_family as ref_family
from repro_torch import convert
from repro_torch.core import FDConfig, FilterDiag
from repro_torch.core import perf_model as pm
from repro_torch.core.partition import plan_rowmap
from repro_torch.launch import solve as cli
from repro_torch.matrices import SpinChainXXZ, get_family
from tests.conftest import run_distributed

FD = dict(n_target=4, n_search=16, tol=1e-8, max_iters=40)
ROADNET = ("RoadNet", dict(n=4000, w=2, m=256, k=4), 12.94)
#: an interior target of HubNet(4000) (its eigenvalues near 17.0028)
HUBNET = ("HubNet", dict(n=4000, w=2, h=4, m=192, k=4), 17.0)
SAMPLED = dict(spmv_balance="commvol", plan_mode="sampled", max_iters=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_SCRIPT = r"""
import dataclasses, json
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import FDConfig, FilterDiag
from repro.core import perf_model as pm
from repro.matrices import get_family
from repro.service.plan_cache import cached_plan_layout

def solve(m, fd, n_row, n_col, rowmap=None, draws=None):
    mesh = jax.make_mesh((n_row, n_col), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n_row * n_col])
    key = jax.random.PRNGKey(fd.seed)
    with mesh:
        fdd = FilterDiag(m, mesh, fd, rowmap=rowmap)
        # compiled once: called eagerly, each Lanczos SpMV re-dispatches
        fdd.spmv_stack = jax.jit(fdd.spmv_stack)
        if draws is not None:  # the draws of init_state (filter_diag.py:410)
            k0, k1 = jax.random.split(key)
            rows = fdd.D_pad if fdd.rowmap is None else fdd.D
            draws["v0"] = np.asarray(jax.random.normal(k0, (fdd.D_pad, 1)))
            draws["V0"] = np.asarray(
                jax.random.normal(k1, (rows, fd.n_search)))
        res = fdd.solve(key)
    return fdd, res

out = {{}}
# the reference CLI's --layout auto on 8 devices (launch/solve.py:70-112)
fam, params, target = {roadnet!r}
m = get_family(fam, **params)
fd = FDConfig(target=target, layout="auto", **{fd!r})
plan, _ = cached_plan_layout(
    m, 8, n_search=fd.n_search, cache=None, d_pad=-(-m.D // 8) * 8,
    machine=pm.TPU_V5E, reorder=tuple(dict.fromkeys(("none", fd.spmv_reorder))),
    kernel=tuple(dict.fromkeys((False, fd.spmv_kernel))),
    sstep=tuple(dict.fromkeys((1, fd.spmv_sstep))), plan_mode=fd.plan_mode)
best = plan.best
fd = dataclasses.replace(fd, layout="panel", spmv_overlap=best.overlap,
                         spmv_comm=best.comm, spmv_schedule=best.schedule,
                         spmv_balance=best.balance,
                         spmv_reorder=best.reorder,
                         spmv_kernel=best.kernel, spmv_sstep=best.sstep)
_, res = solve(m, fd, best.n_row, best.n_col, rowmap=best.rowmap)
out["auto"] = dict(best=best.describe(),
                   eigenvalues=[float(v) for v in res.eigenvalues],
                   n_converged=int(res.n_converged))
# a sampled commvol solve at P = 4 in the stack layout
fam, params, target = {hubnet!r}
m = get_family(fam, **params)
fd = FDConfig(target=target, layout="stack", **{{**{fd!r}, **{sampled!r}}})
draws = {{}}
fdd, res = solve(m, fd, 4, 1, draws=draws)
out["sampled"] = dict(
    boundaries=None if fdd.rowmap is None
    else [int(b) for b in fdd.rowmap.boundaries],
    eigenvalues=[float(v) for v in res.eigenvalues],
    iterations=int(res.iterations))
np.savez({path!r}, **draws)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("solve_auto") / "draws.npz")
    out = run_distributed(REF_SCRIPT.format(roadnet=ROADNET, hubnet=HUBNET,
                                            fd=FD, sampled=SAMPLED,
                                            path=path))
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    res["draws"] = dict(np.load(path))
    return res


def _argv(case, *flags):
    fam, params, target = case
    return ["--family", fam,
            "--params", ",".join(f"{k}={v}" for k, v in params.items()),
            "--n-target", str(FD["n_target"]),
            "--n-search", str(FD["n_search"]), "--target", str(target),
            "--tol", str(FD["tol"]), "--max-iters", str(FD["max_iters"]),
            "--device", "cpu", *flags]


def _same_eigenvalues(mine, theirs):
    a, b = np.sort(mine), np.sort(np.asarray(theirs))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_auto_on_one_shard_is_numerics_neutral():
    """layout='auto' on a 1 × 1 grid plans the 1 × 1 split and solves
    exactly as the explicit layout does (``tests/test_planner.py:228``);
    the caller's config is left as it was."""
    m = SpinChainXXZ(8, 4)
    csr = m.build_csr()
    w = np.linalg.eigvalsh(csr.to_dense())
    res = {}
    for lay in ("panel", "auto"):
        cfg = FDConfig(n_target=4, n_search=16, target=float(w[len(w) // 2]),
                       tol=1e-8, max_iters=20, layout=lay)
        fd = FilterDiag(csr, cfg, device="cpu")
        if lay == "auto":
            assert fd.plan is not None
            assert fd.plan.best.n_row * fd.plan.best.n_col == 1
            assert cfg.layout == "auto" and fd.cfg.layout != "auto"
        res[lay] = fd.solve()
    assert res["auto"].n_converged >= 4
    np.testing.assert_array_equal(res["auto"].eigenvalues,
                                  res["panel"].eigenvalues)


def test_cli_auto_picks_the_references_candidate(ref, tmp_path, capsys):
    path = str(tmp_path / "tpu-v5e.json")
    pm.save_machine(convert.machine_from_fields(ref_pm.TPU_V5E), path)
    res = cli.main(_argv(ROADNET, "--layout", "auto", "--n-row", "8",
                         "--machine", path), verbose=False)
    out = capsys.readouterr().out
    assert "machine=tpu-v5e-chip" in out
    assert f"running {ref['auto']['best']} " in out, out
    assert res.n_converged >= 4 and ref["auto"]["n_converged"] >= 4
    _same_eigenvalues(res.eigenvalues, ref["auto"]["eigenvalues"])


def test_sampled_commvol_solve_matches_the_reference(ref, capsys):
    fam, params, target = HUBNET
    m = get_family(fam, **params)
    kw = dict(balance="commvol", plan_mode="sampled")
    rm = plan_rowmap(m, 4, **kw)
    want = ref_plan_rowmap(ref_family(fam, **params), 4, **kw)
    assert np.array_equal(rm.boundaries, want.boundaries)
    assert rm.boundaries.tolist() == ref["sampled"]["boundaries"]
    cfg = FDConfig(target=target, layout="stack", **{**FD, **SAMPLED})
    fd = FilterDiag(m, cfg, device="cpu", n_row=4)
    assert np.array_equal(fd.rowmap.boundaries, rm.boundaries)
    res = fd.solve(v0=ref["draws"]["v0"], V0=ref["draws"]["V0"])
    assert res.iterations == ref["sampled"]["iterations"] == 8
    _same_eigenvalues(res.eigenvalues, ref["sampled"]["eigenvalues"])
    # the CLI's flag plans the same map
    cli.main(_argv(HUBNET, "--n-row", "4", "--spmv-balance", "commvol",
                   "--plan-mode", "sampled", "--max-iters", "1"),
             verbose=False)
    assert f"rows/block {int(np.diff(rm.boundaries).min())}.." \
        in capsys.readouterr().out
