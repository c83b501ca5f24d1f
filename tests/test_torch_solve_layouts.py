"""Whole solves in the vertical layer's layouts on the CPU: the port
against the JAX reference from the reference's draws, and the CLI with
``--layout panel`` and ``--layout pillar``.

The reference solves RoadNet(4000) (the roadnet48k config's SMOKE
matrix) at its upper edge (τ = 12.94) in the panel layout 4 × 2, the
pillar layout 1 × 4 and the panel layout 2 × 2, on the commvol row map in
the stack layout 8 × 1 and on the commvol + RCM map in the panel layout
4 × 2, kernels off, in one subprocess with 8 fake CPU devices on an
Auto-axis ``row × col`` mesh. Its ``jax.random`` draws (the key split of
``repro/core/filter_diag.py:410-418``: the Lanczos vector ``[D_pad, 1]``
in position space, the search block ``[D_pad, N_s]``, or ``[D, N_s]`` in
row order on a row map) come back with its results through an ``.npz``,
and the port starts from them.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import FDConfig, FilterDiag
from repro_torch.launch import solve as cli
from repro_torch.matrices import get_family
from tests.conftest import run_distributed

FD = dict(n_target=4, n_search=16, tol=1e-8, max_iters=40)
TARGET = 12.94  # 0.1 above RoadNet(4000)'s largest eigenvalue
#: (layout, n_row, n_col, row map)
CASES = {
    "panel-4x2": ("panel", 4, 2, {}),
    "pillar-1x4": ("pillar", 1, 4, {}),
    "panel-2x2": ("panel", 2, 2, {}),
    "stack-8x1-commvol": ("stack", 8, 1, dict(spmv_balance="commvol")),
    "panel-4x2-commvol-rcm": ("panel", 4, 2, dict(spmv_balance="commvol",
                                                  spmv_reorder="rcm")),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small, so more threads
    only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    m = dict(get_smoke_config("roadnet48k")["matrix"])
    return m.pop("family"), m


REF_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import FDConfig, FilterDiag
from repro.matrices import get_family
m = get_family({fam!r}, **{params!r})
out = {{}}
for case, (layout, n_row, n_col, plan) in {cases!r}.items():
    cfg = FDConfig(target={target!r}, layout=layout, **plan, **{fd!r})
    mesh = jax.make_mesh((n_row, n_col), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n_row * n_col])
    key = jax.random.PRNGKey(cfg.seed)
    with mesh:
        fd = FilterDiag(m, mesh, cfg)
        # compiled once: called eagerly, each Lanczos SpMV re-dispatches
        fd.spmv_stack = jax.jit(fd.spmv_stack)
        k0, k1 = jax.random.split(key)
        rows = fd.D_pad if fd.rowmap is None else fd.D
        out[case + "_v0"] = np.asarray(jax.random.normal(k0, (fd.D_pad, 1)))
        out[case + "_V0"] = np.asarray(
            jax.random.normal(k1, (rows, cfg.n_search)))
        res = fd.solve(key)
    out[case + "_eigenvalues"] = res.eigenvalues
    out[case + "_iterations"] = np.array(res.iterations)
    out[case + "_n_converged"] = np.array(res.n_converged)
    out[case + "_redistributions"] = np.array(res.redistributions)
    out[case + "_D_pad"] = np.array(fd.D_pad)
np.savez({path!r}, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    fam, params = _smoke()
    path = str(tmp_path_factory.mktemp("solve_layouts") / "ref.npz")
    run_distributed(REF_SCRIPT.format(fam=fam, params=params, cases=CASES,
                                      target=TARGET, fd=FD, path=path),
                    n_devices=8, timeout=900)
    return dict(np.load(path))


@pytest.mark.parametrize("case", list(CASES))
def test_layout_solve_matches_reference(reference, case):
    """From the reference's draws: eigenvalues within 1e-9 of the
    reference's, the same iterations, two redistributions an iteration
    when the filter runs in a panel or pillar layout, the same padded
    extent (the row map's), and eigenvectors in the original row order
    (``A·x = θ·x`` against the host CSR)."""
    layout, n_row, n_col, plan = CASES[case]
    fam, params = _smoke()
    m = get_family(fam, **params)
    cfg = FDConfig(target=TARGET, layout=layout, spmv_kernel=True,
                   **plan, **FD)
    fd = FilterDiag(m, cfg, device="cpu", n_row=n_row, n_col=n_col)
    assert fd.D_pad == int(reference[case + "_D_pad"])
    assert (not fd.rowmap.identity) == bool(plan)
    res = fd.solve(v0=reference[case + "_v0"], V0=reference[case + "_V0"])
    iters = int(reference[case + "_iterations"])
    assert res.n_converged == int(reference[case + "_n_converged"]) >= 4
    assert res.iterations == iters
    twice = 2 * iters if fd.N_col > 1 else 0
    assert res.redistributions == int(
        reference[case + "_redistributions"]) == twice
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(reference[case + "_eigenvalues"]),
                               rtol=0, atol=1e-9)
    A = m.build_csr().to_scipy()
    X = res.eigenvectors
    assert X.shape == (m.D, len(res.eigenvalues))
    assert np.abs(A @ X - X * res.eigenvalues).max() < 1e-7


@pytest.mark.parametrize("layout,grid,shown", [
    ("panel", ["--n-row", "2", "--n-col", "2"], "panel(2x2)"),
    ("pillar", ["--n-col", "4"], "pillar(1x4)"),
])
def test_cli_runs_the_layouts_on_the_cpu(capsys, layout, grid, shown):
    fam, params = _smoke()
    argv = ["--family", fam,
            "--params", ",".join(f"{k}={v}" for k, v in params.items()),
            "--n-target", "4", "--n-search", "16", "--target", str(TARGET),
            "--tol", "1e-8", "--max-iters", "40", "--spmv-kernel",
            "--layout", layout, *grid, "--redist-impl", "gspmd",
            "--device", "cpu"]
    res = cli.main(argv, verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4 and shown in out
    assert f"redistributions: {res.redistributions} (gspmd)" in out
    assert res.redistributions == 2 * res.iterations


@pytest.mark.parametrize("flags,shown", [
    (["--layout", "auto", "--n-row", "2"], "[auto] planned in"),
    (["--plan-mode", "sampled", "--spmv-balance", "commvol", "--n-row", "4",
      "--n-col", "2", "--layout", "panel"], "row map: RowMap(balance=commvol"),
])
def test_cli_runs_the_planner_flags(capsys, flags, shown):
    """``--layout auto`` plans over the splits of P shards and prints the
    ranking before it solves; ``--plan-mode sampled`` plans the commvol
    map from a row subsample."""
    fam, params = _smoke()
    argv = ["--family", fam,
            "--params", ",".join(f"{k}={v}" for k, v in params.items()),
            "--n-target", "4", "--n-search", "16", "--target", str(TARGET),
            "--tol", "1e-8", "--max-iters", "40", "--device", "cpu", *flags]
    res = cli.main(argv, verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4 and shown in out
    if "auto" in flags:
        assert "layout plan: RoadNet" in out and "machine=h100-1card" in out
