"""Whole solves over P row shards (the horizontal layer) on the CPU: the
port against the JAX reference, the port at P > 1 against its own P = 1,
and the CLI with ``--n-row``.

The reference solves RoadNet(4000) (the roadnet48k config's SMOKE matrix)
at P = 4 in the stack layout with the a2a split-phase engine, kernels off,
in one subprocess with 8 fake CPU devices on an Auto-axis mesh; its
``jax.random`` draws (the key split of ``repro/core/filter_diag.py:410-418``)
come back with its result through an ``.npz``, and the port starts from
them. The reference is solved once: its engines agree bit for bit, so
its other P and engines take the same road (a scratch run at P = 8,
compressed with matching rounds, gave the same iterations and
eigenvalues). Port against port shares numpy draws.

Targets: the upper edge of the graph Laplacians (τ 0.1 above the largest
eigenvalue), where they converge in seconds; at the lower edge their
eigenvalues lie within 1e-5 of each other and every filter degree hits
the 200,000 cap. Exciton(L=2) (D = 375) at P = 8 pads the last shard
(D_pad = 376) and solves at its lower edge in complex128.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import FDConfig, FilterDiag
from repro_torch.launch import solve as cli
from repro_torch.matrices import get_family
from tests.conftest import run_distributed

FD = dict(n_target=4, n_search=16, tol=1e-8, max_iters=40, layout="stack")
ROADNET_TARGET = 12.94  # 0.1 above RoadNet(4000)'s largest eigenvalue


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small, so more threads
    only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(name):
    m = dict(get_smoke_config(name)["matrix"])
    return m.pop("family"), m


REF_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import FDConfig, FilterDiag
from repro.matrices import get_family
m = get_family({fam!r}, **{params!r})
P = 4
cfg = FDConfig(target={target!r}, spmv_overlap=True, spmv_comm="a2a",
               **{fd!r})
mesh = jax.make_mesh((P, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:P])
key = jax.random.PRNGKey(cfg.seed)
with mesh:
    fd = FilterDiag(m, mesh, cfg)
    # compiled once: called eagerly, each Lanczos SpMV re-dispatches
    fd.spmv_stack = jax.jit(fd.spmv_stack)
    k0, k1 = jax.random.split(key)
    v0 = np.asarray(jax.random.normal(k0, (fd.D_pad, 1)))
    V0 = np.asarray(jax.random.normal(k1, (fd.D_pad, cfg.n_search)))
    res = fd.solve(key)
np.savez({path!r}, eigenvalues=res.eigenvalues, residuals=res.residuals,
         iterations=res.iterations, n_converged=res.n_converged, v0=v0, V0=V0)
print("ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    fam, params = _smoke("roadnet48k")
    path = str(tmp_path_factory.mktemp("solve_dist") / "ref.npz")
    run_distributed(REF_SCRIPT.format(fam=fam, params=params,
                                      target=ROADNET_TARGET, fd=FD,
                                      path=path), n_devices=8, timeout=900)
    return dict(np.load(path))


def _solve(fam, params, target, P, draws, **engine):
    cfg = FDConfig(target=target, spmv_kernel=True, **{**FD, **engine})
    fd = FilterDiag(get_family(fam, **params), cfg, device="cpu", n_row=P)
    return fd, fd.solve(**draws)


def _draws(D, seed=5):
    rng = np.random.default_rng(seed)
    return dict(v0=rng.standard_normal((D, 1)),
                V0=rng.standard_normal((D, FD["n_search"])))


@pytest.fixture(scope="module")
def roadnet_one_shard():
    fam, params = _smoke("roadnet48k")
    draws = _draws(4000)
    return draws, _solve(fam, params, ROADNET_TARGET, 1, draws)[1]


def test_fd_at_four_shards_matches_reference(reference):
    """RoadNet(4000), P = 4, a2a split-phase, from the reference's draws:
    eigenvalues within 1e-9, iterations within one, the exchange bytes
    counted, the eigenvectors [D, k] on the host."""
    fam, params = _smoke("roadnet48k")
    draws = dict(v0=reference["v0"], V0=reference["V0"])
    fd, res = _solve(fam, params, ROADNET_TARGET, 4, draws,
                     spmv_overlap=True, spmv_comm="a2a")
    assert fd.engine == "a2a-overlap" and fd.ell.L > 0
    assert fd.group.bytes["all_to_all"] > 0 and fd.group.bytes["ppermute"] > 0
    assert res.n_converged >= 4 and res.n_converged == int(
        reference["n_converged"])
    assert abs(res.iterations - int(reference["iterations"])) <= 1
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(reference["eigenvalues"]),
                               rtol=0, atol=1e-9)
    assert res.eigenvectors.shape == (fd.D, len(res.eigenvalues))


@pytest.mark.parametrize("P,engine", [
    (8, dict(spmv_comm="compressed", spmv_schedule="matching")),
    (2, dict(spmv_comm="a2a")),
    (8, dict(spmv_comm="compressed", spmv_overlap=True)),
], ids=["8-compressed-matching", "2-a2a", "8-compressed-overlap"])
def test_fd_row_shards_match_one_shard(roadnet_one_shard, P, engine):
    """The port at P shards equals its own P = 1 solve on the same draws:
    eigenvalues within 1e-9, iterations within one."""
    draws, one = roadnet_one_shard
    fam, params = _smoke("roadnet48k")
    fd, res = _solve(fam, params, ROADNET_TARGET, P, draws, **engine)
    assert fd.P == P
    assert res.n_converged == one.n_converged >= 4
    assert abs(res.iterations - one.iterations) <= 1
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(one.eigenvalues), rtol=0, atol=1e-9)


def test_hubnet_eight_shards_matching_at_its_upper_edge():
    """HubNet(4000) at P = 8 with the compressed matching engine, τ 0.1
    above its largest eigenvalue (``eigsh``): equal to the P = 1 solve to
    1e-9, each eigenvalue one of ``eigvalsh``'s. Two targets: its two
    corridor states (21.99) stand 4.0 above a cluster of hub states
    (17.95–17.98) whose near-degenerate pairs a third and fourth target
    would straddle (at n_target = 4 only the two converged in 200
    iterations); the pair takes ~70 iterations from the spectral bulk."""
    fam, params = _smoke("hubnet48k")
    A = get_family(fam, **params).build_csr()
    top = float(sla.eigsh(A.to_scipy(), k=1, which="LA",
                          return_eigenvectors=False)[0])
    draws = _draws(A.shape[0], seed=6)
    hub = dict(n_target=2, max_iters=150)
    _, one = _solve(fam, params, top + 0.1, 1, draws, **hub)
    fd, res = _solve(fam, params, top + 0.1, 8, draws,
                     spmv_comm="compressed", spmv_schedule="matching", **hub)
    assert fd.engine == "compressed-matching"
    assert res.n_converged == one.n_converged >= 2
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(one.eigenvalues), rtol=0, atol=1e-9)
    w = np.linalg.eigvalsh(A.to_dense())
    for ev in res.eigenvalues:
        assert np.abs(w - ev).min() < 1e-7


def test_padded_shards_keep_the_pad_zero():
    """Exciton(L=2), D = 375, complex128, at P = 8 (D_pad = 376, the
    compressed split-phase engine), τ 0.1 below its lowest eigenvalue: the
    pad row stays exactly zero in the search block through every
    iteration, and the solve equals P = 1 to 1e-9."""
    tm = get_family("Exciton", L=2)
    w = np.linalg.eigvalsh(tm.build_csr().to_dense())
    draws = _draws(tm.D, seed=7)
    cfg = FDConfig(target=float(w[0]) - 0.1, spmv_kernel=True, **FD)
    one = FilterDiag(tm, cfg, device="cpu").solve(**draws)
    cfg8 = dataclasses.replace(cfg, spmv_overlap=True, spmv_comm="compressed")
    fd = FilterDiag(tm, cfg8, device="cpu", n_row=8)
    assert (fd.D, fd.D_pad) == (375, 376) and fd.dtype == torch.complex128
    state = fd.init_state(**draws)
    assert state.V.shape == (376, FD["n_search"]) and not state.V[375:].any()
    while not state.done:
        state = fd.step(state)
        assert not state.V[375:].any()
    res = state.result
    assert res.eigenvectors.shape == (375, len(res.eigenvalues))
    assert res.n_converged >= 4 and one.n_converged >= 4
    assert abs(res.iterations - one.iterations) <= 1
    np.testing.assert_allclose(np.sort(res.eigenvalues)[:4],
                               np.sort(one.eigenvalues)[:4], rtol=0,
                               atol=1e-9)


def test_cli_runs_row_shards_on_the_cpu(capsys):
    fam, params = _smoke("roadnet48k")
    argv = ["--family", fam,
            "--params", ",".join(f"{k}={v}" for k, v in params.items()),
            "--n-target", "4", "--n-search", "16", "--target",
            str(ROADNET_TARGET), "--tol", "1e-8", "--max-iters", "40",
            "--spmv-kernel", "--n-row", "4", "--spmv-comm", "compressed",
            "--spmv-overlap", "--device", "cpu"]
    res = cli.main(argv, verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4
    assert "stack(4x1)" in out and "compressed-cyclic-overlap" in out
    # a 4 x 2 grid: the stack layout over its 8 row shards, or the panel
    for layout, shown in (("stack", "stack(8x1)"), ("panel", "panel(4x2)")):
        res = cli.main(argv + ["--n-col", "2", "--layout", layout],
                       verbose=False)
        out = capsys.readouterr().out
        assert res.n_converged >= 4 and shown in out
        assert (res.redistributions > 0) == (layout == "panel")


def test_unported_shapes_raise():
    fam, params = _smoke("roadnet48k")
    m = get_family(fam, **params)
    with pytest.raises(ValueError, match="power-of-two"):
        FilterDiag(m, FDConfig(layout="stack"), device="cpu", n_row=3)
    # SVQB needs no butterfly: any P
    fd = FilterDiag(m, FDConfig(layout="stack", ortho="svqb"), device="cpu",
                    n_row=3)
    assert fd.D_pad == 4002 and fd.ell.R == 1334
    assert isinstance(fd.orthogonalize(torch.ones(4002, 2,
                                                  dtype=torch.float64)),
                      torch.Tensor)
