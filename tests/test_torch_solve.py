"""Whole solves of the port against the JAX reference, and the CLI.

The reference runs its stack-layout FD with the kernels off on a (1, 1)
Auto-axis mesh (its interpret-mode kernels take minutes for a solve, and
its own tests already hold kernel-on equal to kernel-off). The port starts
from the reference's ``jax.random`` draws, handed over as numpy arrays, and
runs with its kernels on (on the CPU: their plain versions).
"""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import AxisType

from repro.core import FDConfig as JFDConfig, FilterDiag as JFilterDiag
from repro.matrices import SpinChainXXZ as JSpinChain

from repro_torch import convert
from repro_torch.core import FDConfig, FilterDiag
from repro_torch.launch import solve as cli
from repro_torch.matrices import SpinChainXXZ

CASE = dict(n_target=4, n_search=16, tol=1e-8, max_iters=25, layout="stack")


@pytest.fixture(scope="module")
def reference():
    """Reference solve of SpinChainXXZ(10,5) at an interior target, with
    the draws it made and its state after one full iteration."""
    jm = JSpinChain(10, 5)
    w = np.linalg.eigvalsh(jm.build_csr().to_dense())
    cfg = JFDConfig(target=float(w[len(w) // 2]), **CASE)
    key = jax.random.PRNGKey(cfg.seed)
    k0, k1 = jax.random.split(key)
    draws = dict(v0=np.asarray(jax.random.normal(k0, (jm.D, 1))),
                 V0=np.asarray(jax.random.normal(k1, (jm.D, cfg.n_search))))
    mesh = jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2)
    with mesh:
        fd = JFilterDiag(jm, mesh, cfg)
        # the same SpMV, compiled once: called eagerly, each of Lanczos's
        # 30 calls re-dispatches the shard_map (~0.7 s a call on the CPU)
        fd.spmv_stack = jax.jit(fd.spmv_stack)
        state = fd.step(fd.init_state(key))  # == fd.solve(key), stepwise
        one_step = dict(V=np.asarray(state.V), lam=state.lam,
                        total_spmvs=state.total_spmvs)
        while not state.done:
            state = fd.step(state)
    return dict(cfg=cfg, draws=draws, res=state.result, w=w, one_step=one_step)


def test_solve_matches_reference_from_its_draws(reference):
    """Same n_converged, eigenvalues within 1e-9, and every returned pair
    re-checked on the host."""
    jres = reference["res"]
    cfg = FDConfig(target=reference["cfg"].target, spmv_kernel=True, **CASE)
    res = FilterDiag(SpinChainXXZ(10, 5), cfg, device="cpu").solve(
        **reference["draws"])
    assert res.n_converged == jres.n_converged >= 4
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(jres.eigenvalues), rtol=0, atol=1e-9)
    A = SpinChainXXZ(10, 5).build_csr().to_scipy()
    X = res.eigenvectors
    assert np.abs(A @ X - X * res.eigenvalues).max(axis=0).max() <= 1e-8


def test_state_carried_across_continues_the_reference(reference):
    """From the reference's state after one iteration (``convert``), the
    port's next analysis picks the filter the reference picked next."""
    one = reference["one_step"]
    cfg = FDConfig(target=reference["cfg"].target, **CASE)
    fd = FilterDiag(SpinChainXXZ(10, 5), cfg, device="cpu")
    state = convert.fd_state_from_arrays(one["V"], one["lam"], iteration=1,
                                         total_spmvs=one["total_spmvs"],
                                         device="cpu")
    state = fd.step_analyze(state)
    jhist = reference["res"].history[1]
    assert state.history[-1]["n_conv"] == jhist["n_conv"]
    np.testing.assert_allclose(state.history[-1]["search"], jhist["search"],
                               rtol=1e-9)


@pytest.mark.parametrize("ortho", ["tsqr", "svqb"])
def test_kernels_only_ever_get_row_major_blocks(ortho):
    """The CUDA wrappers refuse non-contiguous operands, and the QR
    routines return Q column-major: every block the solve hands to an
    SpMV or a fused step must be row-major. Checked here on the CPU,
    where the plain versions would take any layout."""
    cfg = FDConfig(n_target=3, n_search=12, target=-4.5, tol=1e-8,
                   max_iters=6, layout="stack", spmv_kernel=True, ortho=ortho)
    fd = FilterDiag(SpinChainXXZ(10, 5), cfg, device="cpu")
    seen = []
    spmv, step = fd.spmv, fd.fused_step

    def spmv_checked(x):
        seen.append(x.is_contiguous())
        return spmv(x)

    def step_checked(w1, w2, a, b):
        seen.append(w1.is_contiguous() and w2.is_contiguous())
        return step(w1, w2, a, b)

    fd.spmv, fd.fused_step = spmv_checked, step_checked
    fd.solve()
    assert len(seen) > cfg.lanczos_steps and all(seen)


def test_cli_solves_on_cpu(capsys):
    res = cli.main(["--family", "SpinChainXXZ", "--params", "n_sites=10,n_up=5",
                    "--n-target", "3", "--n-search", "16", "--target", "-4.5",
                    "--tol", "1e-8", "--max-iters", "40", "--layout", "stack",
                    "--spmv-kernel", "--device", "cpu"], verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 3
    assert "converged" in out and "kernel launches: ell_gather=" in out
    w = np.linalg.eigvalsh(SpinChainXXZ(10, 5).build_csr().to_dense())
    np.testing.assert_allclose(np.sort(res.eigenvalues)[:3], w[:3], atol=1e-7)


def test_cli_defaults_to_cuda():
    args = cli.build_parser().parse_args(["--family", "Hubbard"])
    assert args.device == "cuda"
    assert args.layout == "stack" and not args.spmv_kernel
    cfg = cli.config_from_args(args)
    assert (cfg.dtype, cfg.ortho, cfg.layout) == ("float64", "tsqr", "stack")


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FDConfig(**CASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilterDiag(SpinChainXXZ(6, 3), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilterDiag(SpinChainXXZ(6, 3), cfg, device="cuda")


@pytest.mark.parametrize("change,error,match", [
    (dict(layout="auto"), NotImplementedError, "not ported yet"),
    (dict(spmv_comm="compressed", spmv_sstep=2), NotImplementedError,
     "not ported yet"),
    (dict(spmv_sstep=2), NotImplementedError, "not ported yet"),
    (dict(plan_mode="sampled", spmv_balance="commvol"), NotImplementedError,
     "not ported yet"),
    (dict(redist_impl="nccl"), ValueError, "unknown redist_impl"),
], ids=["layout-auto", "compressed-sstep", "sstep", "sampled-commvol",
        "redist-impl"])
def test_unported_options_raise(change, error, match):
    """What is not ported yet raises ``NotImplementedError`` naming
    ROADMAP; an option value that does not exist raises ``ValueError``."""
    cfg = FDConfig(**{**CASE, **change})
    with pytest.raises(error, match=match):
        FilterDiag(SpinChainXXZ(6, 3), cfg, device="cpu")


def test_default_config_solves_as_stack():
    """``FDConfig()`` asks for the panel layout (the reference's default);
    on one shard (``n_col = 1``) that is the stack layout, and it solves:
    the ten eigenvalues nearest 0 of SpinChainXXZ(10,5), as ``eigh``."""
    m = SpinChainXXZ(10, 5)
    fd = FilterDiag(m, FDConfig(), device="cpu")
    assert fd.layout.describe() == "panel(1x1)" and fd.N_col == 1
    res = fd.solve()
    assert res.n_converged >= 10 and res.redistributions == 0
    w = np.linalg.eigvalsh(m.build_csr().to_dense())
    for ev in res.eigenvalues:
        assert np.abs(w - ev).min() < 1e-8


def test_complex128_on_a_real_operator_solves_like_the_reference(reference):
    """``dtype="complex128"`` on a real operator (complex is no longer
    refused): the block, the operator's values and every SpMV are complex,
    and the solve from the reference's draws matches the reference's
    complex128 solve to 1e-9, with the same iterations."""
    jm = JSpinChain(10, 5)
    cfg = dict(CASE, target=reference["cfg"].target, dtype="complex128")
    mesh = jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2)
    with mesh:
        jfd = JFilterDiag(jm, mesh, JFDConfig(**cfg))
        jfd.spmv_stack = jax.jit(jfd.spmv_stack)
        jres = jfd.solve(jax.random.PRNGKey(jfd.cfg.seed))
    fd = FilterDiag(SpinChainXXZ(10, 5), FDConfig(spmv_kernel=True, **cfg),
                    device="cpu")
    assert fd.dtype == torch.complex128 and fd.ell.vals.dtype == torch.complex128
    res = fd.solve(**reference["draws"])
    assert res.n_converged == jres.n_converged >= 4
    assert res.iterations == jres.iterations
    assert res.eigenvectors.dtype == np.complex128
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(jres.eigenvalues), rtol=0, atol=1e-9)
    w = reference["w"]
    for ev in res.eigenvalues:
        assert np.abs(w - ev).min() < 1e-7


def test_stop_rule_steps_over_a_late_pair_as_the_reference_does():
    """FD stops once ``n_target`` Ritz pairs inside the target window have
    converged (the reference's rule, ``repro/core/filter_diag.py:467``),
    so a pair of the window that converges later is stepped over. On a
    diagonal operator with eigenvalues 0, 1, 2, 3, 3.05, 10, 11, … and a
    search block of unit vectors whose third is off its eigenvector by
    1e-6, both packages stop at once for n_target = 4 and return 0, 1, 3
    and 3.05; the port records the pair at 2 as the window's unconverged
    one."""
    import jax.numpy as jnp

    from repro.core.filter_diag import FDState as JFDState
    from repro.matrices.sparse import CSR as JCSR
    from repro_torch.matrices.sparse import CSR

    D, N_s = 64, 8
    d = np.concatenate([[0.0, 1.0, 2.0, 3.0, 3.05], 10.0 + np.arange(D - 5)])
    pattern = (np.arange(D + 1, dtype=np.int64), np.arange(D, dtype=np.int64))
    V = np.eye(D)[:, :N_s]
    V[40, 2] = 1e-6
    lam = (-0.5, float(d[-1]) + 0.5)
    kw = dict(n_target=4, n_search=N_s, target=-0.1, tol=1e-8,
              layout="stack")
    mesh = jax.make_mesh((1, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh:
        jfd = JFilterDiag(JCSR(*pattern, d, (D, D)), mesh, JFDConfig(**kw))
        jstate = jfd.step_analyze(JFDState(V=jnp.asarray(V), lam=lam))
    fd = FilterDiag(CSR(*pattern, d, (D, D)), FDConfig(**kw), device="cpu")
    state = fd.step_analyze(convert.fd_state_from_arrays(V, lam,
                                                         device="cpu"))
    want = [0.0, 1.0, 3.0, 3.05]
    for st in (jstate, state):
        assert st.done and st.result.n_converged == 4
        np.testing.assert_allclose(np.sort(st.result.eigenvalues), want,
                                   rtol=0, atol=1e-12)
    (theta, res), = state.history[-1]["unconverged"]
    assert abs(theta - 2.0) < 1e-9 and res > kw["tol"]
