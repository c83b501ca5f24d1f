"""The port passes the three FD cases of ``tests/test_system.py``:
eigenvalues within 1e-7 of dense ``eigh``, residuals at most 1e-8. The
interior case runs with the kernels off (on the CPU the DIA kernel's plain
version loops over all of SpinChainXXZ(12,6)'s diagonals, which is slow);
the other two with them on.

The port starts from the reference's ``jax.random`` draws for the
reference's seed (handed over as numpy arrays): the extremal case converges
in 39 of its 40 allowed iterations from those draws, in the reference and in
the port alike, a margin that other draws need not leave.
"""
import numpy as np
import pytest
import jax

from repro_torch.core import FDConfig, FilterDiag
from repro_torch.matrices import Hubbard, SpinChainXXZ


@pytest.fixture(scope="module")
def spin_chain():
    csr = SpinChainXXZ(12, 6).build_csr()
    return csr, np.linalg.eigvalsh(csr.to_dense())


def _solve(mat, cfg):
    """Solve from the draws the reference's ``init_state`` makes."""
    k0, k1 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    D = mat.shape[0]
    v0 = np.asarray(jax.random.normal(k0, (D, 1), dtype=np.float64))
    V0 = np.asarray(jax.random.normal(k1, (D, cfg.n_search), dtype=np.float64))
    return FilterDiag(mat, cfg, device="cpu").solve(V0=V0, v0=v0)


def _check_pairs(mat, res, k):
    A = mat.to_scipy()
    X = res.eigenvectors[:, :k]
    r = np.linalg.norm(A @ X - X * res.eigenvalues[:k], axis=0)
    assert (r <= 1e-8).all() and (res.residuals[:k] <= 1e-8).all()


def test_fd_interior_eigenvalues_match_eigh(spin_chain):
    csr, w = spin_chain
    cfg = FDConfig(n_target=4, n_search=16, target=float(w[len(w) // 2]),
                   tol=1e-8, max_iters=25, layout="stack", spmv_kernel=False)
    res = _solve(csr, cfg)
    assert res.n_converged >= 4
    for ev in res.eigenvalues[:4]:
        assert np.abs(w - ev).min() < 1e-7
    _check_pairs(csr, res, 4)


def test_fd_extremal_eigenvalues(spin_chain):
    csr, w = spin_chain
    cfg = FDConfig(n_target=3, n_search=16, target=float(w[0]) - 0.1,
                   tol=1e-8, max_iters=40, layout="stack", spmv_kernel=True)
    res = _solve(csr, cfg)
    assert res.n_converged >= 3
    np.testing.assert_allclose(np.sort(res.eigenvalues[:3]), w[:3], atol=1e-7)
    _check_pairs(csr, res, 3)


@pytest.mark.parametrize("kernel", [True, False])
def test_fd_hubbard_with_interaction(kernel):
    csr = Hubbard(6, 3, U=4.0, ranpot=1.0).build_csr()
    w = np.linalg.eigvalsh(csr.to_dense())
    cfg = FDConfig(n_target=3, n_search=12, target=float(w[len(w) // 3]),
                   tol=1e-8, max_iters=25, layout="stack", spmv_kernel=kernel)
    res = _solve(csr, cfg)
    assert res.n_converged >= 3
    for ev in res.eigenvalues[:3]:
        assert np.abs(w - ev).min() < 1e-7
    _check_pairs(csr, res, 3)
