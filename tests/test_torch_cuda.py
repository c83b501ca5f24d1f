"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU mode). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FDConfig, FilterDiag
from repro_torch.kernels import build, ops, ref
from repro_torch.matrices import Hubbard

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    return 1e-13 if dtype == torch.float64 else 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,Rx,W,nb", [(1000, 1500, 9, 1), (777, 777, 13, 64),
                                       (513, 600, 5, 100)])
def test_ell_gather_kernel_vs_plain(card, R, Rx, W, nb, dtype):
    g = torch.Generator(device=card).manual_seed(R)
    cols = torch.randint(0, Rx, (R, W), generator=g, device=card,
                         dtype=torch.int32)
    vals = torch.randn((R, W), generator=g, device=card, dtype=dtype)
    vals[torch.rand((R, W), generator=g, device=card) < 0.2] = 0
    x = torch.randn((Rx, nb), generator=g, device=card, dtype=dtype)
    y0 = torch.randn((R, nb), generator=g, device=card, dtype=dtype)
    n0 = build.launches["ell_gather"]
    got = ops.ell_spmv(cols, vals, x, y0)
    got0 = ops.ell_spmv(cols, vals, x)
    torch.cuda.synchronize()
    assert build.launches["ell_gather"] == n0 + 2
    want = ref.ell_spmv_acc_ref(y0, cols, vals, x)
    assert (got - want).abs().max() <= _tol(dtype) * want.abs().max()
    want0 = ref.ell_spmv_ref(cols, vals, x)
    assert (got0 - want0).abs().max() <= _tol(dtype) * want0.abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cheb_dia_kernel_vs_plain(card, dtype):
    rng = np.random.default_rng(1)
    R, Rx, nb = 1000, 1100, 70
    offsets = (-300, -9, -1, 0, 1, 9, 300, 650)
    dv = rng.standard_normal((len(offsets), R))
    idx = np.arange(R)
    for d, o in enumerate(offsets):
        dv[d, (idx + o < 0) | (idx + o >= Rx)] = 0.0
    dvals = torch.as_tensor(dv, device=card).to(dtype)
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn((Rx, nb), generator=g, device=card, dtype=dtype)
    w2 = torch.randn((R, nb), generator=g, device=card, dtype=dtype)
    w1 = x[:R].contiguous()
    n0 = build.launches["cheb_dia"]
    got = ops.cheb_dia(offsets, dvals, x, w1, w2, 0.8, -0.1)
    torch.cuda.synchronize()
    assert build.launches["cheb_dia"] == n0 + 1
    want = ref.cheb_dia_ref(offsets, dvals, x, w1, w2, 0.8, -0.1)
    assert (got - want).abs().max() <= _tol(dtype) * want.abs().max()


def test_kernels_refuse_what_they_cannot_take(card):
    x = torch.ones((8, 2), device=card)
    cols = torch.zeros((8, 1), dtype=torch.int64, device=card)
    with pytest.raises(TypeError, match="int32"):
        ops.ell_spmv(cols, torch.ones((8, 1), device=card), x)
    with pytest.raises(ValueError, match="ascending"):
        ops.cheb_dia((1, 0), torch.ones((2, 8), device=card), x, x, x, 1.0, 0.0)


def test_solve_goes_through_both_kernels(card):
    """A kernel-on solve launches the ELL kernel (Lanczos, Ritz, T1) and the
    DIA kernel (every fused step), and matches dense eigh."""
    mat = Hubbard(6, 3, U=4.0, ranpot=1.0)
    w = np.linalg.eigvalsh(mat.build_csr().to_dense())
    build.reset_launches()
    cfg = FDConfig(n_target=3, n_search=12, target=float(w[len(w) // 3]),
                   tol=1e-8, max_iters=25, layout="stack", spmv_kernel=True)
    res = FilterDiag(mat, cfg).solve()
    assert res.n_converged >= 3
    for ev in res.eigenvalues[:3]:
        assert np.abs(w - ev).min() < 1e-7
    assert build.launches["ell_gather"] >= cfg.lanczos_steps
    assert build.launches["cheb_dia"] > 0
