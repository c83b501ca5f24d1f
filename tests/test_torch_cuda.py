"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where there is no CUDA device
(the kernels have no CPU mode). Each grid runs in fp64, fp32, complex128
and complex64 (the dtypes are parametrized in that order). On a machine
with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FDConfig, FilterDiag
from repro_torch.kernels import build, ops, plan, ref
from repro_torch.matrices import Exciton, Hubbard, RoadNet, TopIns

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tol(dtype):
    return 1e-13 if dtype in (torch.float64, torch.complex128) else 1e-5


def _np_randn(rng, shape, dtype):
    """Standard normal numpy values of ``dtype``'s kind (complex: both
    planes drawn)."""
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return a


@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_cheb_dia_kernel_vs_plain(card, dtype):
    rng = np.random.default_rng(1)
    R, Rx, nb = 1000, 1100, 70
    offsets = (-300, -9, -1, 0, 1, 9, 300, 650)
    dv = _np_randn(rng, (len(offsets), R), dtype)
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


# Slab widths forced at every block width of the main path and its edges:
# the small-n_b lane groups of ell_gather (n_b < 32), ragged slabs (100 in
# slabs of 8), and the rule's own choice (None).
SLAB_GRID = [(nb, c) for nb in (1, 3, 8, 64, 100, 512)
             for c in sorted({1, 4, 8, nb}) if c <= nb] + [(100, None),
                                                          (512, None)]


def _far_ell(card, R, Rx, W, dtype, seed):
    """An ELL block with near and far columns (Hubbard-like reach) and
    zero slots, padding at each row's end."""
    g = torch.Generator(device=card).manual_seed(seed)
    rows = torch.arange(R, device=card)[:, None]
    jump = torch.randint(-3, 4, (R, W), generator=g, device=card)
    far = torch.randint(0, 2, (R, W), generator=g, device=card) * 97
    cols = ((rows + jump * (1 + far)) % Rx).to(torch.int32)
    vals = torch.randn((R, W), generator=g, device=card, dtype=dtype)
    vals[torch.rand((R, W), generator=g, device=card) < 0.25] = 0
    vals[:, W - 2:] = 0
    return cols, vals


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,c", SLAB_GRID)
def test_ell_gather_slabs_bitwise(card, nb, c, dtype):
    """The ELL kernel at forced slab widths (and the rule's), with and
    without y0, a ragged R and a halo-extended x, is torch.equal to its
    plain version."""
    R, Rx, W = 1037, 1100, 13
    cols, vals = _far_ell(card, R, Rx, W, dtype, nb * 31 + (c or 0))
    g = torch.Generator(device=card).manual_seed(nb)
    x = torch.randn((Rx, nb), generator=g, device=card, dtype=dtype)
    y0 = torch.randn((R, nb), generator=g, device=card, dtype=dtype)
    n0 = build.launches["ell_gather"]
    got = ops.ell_spmv(cols, vals, x, y0, slab=c)
    got0 = ops.ell_spmv(cols, vals, x, slab=c)
    torch.cuda.synchronize()
    assert build.launches["ell_gather"] == n0 + 2
    assert torch.equal(got, ref.ell_spmv_acc_ref(y0, cols, vals, x))
    assert torch.equal(got0, ref.ell_spmv_ref(cols, vals, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [1, 8])
@pytest.mark.parametrize("R,W", [(300, 100), (16, 30_000)])
def test_ell_gather_wide_rows_bitwise(card, R, W, nb, dtype):
    """Rows too wide for a full tile in shared memory (the kernel stages
    ≈ 75 % of W stored entries a row, 12 bytes each in fp64): W = 100 at
    n_b = 1 (a pass of 256 rows ≈ 230 KB in fp64) halves the tile, and
    W = 30,000 (one row ≈ 270 KB in fp64, more than the 227 KB a block
    can have) is read where it lies, or in fp32 (≈ 180 KB) staged as a
    tile of one row; complex128 rows (20 bytes an entry) are wider still.
    Each is torch.equal to the plain version."""
    Rx = 40_000
    g = torch.Generator(device=card).manual_seed(W + nb)
    cols = torch.randint(0, Rx, (R, W), generator=g, device=card,
                         dtype=torch.int32)
    vals = torch.randn((R, W), generator=g, device=card, dtype=dtype)
    vals[torch.rand((R, W), generator=g, device=card) < 0.25] = 0
    x = torch.randn((Rx, nb), generator=g, device=card, dtype=dtype)
    y0 = torch.randn((R, nb), generator=g, device=card, dtype=dtype)
    got = ops.ell_spmv(cols, vals, x, y0)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.ell_spmv_acc_ref(y0, cols, vals, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,c", SLAB_GRID)
def test_cheb_dia_slabs_bitwise(card, nb, c, dtype):
    """The DIA kernel over the compact form at forced slab widths (and
    the rule's), ragged R, a halo-extended x and diagonals that leave the
    block, is torch.equal to its plain version on the dense dvals."""
    rng = np.random.default_rng(nb + (c or 0))
    R, Rx = 1037, 1100
    offsets = (-700, -97, -9, -1, 0, 1, 9, 97, 700, 1090)
    dv = _np_randn(rng, (len(offsets), R), dtype)
    idx = np.arange(R)
    for d, o in enumerate(offsets):
        dv[d, (idx + o < 0) | (idx + o >= Rx)] = 0.0
    dv[rng.random(dv.shape) < 0.3] = 0.0
    dia = ops.DiaPlan(offsets=offsets,
                      dvals=torch.as_tensor(dv, device=card).to(dtype))
    g = torch.Generator(device=card).manual_seed(nb)
    x = torch.randn((Rx, nb), generator=g, device=card, dtype=dtype)
    w2 = torch.randn((R, nb), generator=g, device=card, dtype=dtype)
    w1 = x[:R].contiguous()
    n0 = build.launches["cheb_dia"]
    got = ops.cheb_dia(offsets, dia.dvals, x, w1, w2, 0.8, -0.1,
                       compact=dia.compact, span=dia.span, slab=c)
    torch.cuda.synchronize()
    assert build.launches["cheb_dia"] == n0 + 1
    want = ref.cheb_dia_ref(offsets, dia.dvals, x, w1, w2, 0.8, -0.1)
    assert torch.equal(got, want)
    if c is not None:
        assert torch.equal(ref.cheb_dia_compact_ref(
            offsets, dia.compact, x, w1, w2, 0.8, -0.1, c), want)


def test_slab_rule_on_the_main_operator(card):
    """Hubbard(12,6) at n_b = 512 (span 232,848): the rule sweeps the DIA
    step in slabs narrower than the block, the ELL product in one slab."""
    from repro_torch.core import build_dist_ell
    from repro_torch.kernels.cheb_dia import slab_for as dia_slab
    from repro_torch.kernels.ell_gather import slab_for as ell_slab

    ell = build_dist_ell(Hubbard(12, 6, U=25.0, ranpot=1.0), 1, device=card)
    assert ell.span == 232_848
    dia = ops.plan_dia(ell.cols, ell.vals, ell.R, device=card)
    assert dia.span == 232_848 and len(dia.offsets) == 61
    assert dia_slab(torch.float64, dia.span, 512) == 32
    assert dia_slab(torch.float32, dia.span, 512) == 64
    assert ell_slab(512) == 512 and ell_slab(1) == 1
    # ids (13 a row), the main diagonal and row pointers: one value off it
    assert dia.compact.table.numel() == 1
    assert abs(dia.compact.bytes_per_row - 25.0) < 0.01
    assert dia.compact.tile_max <= plan.TILE_ROWS * dia.compact.max_row


def test_kernels_refuse_what_they_cannot_take(card):
    x = torch.ones((8, 2), device=card)
    cols = torch.zeros((8, 1), dtype=torch.int64, device=card)
    with pytest.raises(TypeError, match="int32"):
        ops.ell_spmv(cols, torch.ones((8, 1), device=card), x)
    with pytest.raises(ValueError, match="ascending"):
        ops.cheb_dia((1, 0), torch.ones((2, 8), device=card), x, x, x, 1.0, 0.0)
    with pytest.raises(ValueError, match="slab width"):
        ops.ell_spmv(cols.to(torch.int32), torch.ones((8, 1), device=card), x,
                     slab=3)


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


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("fam", [Exciton(L=5), TopIns(8)])
def test_complex_operator_steps_bitwise(card, fam, dtype):
    """A complex lattice operator (its compact DIA form holds the values
    off the main diagonal in a table) through the main path's SpMV and
    fused step, kernels on: torch.equal to the plain versions at n_b = 1
    and at a ragged n_b, and both kernels launched. TopIns(8) has
    R = 2,048, a multiple of both kernels' tile rows."""
    from repro_torch.core import build_dist_ell, make_fused_cheb_step, make_spmv

    ell = build_dist_ell(fam, 1, dtype=dtype, device=card)
    dia = ops.plan_dia(ell.cols, ell.vals, ell.R, device=card)
    assert dia is not None and dia.compact.table is not None
    spmv = make_spmv(ell, use_kernel=True)
    step = make_fused_cheb_step(ell, use_kernel=True)
    assert hasattr(step, "dia")
    tdt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(fam.D)
    for nb in (1, 37):
        x, w2 = (torch.randn((ell.R, nb), generator=g, device=card, dtype=tdt)
                 for _ in range(2))
        n0 = dict(build.launches)
        y = spmv(x)
        s = step(x, w2, 0.31, -0.27)
        torch.cuda.synchronize()
        assert build.launches["ell_gather"] == n0["ell_gather"] + 1
        assert build.launches["cheb_dia"] == n0["cheb_dia"] + 1
        assert torch.equal(y, ref.ell_spmv_ref(ell.cols, ell.vals, x))
        assert torch.equal(s, ref.cheb_dia_ref(dia.offsets, dia.dvals, x, x, w2,
                                               0.31, -0.27))


def test_complex_solve_goes_through_both_kernels(card):
    """An Exciton solve (complex128) with the kernels on launches both
    kernels and matches dense eigh."""
    mat = Exciton(L=2)
    w = np.linalg.eigvalsh(mat.build_csr().to_dense())
    build.reset_launches()
    cfg = FDConfig(n_target=4, n_search=16, target=float(w[0]) - 0.1,
                   tol=1e-8, max_iters=40, layout="stack", spmv_kernel=True)
    res = FilterDiag(mat, cfg).solve()
    assert res.n_converged >= 4
    np.testing.assert_allclose(np.sort(res.eigenvalues)[:4], w[:4], atol=1e-7)
    assert build.launches["ell_gather"] >= cfg.lanczos_steps
    assert build.launches["cheb_dia"] > 0


def test_graph_solve_takes_the_ell_route(card):
    """RoadNet has no DIA form: a kernel-on solve runs every fused step as
    the ELL kernel plus the torch epilogue (no DIA launch) and matches
    dense eigh at the upper edge."""
    mat = RoadNet(n=4000, w=2, m=256, k=4)
    w = np.linalg.eigvalsh(mat.build_csr().to_dense())
    build.reset_launches()
    cfg = FDConfig(n_target=4, n_search=16, target=float(w[-1]) + 0.1,
                   tol=1e-8, max_iters=40, layout="stack", spmv_kernel=True)
    res = FilterDiag(mat, cfg).solve()
    assert res.n_converged >= 4
    np.testing.assert_allclose(np.sort(res.eigenvalues)[-4:], w[-4:], atol=1e-7)
    assert build.launches["cheb_dia"] == 0
    assert build.launches["ell_gather"] > cfg.lanczos_steps
