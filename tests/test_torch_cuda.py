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
    dia = ops.plan_dia(ell.cols[0], ell.vals[0], ell.R, device=card)
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
    dia = ops.plan_dia(ell.cols[0], ell.vals[0], ell.R, device=card)
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
        assert torch.equal(y, ref.ell_spmv_ref(ell.cols[0], ell.vals[0], x))
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
    the ELL kernel with its fused epilogue (no DIA launch) and matches
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
    assert build.launches["ell_gather_cheb"] > 0


# ------------------------------------------- the horizontal layer (P > 1) --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,Rx,W,nb", [(1000, 1500, 9, 1), (777, 900, 0, 37),
                                       (513, 600, 5, 100), (256, 300, 3, 8)])
def test_ell_epilogue_entry_vs_plain(card, R, Rx, W, nb, dtype):
    """The ``ell_gather_cheb`` entry, ``2a·(y0 + A·x) + 2b·w1 − w2``, with
    and without ``y0``, against ``ref.cheb_epilogue(ref.ell_spmv_acc_ref(
    ...))``: bit-equal in fp64 and complex128, within 1e-5 in fp32 and
    complex64; ragged R and n_b, and an empty block (W = 0); ``out`` may
    be ``y0``."""
    g = torch.Generator(device=card).manual_seed(R + W)
    cols = torch.randint(0, Rx, (R, W), generator=g, device=card,
                         dtype=torch.int32)
    vals = torch.randn((R, W), generator=g, device=card, dtype=dtype)
    if W:
        vals[torch.rand((R, W), generator=g, device=card) < 0.2] = 0
    x, = (torch.randn((Rx, nb), generator=g, device=card, dtype=dtype),)
    y0, w2 = (torch.randn((R, nb), generator=g, device=card, dtype=dtype)
              for _ in range(2))
    w1 = x[:R].contiguous()
    a, b = 0.013, -0.4
    n0 = build.launches["ell_gather_cheb"]
    for start in (None, y0):
        got = ops.ell_spmv(cols, vals, x, start, epilogue=(w1, w2, a, b))
        acc = start if start is not None else torch.zeros_like(y0)
        want = ref.cheb_epilogue(ref.ell_spmv_acc_ref(acc, cols, vals, x),
                                 w1, w2, a, b)
        torch.cuda.synchronize()
        if dtype in (torch.float64, torch.complex128):
            assert torch.equal(got, want)
        else:
            err = (got - want).abs().max() / want.abs().max()
            assert err <= _tol(dtype)
    inplace = y0.clone()
    ops.ell_spmv(cols, vals, x, inplace, epilogue=(w1, w2, a, b), out=inplace)
    assert torch.equal(inplace, ops.ell_spmv(cols, vals, x, y0,
                                             epilogue=(w1, w2, a, b)))
    assert build.launches["ell_gather_cheb"] == n0 + 4
    with pytest.raises(ValueError, match="out may not be"):
        ops.ell_spmv(cols, vals, x, y0, epilogue=(w1, w2, a, b), out=w2)
    with pytest.raises(ValueError, match="w2"):
        ops.ell_spmv(cols, vals, x, y0, epilogue=(w1, w2[:-1], a, b))


def _shard_views(g, card, P, rows, nb, dtype, lead):
    """A ``[P, rows, nb]`` view of random values, each shard's rows
    ``lead`` rows into a ``[P, rows + lead + 2, nb]`` buffer: a strided
    view whose shard stride is not ``rows · nb``."""
    buf = torch.randn((P, rows + lead + 2, nb), generator=g, device=card,
                      dtype=dtype)
    return buf[:, lead:lead + rows]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,R,Rx,W,nb,lead", [
    (1, 1000, 1500, 9, 1, 0), (4, 777, 900, 13, 37, 1),
    (8, 513, 600, 5, 64, 2), (8, 256, 300, 3, 8, 1), (4, 100, 130, 0, 19, 0)])
def test_grouped_launch_equals_per_shard_launches(card, P, R, Rx, W, nb,
                                                  lead, dtype):
    """One launch for P row shards (``ell_gather.EllLaunch`` on the
    stacked form) against one launch per shard and the grouped plain
    version (``ref.ell_grouped_ref``), on strided shard views, with and
    without ``y0`` and the epilogue, ``out`` also ``y0``: bit-equal in
    fp64 and complex128, within 1e-5 in fp32 and complex64; ragged R and
    n_b, a shard block with no entries (shard 1, and W = 0); each call one
    launch."""
    from repro_torch.kernels.ell_gather import EllLaunch

    g = torch.Generator(device=card).manual_seed(P * R + W)
    cols = torch.randint(0, Rx, (P, R, W), generator=g, device=card,
                         dtype=torch.int32)
    vals = torch.randn((P, R, W), generator=g, device=card, dtype=dtype)
    if W:
        vals[torch.rand((P, R, W), generator=g, device=card) < 0.2] = 0
    if P > 1:
        vals[1] = 0  # a shard block with no entries
    cp = plan.compact_ell_grouped(cols, vals)
    launch = EllLaunch(cp)
    x = _shard_views(g, card, P, Rx, nb, dtype, lead)
    y0, w1, w2 = (_shard_views(g, card, P, R, nb, dtype, lead)
                  for _ in range(3))
    a, b = 0.013, -0.4

    def close(got, want):
        if dtype in (torch.float64, torch.complex128):
            return torch.equal(got, want)
        return bool((got - want).abs().max() <= _tol(dtype)
                    * max(float(want.abs().max()), 1e-30))

    for start in (None, y0):
        for epi in (None, (w1, w2, a, b)):
            name = "ell_gather" if epi is None else "ell_gather_cheb"
            out = _shard_views(g, card, P, R, nb, dtype, lead + 1)
            n0 = dict(build.launches)
            launch(x, start, out=out, epilogue=epi)
            assert build.launches[name] == n0[name] + 1
            assert sum(build.launches.values()) == sum(n0.values()) + 1
            per_shard = torch.stack([ops.ell_spmv(
                cols[p], vals[p], x[p].contiguous(),
                None if start is None else start[p].contiguous(),
                epilogue=None if epi is None else (
                    w1[p].contiguous(), w2[p].contiguous(), a, b))
                for p in range(P)])
            want = ref.ell_grouped_ref(cp, x, start, epi)
            torch.cuda.synchronize()
            assert close(out, want) and close(per_shard, want)
            if dtype in (torch.float64, torch.complex128):
                assert torch.equal(out, per_shard)
    inplace = y0.clone()
    launch(x, inplace, out=inplace, epilogue=(w1, w2, a, b))
    want = launch(x, y0, out=torch.empty_like(y0), epilogue=(w1, w2, a, b))
    torch.cuda.synchronize()
    assert torch.equal(inplace, want)


def test_grouped_launch_refuses_what_it_cannot_take(card):
    from repro_torch.kernels.ell_gather import EllLaunch

    P, R, nb = 4, 64, 8
    cols = torch.zeros((P, R, 3), dtype=torch.int32, device=card)
    cols[:, :, 1] = 9
    vals = torch.ones((P, R, 3), dtype=torch.float64, device=card)
    launch = EllLaunch(plan.compact_ell_grouped(cols, vals))
    x = torch.ones((P, R, nb), dtype=torch.float64, device=card)
    out = torch.empty_like(x)
    with pytest.raises(ValueError, match="x"):  # columns past x's rows
        launch(x[:, :9], out=out)
    with pytest.raises(ValueError, match="out may not overlap x"):
        launch(x, out=x)
    with pytest.raises(ValueError, match="out"):  # shards overlap
        launch(x, out=out[:1].expand(P, R, nb))
    with pytest.raises(ValueError, match="w2"):
        launch(x, out=out, epilogue=(x, x[:, :-1], 1.0, 0.0))
    with pytest.raises(ValueError, match="out may not be"):
        launch(x, out=out, epilogue=(x, out, 1.0, 0.0))
    buf = torch.zeros(P * R * nb + nb, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="y0 may be out"):  # one row off
        launch(x, buf[nb:].view(P, R, nb), out=buf[:-nb].view(P, R, nb))
    with pytest.raises(ValueError, match="x"):
        launch(x.to(torch.float32), out=out)
    with pytest.raises(ValueError, match="CUDA"):
        EllLaunch(plan.compact_ell_grouped(cols.cpu(), vals.cpu()))


ENGINES = [("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "cyclic", False, True),
           ("compressed", "cyclic", True, False),
           ("compressed", "cyclic", True, True),
           ("compressed", "matching", False, True),
           ("compressed", "matching", True, False),
           ("compressed", "matching", True, True)]


@pytest.mark.parametrize("fam,P,dtype", [
    (RoadNet(n=4000, w=2, m=256, k=4), 8, torch.float64),
    (Exciton(L=2), 4, torch.complex128),
    (Hubbard(6, 3, U=4.0, ranpot=1.0), 8, torch.float32),
], ids=["roadnet-8", "exciton-4", "hubbard-8-fp32"])
def test_engines_on_the_card_bitwise(card, fam, P, dtype):
    """Every engine, kernels on, SpMV and fused step: equal to the same
    engine built from the plain versions on the card, and to the a2a
    plain engine; the split-phase engines (side stream) repeated in a
    loop stay equal; the exchange bytes are those of the CPU run."""
    from repro_torch.core import (ShardGroup, build_dist_ell,
                                  make_fused_cheb_step, make_spmv)

    ell = build_dist_ell(fam, P, dtype=str(dtype).split(".")[1], device=card)
    g = torch.Generator(device=card).manual_seed(P)
    x, w2 = (torch.randn((ell.D_pad, 19), generator=g, device=card,
                         dtype=dtype) for _ in range(2))
    x[ell.D:] = 0
    w2[ell.D:] = 0
    base = None
    for comm, sched, ov, pipe in ENGINES:
        kw = dict(overlap=ov, comm=comm, schedule=sched, pipeline=pipe)
        gk, gp = ShardGroup(P, card), ShardGroup(P, card)
        spmv = make_spmv(ell, group=gk, use_kernel=True, **kw)
        step = make_fused_cheb_step(ell, group=gk, use_kernel=True, **kw)
        n0 = dict(build.launches)
        y, s = spmv(x), step(x, w2, 0.21, -0.33)
        assert build.launches["ell_gather"] > n0["ell_gather"]
        # one launch a phase for all P shards; the epilogue's phase is one
        assert build.launches["ell_gather_cheb"] == n0["ell_gather_cheb"] + 1
        assert build.launches["cheb_dia"] == n0["cheb_dia"]
        y_p = make_spmv(ell, group=gp, **kw)(x)
        s_p = make_fused_cheb_step(ell, group=gp, **kw)(x, w2, 0.21, -0.33)
        torch.cuda.synchronize()
        assert gk.bytes == gp.bytes
        if dtype == torch.float32:
            assert (y - y_p).abs().max() <= 1e-5 * y_p.abs().max()
            assert (s - s_p).abs().max() <= 1e-5 * s_p.abs().max()
        else:
            assert torch.equal(y, y_p) and torch.equal(s, s_p)
        if base is None:
            base = (y, s)
        assert torch.equal(y, base[0]) and torch.equal(s, base[1])
        if ov:
            for _ in range(20):
                assert torch.equal(step(x, w2, 0.21, -0.33), s)


def test_zero_halo_operator_takes_the_dia_step_per_shard(card):
    """A block-diagonal operator at P = 4 (L = 0): the fused step runs the
    DIA kernel once per shard, equal bit for bit to the ELL route."""
    from repro_torch.core import build_dist_ell, make_fused_cheb_step
    from repro_torch.matrices import csr_from_coo

    D, P = 4002, 4
    R = -(-D // P)
    r = np.arange(D)
    c = np.concatenate([r, r[:-1], r[1:]])
    rows = np.concatenate([r, r[1:], r[:-1]])
    keep = rows // R == c // R
    vals = np.where(rows == c, 2.0, -1.0)[keep]
    A = csr_from_coo(rows[keep], c[keep], vals, (D, D))
    ell = build_dist_ell(A, P, device=card)
    assert ell.L == 0
    g = torch.Generator(device=card).manual_seed(3)
    x, w2 = (torch.randn((ell.D_pad, 64), generator=g, device=card,
                         dtype=torch.float64) for _ in range(2))
    step = make_fused_cheb_step(ell, use_kernel=True)
    assert step.kind == "dia"
    n0 = build.launches["cheb_dia"]
    got = step(x, w2, 0.4, 0.1)
    assert build.launches["cheb_dia"] == n0 + P
    want = make_fused_cheb_step(ell)(x, w2, 0.4, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_row_shard_solve_on_the_card(card):
    """RoadNet(4000) at P = 4 (a2a split-phase) and P = 8 (compressed
    split-phase): each matches dense eigh at the upper edge, with no DIA
    launch, and the two agree to 1e-9."""
    mat = RoadNet(n=4000, w=2, m=256, k=4)
    w = np.linalg.eigvalsh(mat.build_csr().to_dense())
    out = []
    for P, eng in ((4, dict(spmv_overlap=True)),
                   (8, dict(spmv_overlap=True, spmv_comm="compressed"))):
        build.reset_launches()
        cfg = FDConfig(n_target=4, n_search=16, target=float(w[-1]) + 0.1,
                       tol=1e-8, max_iters=40, layout="stack",
                       spmv_kernel=True, **eng)
        fd = FilterDiag(mat, cfg, n_row=P)
        res = fd.solve(generator=torch.Generator(device=card).manual_seed(1))
        assert res.n_converged >= 4
        np.testing.assert_allclose(np.sort(res.eigenvalues)[-4:], w[-4:],
                                   atol=1e-7)
        assert build.launches["cheb_dia"] == 0
        assert build.launches["ell_gather_cheb"] > 0
        out.append(np.sort(res.eigenvalues)[-4:])
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-9)


# ---------------------------------------------- the vertical layer (N_col) --

SPLITS_OF_8 = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.mark.parametrize("impl", ["explicit", "gspmd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_redistribution_round_trip_on_the_card(card, impl, dtype):
    """``to_panel``/``to_stack`` for every split of 8 shards: bundle j is
    the columns ``[j·n_c, (j+1)·n_c)``, the round trip is bit-exact and
    each move counts Eqs. 17–18's off-device bytes."""
    from repro_torch.core import ShardGroup, make_redistribute

    D_pad, N_s = 8 * 1_001, 48
    g = torch.Generator(device=card).manual_seed(5)
    V = torch.randn((D_pad, N_s), generator=g, device=card, dtype=dtype)
    for n_row, n_col in SPLITS_OF_8:
        grp = ShardGroup(8, card)
        to_panel, to_stack = make_redistribute(grp, n_col, impl)
        Vp = to_panel(V)
        back = to_stack(Vp)
        torch.cuda.synchronize()
        assert torch.equal(back, V)
        n_c = N_s // n_col
        assert Vp.shape == (n_col, D_pad, n_c)
        for j in range(n_col):
            assert Vp[j].is_contiguous()
            assert torch.equal(Vp[j], V[:, j * n_c:(j + 1) * n_c])
        S = V.element_size()
        assert grp.bytes["redistribute"] == 2 * N_s * D_pad * S * (
            n_col - 1) // n_col


@pytest.mark.parametrize("fam,n_row,n_col,route", [
    (RoadNet(n=4000, w=2, m=256, k=4), 2, 2, "compressed-matching"),
    (Exciton(L=5), 1, 4, "dia"),
    (Hubbard(6, 3, U=4.0, ranpot=1.0), 1, 4, "dia"),
], ids=["roadnet-panel-2x2", "exciton-pillar-1x4", "hubbard-pillar-1x4"])
def test_panel_and_pillar_steps_equal_the_full_width_step(card, fam, n_row,
                                                          n_col, route):
    """One fused step of every bundle of a panel or pillar block,
    reassembled, equals bit for bit the same step at full width through
    the N_row-shard engine (at N_row = 1 the one-shard DIA step)."""
    from repro_torch.core import (ShardGroup, build_dist_ell, layout_on_grid,
                                  make_fused_cheb_step, make_redistribute)

    P = n_row * n_col
    ell = build_dist_ell(fam, n_row, dtype="float64",
                         d_pad=-(-fam.D // P) * P, device=card)
    kw = dict(use_kernel=True, comm="compressed", schedule="matching")
    N_s = 32
    g = torch.Generator(device=card).manual_seed(7)
    x, w2 = (torch.randn((ell.D_pad, N_s), generator=g, device=card,
                         dtype=ell.vals.dtype) for _ in range(2))
    x[ell.D:] = 0
    w2[ell.D:] = 0
    want = make_fused_cheb_step(ell, group=ShardGroup(n_row, card), **kw)(
        x, w2, 0.3, -0.2)
    name = "pillar" if n_row == 1 else "panel"
    grid = layout_on_grid(name, n_row, n_col).shards(card)
    step = make_fused_cheb_step(ell, group=grid.panel, **kw)
    assert step.kind == route
    to_panel, to_stack = make_redistribute(grid.stack, n_col)
    xp, w2p = to_panel(x), to_panel(w2)
    n0 = dict(build.launches)
    got = to_stack([step(xj, w2j, 0.3, -0.2) for xj, w2j in zip(xp, w2p)])
    torch.cuda.synchronize()
    kernel = "cheb_dia" if route == "dia" else "ell_gather_cheb"
    # the DIA step launches per shard, the ELL step once for its N_row
    per_bundle = n_row if route == "dia" else 1
    assert build.launches[kernel] == n0[kernel] + n_col * per_bundle
    assert torch.equal(got, want)


def test_layouts_solve_on_the_card(card):
    """RoadNet(4000) in the panel layout 4 × 2 on the commvol map and in
    the pillar layout 1 × 4 on the RCM map: each matches dense eigh at the
    upper edge, with 2 redistributions an iteration and no DIA launch."""
    mat = RoadNet(n=4000, w=2, m=256, k=4)
    w = np.linalg.eigvalsh(mat.build_csr().to_dense())
    for layout, n_row, n_col, plan in (
            ("panel", 4, 2, dict(spmv_balance="commvol",
                                 spmv_comm="compressed")),
            ("pillar", 1, 4, dict(spmv_reorder="rcm"))):
        build.reset_launches()
        cfg = FDConfig(n_target=4, n_search=16, target=float(w[-1]) + 0.1,
                       tol=1e-8, max_iters=40, layout=layout,
                       spmv_kernel=True, **plan)
        fd = FilterDiag(mat, cfg, n_row=n_row, n_col=n_col)
        assert not fd.rowmap.identity
        res = fd.solve(generator=torch.Generator(device=card).manual_seed(1))
        assert res.n_converged >= 4
        assert res.redistributions == 2 * res.iterations
        np.testing.assert_allclose(np.sort(res.eigenvalues)[-4:], w[-4:],
                                   atol=1e-7)
        assert build.launches["cheb_dia"] == 0
        assert build.launches["ell_gather_cheb"] > 0


@pytest.mark.parametrize("fam,dtype", [
    (Hubbard(8, 4, U=4.0, ranpot=1.0), "float64"),
    (Exciton(L=8), "complex128"),
], ids=["hubbard-8-4", "exciton-8"])
def test_one_outer_iteration_is_deterministic(card, fam, dtype):
    """One outer iteration (``orthogonalize``, ``ritz`` and a degree-16
    filter, kernels on) run twice from the same state gives the same
    bits: the card's dense routines (QR, Gram, ``eigh``, the Ritz
    products) and the kernels choose nothing run to run."""
    from repro_torch.core import build_filter, chebyshev_filter, scale_params

    cfg = FDConfig(n_search=64, dtype=dtype, layout="stack",
                   spmv_kernel=True)
    fd = FilterDiag(fam, cfg)
    g = torch.Generator(device=card).manual_seed(11)
    V0 = torch.randn((fd.D_pad, cfg.n_search), generator=g, device=card,
                     dtype=torch.float64).to(fd.dtype)
    lam = fam.spectral_bounds_hint()
    alpha, beta = scale_params(*lam)
    poly = build_filter((lam[0], lam[0] + 0.1 * (lam[1] - lam[0])), lam,
                        degree=16)

    def iteration():
        Q = fd.orthogonalize(V0)
        theta, Y, res, VY = fd.ritz(Q)
        out = chebyshev_filter(fd.spmv, poly.mu, alpha, beta, VY,
                               fused_step=fd.fused_step)
        torch.cuda.synchronize()
        return Q, theta, Y, res, VY, out

    first, second = iteration(), iteration()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fit_machine_prices_the_exchange(card):
    """``fit_machine`` on the card (Hubbard(11,5), D = 213,444, fp64,
    P = 4, N_s = 512): b_m from the 1 GiB copy, a finite b_c and κ > 0 —
    a model that prices both the exchange and the vectors. (Smaller
    operators are launch-bound: the exchange barely shows in their
    times, and the fit may leave b_c at +inf.) Each sample is the mean of
    ``fit_machine``'s default 20 steps: with one launch a phase for all
    shards a tiny-width step is a few tens of µs, and over 5 steps one
    host stall can move a sample several-fold and the fit's b_c to +inf."""
    import math

    from repro_torch.launch.dryrun import fit_machine

    fit, samples = fit_machine(Hubbard(11, 5, U=4.0, ranpot=1.0), None,
                               n_devices=4, n_search=512, reps=20,
                               device=card, verbose=False)
    assert len(samples) == 5  # 4x1 and 2x2 at two widths, 1x4 at one
    assert all(s["t"] > 0 and s["t_model"] > 0 for s in samples)
    assert 1e11 < fit.b_m < 1e13
    assert math.isfinite(fit.b_c) and fit.b_c > 0
    assert fit.kappa > 0 and fit.alpha >= 0


def test_auto_solve_on_the_card_equals_the_cpu(card):
    """``layout="auto"`` on a 4 × 1 grid of HubNet(4000), kernels on: the
    card plans as the CPU does, runs the ELL kernel and its epilogue
    (never the DIA kernel: HubNet has no DIA form), and from the same
    draws returns the CPU's eigenvalues to 1e-9."""
    from repro_torch.matrices import HubNet

    mat = HubNet(n=4000, w=2, h=4, m=192, k=4)
    rng = np.random.default_rng(5)
    v0 = rng.standard_normal((mat.D, 1))
    V0 = rng.standard_normal((mat.D, 16))
    cfg = FDConfig(n_target=4, n_search=16, target=17.0, tol=1e-8,
                   max_iters=8, layout="auto", spmv_kernel=True)
    out = {}
    for dev in ("cpu", card):
        build.reset_launches()
        fd = FilterDiag(mat, cfg, device=dev, n_row=4)
        res = fd.solve(v0=v0, V0=V0)
        out[str(dev)] = (fd.plan.best.describe(), res,
                         dict(build.launches))
    (best_cpu, res_cpu, _), (best, res, launches) = out["cpu"], out["cuda"]
    assert best == best_cpu and best.endswith(")") and "+krn" in best
    assert res.iterations == res_cpu.iterations
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(res_cpu.eigenvalues), rtol=0,
                               atol=1e-9)
    assert launches["ell_gather"] > 0 and launches["ell_gather_cheb"] > 0
    assert launches["cheb_dia"] == 0


SSTEP_ENGINES = [("a2a", "cyclic", False), ("compressed", "cyclic", False),
                 ("compressed", "cyclic", True),
                 ("compressed", "matching", False)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.complex64])
@pytest.mark.parametrize("s", [2, 3])
def test_sstep_filter_on_the_card_bitwise(card, s, dtype):
    """The s-step filter on RoadNet(4000) at P = 4, kernels on, through
    each engine at degrees 3 and 8: bit-equal to the s = 1 filter (the
    fused step) through the same engine, and to the same filter from the
    plain versions on the card (complex64: to 1e-5 of max|Y|, as the
    kernel is held in that dtype); every step one ELL launch for all P
    shards, the DIA kernel never."""
    from repro_torch.core import (ShardGroup, build_dist_ell,
                                  build_sstep_ell, chebyshev_filter,
                                  make_fused_cheb_step, make_spmv,
                                  make_sstep_cheb)

    mat, P = RoadNet(n=4000, w=2, m=256, k=4), 4
    name = str(dtype).split(".")[1]
    ell = build_dist_ell(mat, P, dtype=name, split_halo=True, device=card)
    sell = build_sstep_ell(mat, P, s, dtype=name, split_halo=True,
                           device=card)
    g = torch.Generator(device=card).manual_seed(s)
    V = torch.randn((ell.D_pad, 7), generator=g, device=card, dtype=dtype)
    V[ell.D:] = 0
    for degree in (3, 8):
        mu = np.random.default_rng(degree).standard_normal(degree + 1)
        for comm, sched, ov in SSTEP_ENGINES:
            kw = dict(overlap=ov, comm=comm, schedule=sched)
            g1 = ShardGroup(P, card)
            Y1 = chebyshev_filter(
                make_spmv(ell, group=g1, use_kernel=True, pipeline=False,
                          **kw), mu, 0.07, -0.2, V,
                fused_step=make_fused_cheb_step(ell, group=g1,
                                                use_kernel=True,
                                                pipeline=False, **kw))
            n0 = dict(build.launches)
            Y = make_sstep_cheb(sell, group=ShardGroup(P, card),
                                use_kernel=True, **kw)(V, mu, 0.07, -0.2)
            torch.cuda.synchronize()
            launched = {k: build.launches[k] - n0[k] for k in n0}
            Yp = make_sstep_cheb(sell, group=ShardGroup(P, card),
                                 **kw)(V, mu, 0.07, -0.2)
            torch.cuda.synchronize()
            if dtype == torch.complex64:
                assert (Y - Yp).abs().max() <= 1e-5 * Yp.abs().max()
            else:
                assert torch.equal(Y, Yp), (degree, comm, sched, ov)
            assert torch.equal(Y, Y1), (degree, comm, sched, ov)
            split = 1 if ov else 0  # step 0's local prefix: one more launch
            assert launched["ell_gather_cheb"] == degree - 1
            assert launched["ell_gather"] == (1 + split) + split * (
                sell.n_groups(degree) - 1)
            assert launched["cheb_dia"] == 0


# ---------------------------------------------- checkpoint and service --


def test_checkpoint_restores_cuda_leaves_on_the_card(card, tmp_path):
    """CUDA leaves saved and restored onto the card: the same bits, on the
    card (the device given, or the template's when none is)."""
    from repro_torch.checkpoint import restore, save

    g = torch.Generator(device=card).manual_seed(3)
    tree = {"V": torch.randn((1000, 16), generator=g, device=card,
                             dtype=torch.float64),
            "Z": torch.randn((300, 4), generator=g, device=card,
                             dtype=torch.complex128),
            "s": torch.randn((7,), generator=g, device=card,
                             dtype=torch.float32)}
    save(str(tmp_path), 3, tree, grid=(2, 2))
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    for device in ("cuda", None):
        got, step, _ = restore(str(tmp_path), template, device=device)
        assert step == 3
        for k, v in tree.items():
            assert got[k].is_cuda and got[k].dtype == v.dtype
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", ["float64", "float32", "complex128",
                                   "complex64"])
def test_2d_mu_equal_columns_give_the_1d_bits_on_the_card(card, dtype):
    """``Y.addcmul_(T, mu[k])`` rounds as ``Y.add_(T, alpha=mu_k)`` on the
    card too: a 2-D μ of equal columns gives the 1-D filter's bits, the
    fused step in the DIA kernel."""
    from repro_torch.core import (build_dist_ell, chebyshev_filter,
                                  make_fused_cheb_step, make_spmv)

    fam = Hubbard(n_sites=6, n_fermions=3) if "float" in dtype \
        else Exciton(L=5)
    ell = build_dist_ell(fam, 1, dtype=dtype, device=card)
    g = torch.Generator(device=card).manual_seed(4)
    V = torch.randn((ell.D_pad, 24), generator=g, device=card,
                    dtype=ell.vals.dtype)
    spmv = make_spmv(ell, use_kernel=True)
    fused = make_fused_cheb_step(ell, use_kernel=True)
    mu = np.random.default_rng(4).standard_normal(12)
    n0 = build.launches["cheb_dia"]
    want = chebyshev_filter(spmv, mu, 0.05, -0.1, V, fused_step=fused)
    got = chebyshev_filter(spmv, np.repeat(mu[:, None], 24, axis=1), 0.05,
                           -0.1, V, fused_step=fused)
    torch.cuda.synchronize()
    assert build.launches["cheb_dia"] == n0 + 2 * 10
    assert torch.equal(got, want)


def _service_drain(ids, cache):
    from repro_torch.service import EigenService, SolveRequest

    reqs = {"a": SolveRequest("a", family="SpinChainXXZ",
                              params=dict(n_sites=10, n_up=5), n_target=4,
                              n_search=16, target=-3.0, tol=1e-8,
                              max_iters=40, seed=11),
            "b": SolveRequest("b", family="SpinChainXXZ",
                              params=dict(n_sites=10, n_up=5), n_target=3,
                              n_search=16, target=0.0, tol=1e-8,
                              max_iters=40, seed=22)}
    svc = EigenService(n_shards=1, device="cuda", spmv_kernel=True,
                       plan_cache=cache)
    for i in ids:
        svc.submit(reqs[i])
    build.reset_launches()
    out = svc.drain()
    torch.cuda.synchronize()
    return out, dict(build.launches), svc.groups[0]


def _degrees(res):
    return [h["degree"] for h in res.history if "degree" in h]


def test_service_batch_equals_solo_on_the_card(card, tmp_path):
    """A SpinChainXXZ(10,5) service on the card, kernels on (the DIA
    step): each batched request equals its solo drain bit for bit, and the
    shared sweep launches the DIA kernel once a step of the larger pending
    degree, fewer times than the two solo drains together."""
    from repro_torch.service import PlanCache

    cache = PlanCache(str(tmp_path / "plans.json"))
    both, launched, group = _service_drain(["a", "b"], cache)
    solo, solo_launched = {}, {}
    for rid in ("a", "b"):
        out, solo_launched[rid], _ = _service_drain([rid], cache)
        solo[rid] = out[rid]
    assert cache.plan_calls == 1 and group["cell"] == "stack+krn(1x1)"
    for rid in ("a", "b"):
        r, s = both[rid], solo[rid]
        assert np.array_equal(r.eigenvalues, s.eigenvalues), rid
        assert np.array_equal(r.residuals, s.residuals), rid
        assert (r.iterations, r.total_spmvs) == (s.iterations,
                                                 s.total_spmvs), rid
        assert _degrees(r) == _degrees(s), rid
        # one DIA launch per fused step of the solo filters: T2 .. T_n
        assert solo_launched[rid]["cheb_dia"] == sum(
            d - 1 for d in _degrees(s))
    da, db = _degrees(both["a"]), _degrees(both["b"])
    n = max(len(da), len(db))
    steps = [max(d[i] for d in (da, db) if i < len(d)) for i in range(n)]
    assert launched["cheb_dia"] == sum(d - 1 for d in steps)
    assert launched["cheb_dia"] < (solo_launched["a"]["cheb_dia"]
                                   + solo_launched["b"]["cheb_dia"])


class _FailingLaunches:
    """A kernel library whose every entry reports a failed launch."""

    def __getattr__(self, name):
        return lambda *args: 719  # cudaErrorLaunchFailure


def test_degraded_ok_raises_a_kernel_launch_error(card, monkeypatch):
    from repro_torch.launch import solve as cli

    build.load()
    monkeypatch.setattr(build, "_lib", _FailingLaunches())
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        cli.main(["--family", "SpinChainXXZ", "--params", "n_sites=8,n_up=4",
                  "--n-target", "2", "--n-search", "8", "--target", "-1.5",
                  "--tol", "1e-8", "--max-iters", "30", "--layout", "pillar",
                  "--n-col", "2", "--spmv-kernel", "--degraded-ok"],
                 verbose=False)


# ------------------------------------------------------ static checks --

def test_census_krn_cell_on_the_card(card):
    """A kernelized census cell (SpinChainXXZ(10,5), panel 4 × 2,
    compressed-matching split-phase): every collective of one FD
    macro-iteration attributed, none missing, and the kernels launched."""
    from repro_torch.analysis import run_census_cell
    from repro_torch.matrices import SpinChainXXZ

    build.reset_launches()
    rep = run_census_cell(SpinChainXXZ(10, 5), P_total=8, comm="compressed",
                          schedule="matching", overlap=True, use_kernel=True,
                          device=card)
    torch.cuda.synchronize()
    assert rep.ok, rep.describe()
    assert rep.cell == "panel/compressed-matching+ov+krn/rows+none/P8"
    assert rep.launches > 0
    assert build.launches["ell_gather"] > 0
    assert build.launches["ell_gather_cheb"] > 0


@pytest.mark.parametrize("comm,schedule", [("a2a", "cyclic"),
                                           ("compressed", "matching")])
def test_split_phase_proof_on_a_real_side_stream(card, comm, schedule):
    """The split-phase engine's record on the card, kernels on: (A) and
    (B) hold and every side-stream entry ran on the real side stream;
    the plain engine fails (B), a late start fails (A) and a dropped wait
    is a race."""
    from repro_torch.analysis import (CommTrace, check_split_phase,
                                      dropped_wait, late_start)
    from repro_torch.analysis.check_comm import ProofOperator
    from repro_torch.core import make_spmv

    op = ProofOperator(card)
    for overlap in (True, False):
        spmv = make_spmv(op.ells[overlap], use_kernel=True, overlap=overlap,
                         comm=comm, schedule=schedule, pipeline=False)
        trace = CommTrace().attach(spmv.group)
        spmv(op.x)
        torch.cuda.synchronize()
        rep = check_split_phase(trace, real_side=True)
        assert rep.ok == overlap, rep.describe()
        if overlap:
            sides = [e for e in trace.entries if e.stream == "side"]
            assert sides and all(e.real_side for e in sides)
            assert any(e.launches for e in trace.entries)
            trace.clear()
            with late_start(spmv.group):
                spmv(op.x)
            torch.cuda.synchronize()
            late = check_split_phase(trace, real_side=True)
            assert not late.ok
            assert any("depends on contraction" in e for e in late.errors)
            trace.clear()
            with dropped_wait(spmv.group):
                spmv(op.x)
            dropped = check_split_phase(trace, real_side=True)
            assert any("before its wait: a race" in e
                       for e in dropped.errors), dropped.describe()


# ------------------------------------------------------------- LM serving --

@pytest.fixture
def no_tf32():
    """fp32 products in fp32 (TF32 off) for the test, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def test_lm_qwen3_decode_equals_the_full_forward(card, no_tf32):
    """qwen3-0.6b at full width and depth in fp32: the last of 8 greedy
    decode steps equals the last position of one forward of the grown
    sequence (``tests/test_models.py``'s tolerance, 2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import (init_params, make_batch,
                                    make_decode_step, make_prefill_step)
    from repro_torch.models import transformer as tfm

    cfg = get_config("qwen3-0.6b")
    model = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                        card, dtype=torch.float32).requires_grad_(False)
    toks = make_batch(cfg, 1, 64, device=card)["tokens"]
    logits, state = make_prefill_step(cfg, 72)(model, {"tokens": toks})
    step = make_decode_step(cfg)
    for pos in range(64, 72):
        nxt = logits.argmax(-1)
        logits, state = step(model, state, nxt, pos)
        toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
    with torch.no_grad():
        x, positions, _, _ = tfm.embed_batch(model, cfg, {"tokens": toks})
        h, _ = tfm.backbone(model, cfg, x, positions)
        full = h[:, -1] @ tfm.lm_head_table(model, cfg).T
    assert toks.shape == (1, 72)
    torch.testing.assert_close(logits, full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "rwkv6-1.6b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_lm_smoke_config_card_equals_cpu(card, no_tf32, arch):
    """One SMOKE config of each family through the port on the card and
    on the CPU, fp32, the same weights and batch: the prefill logits, the
    decode state and 3 decode steps within 1e-4 of their largest
    magnitude (hubert: the prefill alone)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (init_params, make_batch,
                                    make_decode_step, make_prefill_step)

    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0),
                      "cpu").requires_grad_(False)
    gpu = copy.deepcopy(cpu).to(card)
    batch = make_batch(cfg, 2, 128, device="cpu")
    if cfg.family not in ("vlm", "audio"):
        batch = {"tokens": batch["tokens"]}

    def close(got, want):
        want = want.double()
        err = (got.cpu().double() - want).abs().max()
        assert err <= 1e-4 * want.abs().max().clamp_min(1e-30), err

    pre = make_prefill_step(cfg, 131)
    lc, sc = pre(cpu, batch)
    lg, sg = pre(gpu, {k: v.to(card) for k, v in batch.items()})
    close(lg, lc)
    if not cfg.encoder_only:
        step = make_decode_step(cfg)
        for pos in range(128, 131):
            tok = lc.argmax(-1)
            lc, sc = step(cpu, sc, tok, pos)
            lg, sg = step(gpu, sg, tok.to(card), pos)
            close(lg, lc)
    for seg_c, seg_g in zip(sc, sg, strict=True):
        for k in seg_c:
            close(seg_g[k], seg_c[k])


# ------------------------------------------------------------ LM training --

def _tree_values(tree):
    from repro_torch.optim import adamw

    return [adamw.value(leaf).detach() for _, leaf in adamw.tree_paths(tree)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "rwkv6-1.6b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_lm_smoke_train_steps_card_equal_cpu(card, no_tf32, arch):
    """Two ``make_train_step`` steps of one SMOKE config per family on the
    CPU, fp32, each also taken on the card from the CPU's parameters and
    moments before it: loss and grad norm within 1e-4 (relative), each
    parameter within 1e-4 of its leaf's max, except elements whose
    gradient lay below 1e-3 of the leaf's max (Adam's ``g / (|g| + eps)``
    flips with rounding there), held to 2·lr (the smoke's train phase;
    free-running steps amplify fp32 rounding on the zero-init leaves)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, make_batch
    from repro_torch.models.steps import (grad_tree, make_train_step,
                                          param_tree)
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    ocfg = adamw.AdamWConfig(moment_dtype="float32", warmup_steps=2,
                             total_steps=10)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, 2, 128, device="cpu")
    state = adamw.init_state(ocfg, param_tree(cpu))
    step = make_train_step(cfg, ocfg)
    for _ in range(2):
        gpu = copy.deepcopy(cpu).to(card)
        gpu_state = adamw.tree_map(lambda t: t.to(card, copy=True), state)
        cpu, state, mc = step(cpu, state, batch)
        gpu, gpu_state, mg = step(gpu, gpu_state,
                                  {k: v.to(card) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(
                float(mc[k])), k
        for p, q, g in zip(_tree_values(param_tree(cpu)),
                           _tree_values(param_tree(gpu)),
                           _tree_values(grad_tree(param_tree(cpu))),
                           strict=True):
            small = g.abs() < 1e-3 * g.abs().max()
            err = (q.cpu() - p).abs()
            assert (err[~small] <= 1e-4 * p.abs().max()).all()
            assert (err[small] <= 2 * float(mc["lr"])).all()


def test_lm_train_exact_resume_on_the_card(card, tmp_path, monkeypatch):
    """qwen3-0.6b SMOKE through ``train`` on the card under deterministic
    algorithms: 7 steps resumed to 10 from the checkpoint equal 10 steps
    straight, bit for bit."""
    from repro_torch.launch.train import train
    from repro_torch.models.steps import param_tree

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(batch=2, seq=32, log_every=100, device=card)
        full, _, _ = train("qwen3-0.6b", steps=10, **kw)
        ck = str(tmp_path / "ck")
        train("qwen3-0.6b", steps=7, ckpt_dir=ck, **kw)
        res, state, losses = train("qwen3-0.6b", steps=10, ckpt_dir=ck, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(losses) == 3 and int(state["step"]) == 10
    for a, b in zip(_tree_values(param_tree(full)),
                    _tree_values(param_tree(res)), strict=True):
        assert torch.equal(a, b)


def test_checkpoint_restores_bf16_leaves_on_the_card(card, tmp_path):
    """bfloat16 CUDA leaves written as the reference writes them (their
    bits under the ``.npy`` descr '<V2', manifest dtype "bfloat16") come
    back on the card as bfloat16 with the same bits."""
    import json

    from repro_torch.checkpoint import restore, save

    g = torch.Generator(device=card).manual_seed(4)
    tree = {"w": torch.randn((257, 33), generator=g, device=card).to(
        torch.bfloat16),
            "b": torch.randn((33,), generator=g, device=card,
                             dtype=torch.float32)}
    path = save(str(tmp_path), 2, tree)
    with open(f"{path}/manifest.json") as f:
        assert [lm["dtype"] for lm in json.load(f)["leaves"]] == \
            ["float32", "bfloat16"]
    got, _, _ = restore(str(tmp_path), {k: torch.zeros_like(v)
                                        for k, v in tree.items()})
    assert got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(got["b"], tree["b"])


def test_op_census_of_one_epilogue_launch_is_its_bound(card):
    """One ``ell_gather_cheb`` launch under the op census is one op with
    its bound's bytes (the operator as the kernel reads it, x, w1, w2, y)
    and 2·nnz·n_b flops — the count its plain version gives on the CPU."""
    from repro_torch.launch.op_analysis import count_ops

    A = RoadNet(n=4000, w=2, m=256, k=4).build_csr()
    from repro_torch.core.spmv import build_dist_ell

    ell = build_dist_ell(A, 1, dtype="float64", device=card)
    cols, vals = ell.cols[0], ell.vals[0]
    cpe = plan.compact_ell(cols, vals)
    g = torch.Generator(device=card).manual_seed(5)
    R, nb = cols.shape[0], 24
    x, w1, w2 = (torch.randn((R, nb), generator=g, device=card,
                             dtype=torch.float64) for _ in range(3))
    n0 = build.launches["ell_gather_cheb"]
    y, c = count_ops(lambda: ops.ell_spmv(cols, vals, x, compact=cpe,
                                          epilogue=(w1, w2, 0.3, -0.1)))
    torch.cuda.synchronize()
    assert build.launches["ell_gather_cheb"] == n0 + 1
    want = plan.ell_bytes_per_row(cpe) * R + 4 * R * nb * 8
    k = c.kernels["ell_gather_cheb"]
    assert c.ops == 1 and k["calls"] == 1
    assert k["bytes"] == pytest.approx(want, rel=1e-12)
    assert k["flops"] == 2.0 * cpe.cols.numel() * nb
    on_cpu = [t.cpu() for t in (cols, vals, x, w1, w2)]
    y_cpu, c_cpu = count_ops(lambda: ops.ell_spmv(
        *on_cpu[:3], epilogue=(*on_cpu[3:], 0.3, -0.1)))
    assert c_cpu.kernels == c.kernels and c_cpu.ops == c.ops
    assert torch.equal(y.cpu(), y_cpu)


# ------------------------------------------------- one process per shard --

def _card_rank(rank: int, store: str, outdir: str) -> None:
    """One of two gloo ranks sharing the card: one compressed split-phase
    fused step with the kernels and one redistribution on a 1 × 2 grid,
    each against the one-process grid on the same card."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.core import (ShardGrid, ShardGroup, build_dist_ell,
                                  make_fused_cheb_step, make_redistribute)
    from repro_torch.core.ranks import RankLink, init_ranks

    dev = init_ranks("gloo", "cuda", share_card=True,
                     init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        mat = RoadNet(n=4000, w=2, m=256, k=4)
        ell1 = build_dist_ell(mat, 2, device=dev)
        host = build_dist_ell(mat, 2, device="cpu")
        g1 = ShardGroup(2, dev)
        gr = ShardGroup(2, dev, link=RankLink(range(2), None, dev, "gloo"))
        kw = dict(use_kernel=True, overlap=True, comm="compressed",
                  pipeline=False)
        f1 = make_fused_cheb_step(ell1, group=g1, **kw)
        fr = make_fused_cheb_step(host.held_by(gr), group=gr, **kw)
        gen = torch.Generator(device=dev).manual_seed(3)
        x, w2, V = (torch.randn((ell1.D_pad, 16), generator=gen, device=dev,
                                dtype=torch.float64) for _ in range(3))
        rows = slice(rank * ell1.R, (rank + 1) * ell1.R)
        y1 = f1(x, w2, 0.3, -0.2)
        build.reset_launches()
        yr = fr(x[rows].contiguous(), w2[rows].contiguous(), 0.3, -0.2)
        torch.cuda.synchronize()
        out = dict(step=bool(torch.equal(y1[rows], yr)),
                   launches=dict(build.launches), staged=gr.link.staged,
                   counted=sum(gr.bytes.values()), L=ell1.L)
        grid = ShardGrid(1, 2, dev, ranks=True)
        tp1, ts1 = make_redistribute(ShardGroup(2, dev), 2, "explicit")
        tpr, tsr = make_redistribute(grid.stack, 2, "explicit",
                                     row_link=grid.row_link)
        Vp1, Vpr = tp1(V), tpr(V[rows])
        back = tsr(list(Vpr))
        torch.cuda.synchronize()
        out.update(to_panel=bool(torch.equal(Vp1[rank], Vpr[0])),
                   to_stack=bool(torch.equal(back, V[rows])),
                   redist_bytes=grid.stack.bytes["redistribute"],
                   one_redist_bytes=ell1.D_pad * 8 * 8,
                   redist_staged=grid.row_link.staged)
        with open(os.path.join(outdir, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_share_the_card(card, tmp_path):
    """Two gloo ranks on the one card (``--share-card``): one split-phase
    fused step with the kernels (one ``ell_gather`` and one
    ``ell_gather_cheb`` launch a rank) and one redistribution are each
    bit-equal to the one-process grid's rows; every exchanged byte is
    staged through the host, each way, and counted."""
    import json

    import torch.multiprocessing as mp

    build.load()  # built once, so the ranks only load it
    mp.start_processes(_card_rank, args=(str(tmp_path / "store"),
                                         str(tmp_path)),
                       nprocs=2, start_method="spawn")
    got = [json.loads((tmp_path / f"{r}.json").read_text())
           for r in range(2)]
    for r in got:
        assert r["L"] > 0 and r["step"] and r["to_panel"] and r["to_stack"]
        assert r["launches"] == dict(ell_gather=1, ell_gather_cheb=1,
                                     cheb_dia=0)
        # a compressed round at P = 2: the rank's send, then its receive
        assert r["staged"] == 2 * r["counted"] > 0
        # a move stages its whole send and receive buffers (its own tile
        # too): 2·N_col tiles against the N_col − 1 counted, N_col = 2
        assert r["redist_staged"] == 4 * r["redist_bytes"] > 0
    # to_panel and to_stack: N_s·D_pad·(1 − 1/N_col)·S each, summed over
    # the ranks
    assert sum(r["redist_bytes"] for r in got) == 2 * got[0][
        "one_redist_bytes"]


def _card_sstep_rank(rank: int, store: str, outdir: str) -> None:
    """One of two gloo ranks sharing the card: a degree-5 s-step filter
    (s = 3, compressed cyclic split-phase, the kernels on) against the
    one-process filter on the same card, and the launches of each."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.core import ShardGroup, build_sstep_ell, make_sstep_cheb
    from repro_torch.core.ranks import RankLink, init_ranks

    dev = init_ranks("gloo", "cuda", share_card=True,
                     init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        host = build_sstep_ell(RoadNet(n=4000, w=2, m=256, k=4), 2, 3,
                               split_halo=True, device="cpu")
        g1 = ShardGroup(2, dev)
        gr = ShardGroup(2, dev, link=RankLink(range(2), None, dev, "gloo"))
        kw = dict(use_kernel=True, overlap=True, comm="compressed",
                  schedule="cyclic")
        a1 = make_sstep_cheb(host.held_by(g1), group=g1, **kw)
        ar = make_sstep_cheb(host.held_by(gr), group=gr, **kw)
        gen = torch.Generator(device=dev).manual_seed(4)
        V = torch.randn((host.D_pad, 16), generator=gen, device=dev,
                        dtype=torch.float64)
        rows = slice(rank * host.R, (rank + 1) * host.R)
        mu = [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125]
        build.reset_launches()
        y1 = a1(V, mu, 0.3, -0.2)
        torch.cuda.synchronize()
        one = dict(build.launches)
        build.reset_launches()
        yr = ar(V[rows].contiguous(), mu, 0.3, -0.2)
        torch.cuda.synchronize()
        out = dict(rows=bool(torch.equal(y1[rows], yr)), one=one,
                   launches=dict(build.launches), staged=gr.link.staged,
                   bytes=sum(gr.bytes.values()),
                   one_bytes=sum(g1.bytes.values()))
        with open(os.path.join(outdir, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_run_the_sstep_filter(card, tmp_path):
    """Two gloo ranks on the one card run a degree-5 s-step filter (s =
    3): each rank's rows bit-equal to the one-process filter's, each
    rank's launches of every kernel the one process's (one grouped launch
    for both shards is one launch a rank: 3 ``ell_gather``, 4
    ``ell_gather_cheb``), the bytes summed over the ranks its bytes."""
    import json

    import torch.multiprocessing as mp

    build.load()  # built once, so the ranks only load it
    mp.start_processes(_card_sstep_rank, args=(str(tmp_path / "store"),
                                               str(tmp_path)),
                       nprocs=2, start_method="spawn")
    got = [json.loads((tmp_path / f"{r}.json").read_text())
           for r in range(2)]
    for r in got:
        assert r["rows"]
        assert r["launches"] == r["one"] == dict(ell_gather=3,
                                                 ell_gather_cheb=4,
                                                 cheb_dia=0)
        assert r["staged"] > 0
    assert sum(r["bytes"] for r in got) == got[0]["one_bytes"] > 0


def test_nccl_refuses_a_shared_card(card):
    """nccl with ``--share-card`` raises with the reason, and more ranks
    than cards without ``--share-card`` raise."""
    from repro_torch.core.ranks import init_ranks
    from repro_torch.device import rank_device

    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        init_ranks("nccl", "cuda", share_card=True)
    with pytest.raises(RuntimeError, match="--share-card"):
        rank_device("cuda", 0, torch.cuda.device_count() + 1)
    assert rank_device("cuda", 3, 4, share_card=True).type == "cuda"
