"""The port's kernels held against the JAX package's.

On the CPU the port's plain versions (``repro_torch.kernels.ref``, reached
through ``ops``) are compared with ``repro.kernels.ref`` and with the
Pallas kernels in interpret mode, on the shapes of ``tests/test_kernels.py``
plus a halo-extended ``x`` (Rx > R) and ragged R / n_b. The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cheb_dia import cheb_dia as pallas_cheb_dia
from repro.kernels.ell_gather import build_tiles, ell_gather_spmv as pallas_ell

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.cheb_dia import cheb_dia as cuda_cheb_dia
from repro_torch.kernels.ell_gather import ell_gather_spmv as cuda_ell


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ell_block(rng, R, Rx, W, density, dtype):
    cols = rng.integers(0, Rx, size=(R, W)).astype(np.int32)
    vals = rng.standard_normal((R, W)).astype(dtype)
    vals[rng.random((R, W)) >= density] = 0.0
    return cols, vals


def _mk_dia(rng, R, offsets, dtype, Rx=None):
    Rx = R if Rx is None else Rx
    dvals = rng.standard_normal((len(offsets), R)).astype(dtype)
    idx = np.arange(R)
    for d, o in enumerate(offsets):
        dvals[d, (idx + o < 0) | (idx + o >= Rx)] = 0.0
    return dvals


# ----------------------------------------------------------------- ELL --

ELL_CASES = [  # R, Rx, W, nb, density
    (256, 2048, 7, 128, 0.6),   # test_kernels.py's tile-kernel block
    (256, 256, 12, 8, 1.0),
    (257, 300, 5, 3, 0.5),      # ragged R and n_b, halo-extended x
    (100, 161, 9, 1, 0.8),      # n_b = 1 (the Lanczos shape)
]


@pytest.mark.parametrize("R,Rx,W,nb,density", ELL_CASES)
def test_ell_plain_bitwise_vs_reference_fp64(R, Rx, W, nb, density):
    """fp64: the addcmul slot loop rounds exactly as the reference's
    FMA-contracted scan, so the results are equal bit for bit; with an
    accumulator threaded in (y0) as well."""
    rng = np.random.default_rng(R * 7 + nb)
    cols, vals = _ell_block(rng, R, Rx, W, density, np.float64)
    x = rng.standard_normal((Rx, nb))
    y0 = rng.standard_normal((R, nb))
    want = np.asarray(jref.ell_spmv_ref(jnp.asarray(cols), jnp.asarray(vals),
                                        jnp.asarray(x)))
    got = ops.ell_spmv(_t(cols), _t(vals), _t(x)).numpy()
    assert np.array_equal(got, want)
    want0 = np.asarray(jref.ell_spmv_acc_ref(jnp.asarray(y0), jnp.asarray(cols),
                                             jnp.asarray(vals), jnp.asarray(x)))
    got0 = ops.ell_spmv(_t(cols), _t(vals), _t(x), _t(y0)).numpy()
    assert np.array_equal(got0, want0)


@pytest.mark.parametrize("R,Rx,W,nb,density", ELL_CASES)
def test_ell_plain_vs_reference_fp32(R, Rx, W, nb, density):
    """fp32: both sides accumulate in fp32 with one rounding per entry;
    held to 1e-6 relative to max|y| (a few fp32 ulps) because the two
    backends need not pick the same vector FMA instructions."""
    rng = np.random.default_rng(R * 11 + nb)
    cols, vals = _ell_block(rng, R, Rx, W, density, np.float32)
    x = rng.standard_normal((Rx, nb)).astype(np.float32)
    want = np.asarray(jref.ell_spmv_ref(jnp.asarray(cols), jnp.asarray(vals),
                                        jnp.asarray(x)))
    got = ops.ell_spmv(_t(cols), _t(vals), _t(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("W,density,br,bc", [(7, 0.6, 256, 512),
                                             (12, 1.0, 64, 256)])
def test_ell_plain_bitwise_vs_pallas_interpret(W, density, br, bc):
    """The interpret-mode Pallas tile kernel is bit-identical to the scan
    reference (tests/test_kernels.py), so to the port's plain version."""
    rng = np.random.default_rng(W)
    R, Rx, nb = 256, 2048, 128
    cols, vals = _ell_block(rng, R, Rx, W, density, np.float64)
    x = rng.standard_normal((Rx, nb))
    tile_cb, tcols, tvals = build_tiles(cols, vals, Rx, br=br, bc=bc)
    want = np.asarray(pallas_ell(jnp.asarray(tile_cb), jnp.asarray(tcols),
                                 jnp.asarray(tvals), jnp.asarray(x),
                                 br=br, bc=bc, bn=nb, interpret=True))
    got = ops.ell_spmv(_t(cols), _t(vals), _t(x)).numpy()
    assert np.array_equal(got, want)


# ----------------------------------------------------------------- DIA --

DIA_CASES = [  # R, Rx, nb, offsets
    (64, 64, 128, (-21, -7, -1, 0, 2, 9, 16)),
    (256, 256, 128, (-85, -7, -1, 0, 2, 9, 64)),
    (512, 512, 256, (-170, -7, -1, 0, 2, 9, 128)),
    (1024, 1024, 384, (-341, -7, -1, 0, 2, 9, 256)),
    (128, 256, 128, (0, 100)),          # x longer than R: the halo region
    (100, 130, 3, (-13, -1, 0, 1, 29)),  # ragged R and n_b
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R,Rx,nb,offsets", DIA_CASES)
def test_cheb_dia_plain_vs_reference(R, Rx, nb, offsets, dtype):
    """The reference sums ``acc + where(ok, d·x, 0)`` (the product rounded
    before the add) while the port fuses each entry into one rounding, as
    its ELL contraction does: the results differ in the last bits only,
    ≤ 1e-14 (fp64) / 1e-6 (fp32) relative to max|y|."""
    rng = np.random.default_rng(R + nb)
    dvals = _mk_dia(rng, R, offsets, dtype, Rx)
    x = rng.standard_normal((Rx, nb)).astype(dtype)
    w1 = rng.standard_normal((R, nb)).astype(dtype)
    w2 = rng.standard_normal((R, nb)).astype(dtype)
    a, b = 1.1, -0.3
    want = np.asarray(jref.cheb_dia_ref(offsets, jnp.asarray(dvals), jnp.asarray(x),
                                        jnp.asarray(w1), jnp.asarray(w2), a, b))
    got = ops.cheb_dia(offsets, _t(dvals), _t(x), _t(w1), _t(w2), a, b).numpy()
    tol = 1e-14 if dtype == np.float64 else 1e-6
    assert got.dtype == dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("R,Rx,nb,offsets,br", [
    (256, 256, 128, (-85, -7, -1, 0, 2, 9, 64), 64),
    (128, 256, 128, (0, 100), 64),
])
def test_cheb_dia_plain_vs_pallas_interpret(R, Rx, nb, offsets, br):
    """Same rounding difference as against the reference: ≤ 1e-14."""
    rng = np.random.default_rng(R)
    dvals = _mk_dia(rng, R, offsets, np.float64, Rx)
    x = rng.standard_normal((Rx, nb))
    w1 = rng.standard_normal((R, nb))
    w2 = rng.standard_normal((R, nb))
    want = np.asarray(pallas_cheb_dia(offsets, jnp.asarray(dvals), jnp.asarray(x),
                                      jnp.asarray(w1), jnp.asarray(w2), 0.7, 0.2,
                                      br=br, bn=128, interpret=True))
    got = ops.cheb_dia(offsets, _t(dvals), _t(x), _t(w1), _t(w2), 0.7, 0.2).numpy()
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_cheb_dia_equals_ell_step_bitwise():
    """Ascending offsets are the ELL slot order and a missing entry adds
    fma(0, x, acc) == acc: the DIA step equals ELL contraction + epilogue
    bit for bit in fp64 — why the structural choice changes no result."""
    rng = np.random.default_rng(5)
    R, nb = 200, 6
    offsets = (-40, -3, 0, 1, 17)
    dvals = _mk_dia(rng, R, offsets, np.float64)
    dvals[rng.random(dvals.shape) < 0.3] = 0.0
    rows, dd = np.nonzero(dvals.T)
    counts = np.bincount(rows, minlength=R)
    W = counts.max()
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    cols = np.zeros((R, W), np.int32)
    vals = np.zeros((R, W))
    cols[rows, slot] = rows + np.asarray(offsets)[dd]
    vals[rows, slot] = dvals[dd, rows]
    x = rng.standard_normal((R, nb))
    w2 = rng.standard_normal((R, nb))
    dia = ops.cheb_dia(offsets, _t(dvals), _t(x), _t(x), _t(w2), 0.9, -0.4)
    ell = ref.cheb_epilogue(ops.ell_spmv(_t(cols), _t(vals), _t(x)), _t(x),
                            _t(w2), 0.9, -0.4)
    assert torch.equal(dia, ell)
    plan = ops.plan_dia(cols, vals, R)
    assert plan.offsets == offsets
    assert np.array_equal(plan.dvals.numpy(), dvals)


@pytest.mark.parametrize("n_diag,halo,dtype", [
    (5, False, np.float64), (64, False, np.float32), (65, False, np.float64),
    (5, True, np.float64), (5, False, np.complex128), (64, False, np.complex128),
])
def test_plan_dia_matches_reference(n_diag, halo, dtype):
    """The vectorized planner equals the reference's per-entry loop,
    refusals included (> 64 diagonals, halo columns). Complex values are
    the one place the port plans where the reference refuses: its plan of
    a complex block is the reference's plan of each real plane."""
    rng = np.random.default_rng(n_diag)
    R, W = 300, 6
    offs = rng.choice(np.arange(-150, 150), size=n_diag, replace=False)
    rows = np.arange(R)[:, None]
    pick = rng.integers(0, n_diag, size=(R, W))
    cols = np.clip(rows + offs[pick], 0, R - 1)
    if halo:
        cols[0, 0] = R + 3
    vals = rng.standard_normal((R, W)).astype(dtype)
    vals[rng.random((R, W)) < 0.2] = 0.0
    # one entry per (row, column): keep the first slot of each duplicate
    srt = np.sort(cols, axis=1)
    dup = np.zeros_like(cols, dtype=bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    cols, vals = srt.astype(np.int32), np.where(dup, 0, vals)
    if np.iscomplexobj(vals):
        vals = vals + 1j * rng.standard_normal((R, W))
        vals[rng.random((R, W)) < 0.2] = 0.0
        vals = np.where(dup, 0, vals)
        assert jops.plan_dia(cols[None], vals[None], R) is None
        got = ops.plan_dia(cols, vals, R)
        for part, plane in ((np.real, "real"), (np.imag, "imag")):
            want = jops.plan_dia(cols[None], part(vals)[None], R)
            assert (got is None) == (want is None)
            if want is not None:
                assert got.offsets == want.offsets
                assert np.array_equal(getattr(got.dvals, plane).numpy(),
                                      np.asarray(want.dvals)[0])
        return
    want = jops.plan_dia(cols[None], vals[None], R)
    got = ops.plan_dia(cols, vals, R)
    if want is None:
        assert got is None
        return
    assert got.offsets == want.offsets
    assert np.array_equal(got.dvals.numpy(), np.asarray(want.dvals)[0])


# ------------------------------------------------------------ dispatch --

def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors never reach a kernel: no launch is counted."""
    rng = np.random.default_rng(0)
    cols, vals = _ell_block(rng, 16, 16, 3, 1.0, np.float64)
    x = rng.standard_normal((16, 2))
    before = dict(build.launches)
    ops.ell_spmv(_t(cols), _t(vals), _t(x))
    ops.cheb_dia((0,), _t(np.ones((1, 16))), _t(x), _t(x), _t(x), 1.0, 0.0)
    assert build.launches == before


def test_kernel_wrappers_refuse_cpu_and_complex():
    """The CUDA wrappers launch or raise; nothing falls back. Complex
    operands are taken (the kernels have complex128 and complex64
    entries): on the CPU the wrappers refuse them for their device alone,
    and ``ops`` sends them to the plain versions, which compute the
    product."""
    cols = torch.zeros((4, 1), dtype=torch.int32)
    vals = torch.ones((4, 1), dtype=torch.float64)
    x = torch.ones((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ell(cols, vals, x)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cheb_dia((0,), vals.T.contiguous(), x, x, x, 1.0, 0.0)
    cv, cx = vals.to(torch.complex128) * (2 - 1j), x.to(torch.complex128) * 1j
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ell(cols, cv, cx)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cheb_dia((0,), cv.T.contiguous(), cx, cx, cx, 1.0, 0.0)
    before = dict(build.launches)
    want = torch.full((4, 2), (2 - 1j) * 1j, dtype=torch.complex128)
    assert torch.equal(ops.ell_spmv(cols, cv, cx), want)
    assert torch.equal(ops.cheb_dia((0,), cv.T.contiguous(), cx, cx, cx,
                                    0.5, 0.0), want - cx)
    assert build.launches == before
