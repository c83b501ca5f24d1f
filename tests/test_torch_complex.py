"""Complex operators in the port, held against the JAX package on the CPU.

The reference's complex solves never reach its 4-real-plane DIA split
(``repro/kernels/ops.py:261-274``): its ``plan_dia`` refuses complex values,
so a complex SpMV is its jnp ELL scan and the fused step that scan plus the
XLA epilogue. That path rounds each complex product's planes as one FMA
over a rounded product each (``fma(vr, xr, −vi·xi)``,
``fma(vi, xr, vr·xi)``) and then adds once, which is what
``repro_torch.kernels.ref.mac`` spells; so in complex128 the port's
SpMV and single fused step equal the reference's bit for bit, on both of
the port's routes (the DIA plain version and the ELL plain version plus
epilogue), and so do the plain versions that follow the CUDA kernels'
schedule. Complex64 is held to a tolerance (the fp32 rule).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import build_dist_ell as jbuild
from repro.core import make_fused_cheb_step as jfused, make_spmv as jmake_spmv
from repro.core import stack
from repro.kernels import ref as jref
from repro.matrices import Exciton as JExciton, TopIns as JTopIns

from repro_torch import convert
from repro_torch.core import build_dist_ell, make_fused_cheb_step, make_spmv
from repro_torch.kernels import ops, plan, ref
from repro_torch.matrices import Exciton, TopIns
from repro_torch.matrices.matfree import dia_from_family

FAMS = {
    "exciton3": (JExciton, Exciton, dict(L=3)),
    "topins4": (JTopIns, TopIns, dict(Lx=4)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _crandn(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2)


def _reference(mesh, key, dtype, x, w2, a, b):
    """The reference's jitted SpMV and fused step of ``key`` in ``dtype``."""
    jfam, _, params = FAMS[key]
    jm = jfam(**params)
    with mesh:
        jell = jbuild(jm, 1, dtype=np.dtype(dtype))
        lay = stack(mesh)
        spmv = jax.jit(jmake_spmv(mesh, lay, jell))
        step = jfused(mesh, lay, jell)
        return (np.asarray(spmv(jnp.asarray(x))),
                np.asarray(step(jnp.asarray(x), jnp.asarray(w2), a, b)))


@pytest.mark.parametrize("key", list(FAMS))
@pytest.mark.parametrize("nb", [1, 8])
def test_complex128_spmv_and_fused_step_bitwise(mesh, key, nb):
    """complex128: the SpMV and one fused step equal the reference's with
    ``np.array_equal`` with the kernels on (the DIA whole step) and off
    (ELL + epilogue), and so do the kernel-schedule plain versions
    (``ell_spmv_slab_ref``, ``cheb_dia_compact_ref`` over the complex
    compact form with its value table) at several slab widths."""
    _, fam, params = FAMS[key]
    tm = fam(**params)
    rng = np.random.default_rng(nb)
    x = _crandn(rng, (tm.D, nb))
    w2 = _crandn(rng, (tm.D, nb))
    a, b = 0.37, -0.21
    y_ref, s_ref = _reference(mesh, key, np.complex128, x, w2, a, b)
    tell = build_dist_ell(tm, 1)
    assert tell.vals.dtype == torch.complex128
    for use_kernel in (False, True):
        y = make_spmv(tell, use_kernel=use_kernel)(_t(x))
        assert np.array_equal(y.numpy(), y_ref)
        step = make_fused_cheb_step(tell, use_kernel=use_kernel)
        assert hasattr(step, "dia") == use_kernel  # the DIA route when on
        s = step(_t(x), _t(w2), a, b)
        assert np.array_equal(s.numpy(), s_ref)
    dia = step.dia
    cp = dia.compact
    assert cp.table is not None and cp.table.dtype == torch.complex128
    for c in sorted({1, 3, nb}):
        if c > nb:
            continue
        got = ref.ell_spmv_slab_ref(tell.cols, tell.vals, _t(x), None, c)
        assert np.array_equal(got.numpy(), y_ref)
        got = ref.cheb_dia_compact_ref(dia.offsets, cp, _t(x), _t(x), _t(w2),
                                       a, b, c)
        assert np.array_equal(got.numpy(), s_ref)


@pytest.mark.parametrize("key", list(FAMS))
def test_complex64_spmv_and_fused_step_within_tolerance(mesh, key):
    """complex64 (a complex family solved with ``dtype="float32"``): the
    port's operator is the reference's, and the SpMV and fused step agree
    to 1e-6 relative to max|y| on both routes."""
    _, fam, params = FAMS[key]
    tm = fam(**params)
    rng = np.random.default_rng(5)
    x = _crandn(rng, (tm.D, 6), np.complex64)
    w2 = _crandn(rng, (tm.D, 6), np.complex64)
    y_ref, s_ref = _reference(mesh, key, np.complex64, x, w2, 0.37, -0.21)
    tell = build_dist_ell(tm, 1, dtype="float32")
    assert tell.vals.dtype == torch.complex64
    for use_kernel in (False, True):
        y = make_spmv(tell, use_kernel=use_kernel)(_t(x)).numpy()
        s = make_fused_cheb_step(tell, use_kernel=use_kernel)(
            _t(x), _t(w2), 0.37, -0.21).numpy()
        assert y.dtype == s.dtype == np.complex64
        assert np.abs(y - y_ref).max() <= 1e-6 * np.abs(y_ref).max()
        assert np.abs(s - s_ref).max() <= 1e-6 * np.abs(s_ref).max()


def test_mac_spelling_equals_the_reference():
    """The plain versions' complex product, spelled on the real planes,
    equals the reference's scan body on random complex values bit for bit
    (both planes of every value non-zero, so no FMA placement goes unseen:
    the lattice operators' entries are real or imaginary, and any spelling
    matches on them), and differs from complex ``torch.addcmul``, which
    rounds every product. The ELL plain version equals the reference's
    scan on a random complex block."""
    rng = np.random.default_rng(3)
    acc, v, x = (_crandn(rng, (500, 7)) for _ in range(3))
    got = ref.mac(_t(acc), _t(v), _t(x)).numpy()
    ones = np.zeros((500, 1), np.int32) + np.arange(500, dtype=np.int32)[:, None]
    for j in range(7):
        want = np.asarray(jref.ell_spmv_acc_ref(
            jnp.asarray(acc[:, j:j + 1]), jnp.asarray(ones),
            jnp.asarray(v[:, j:j + 1]), jnp.asarray(x[:, j:j + 1])))
        assert np.array_equal(got[:, j:j + 1], want)
    assert not np.array_equal(got, torch.addcmul(_t(acc), _t(v), _t(x)).numpy())
    R, Rx, W = 300, 410, 9
    cols = rng.integers(0, Rx, size=(R, W)).astype(np.int32)
    vals = _crandn(rng, (R, W))
    vals[rng.random((R, W)) < 0.3] = 0
    xb = _crandn(rng, (Rx, 5))
    y0 = _crandn(rng, (R, 5))
    want = np.asarray(jref.ell_spmv_acc_ref(jnp.asarray(y0), jnp.asarray(cols),
                                            jnp.asarray(vals), jnp.asarray(xb)))
    assert np.array_equal(ops.ell_spmv(_t(cols), _t(vals), _t(xb), _t(y0)).numpy(),
                          want)
    # a complex compact ELL form keeps each row's stored entries
    cpe = plan.compact_ell(_t(cols), _t(vals))
    c2, v2 = cpe.to_ell()
    assert torch.equal(ref.ell_spmv_ref(c2, v2, _t(xb)),
                       ref.ell_spmv_ref(_t(cols), _t(vals), _t(xb)))


def test_dia_matches_matrix_family():
    """The reference's own kernel gate (``tests/test_kernels.py``'s
    ``test_dia_matches_matrix_family``) on the port: the DIA step on the
    Exciton(L=2) stencil from ``dia_from_family`` (complex64, padded rows)
    equals the CSR product, to the reference's 2e-4; the port's own plan
    in complex128 equals it to 1e-13."""
    fam = Exciton(L=2)  # D = 375
    offsets, dvals, R = dia_from_family(fam, pad_to=128)
    csr = fam.build_csr()
    rng = np.random.default_rng(0)
    nb = 128
    x = _crandn(rng, (R, nb), np.complex64)
    x[fam.D:] = 0
    w = np.zeros_like(x)
    y = ops.cheb_dia(tuple(offsets), _t(dvals), _t(x), _t(w), _t(w), 0.5, 0.0)
    y_ref = csr.matvec(x[: fam.D])
    np.testing.assert_allclose(y.numpy()[: fam.D], y_ref, rtol=2e-4, atol=2e-4)
    ell = build_dist_ell(fam, 1)
    dia = ops.plan_dia(ell.cols, ell.vals, ell.R)
    x128 = _t(x[: fam.D].astype(np.complex128))
    w128 = torch.zeros_like(x128)
    y = ops.cheb_dia(dia.offsets, dia.dvals, x128, w128, w128, 0.5, 0.0)
    np.testing.assert_allclose(y.numpy(), csr.matvec(x128.numpy()), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("fam", [Exciton(L=3), TopIns(5)])
def test_complex_compact_dia_form(fam):
    """The compact DIA form of a complex lattice operator: its values off
    the main diagonal in a table (Exciton: −t and the spin-orbit entries,
    TopIns: the hop blocks' entries), the Coulomb term dense on the main
    diagonal; it rebuilds dvals exactly."""
    ell = build_dist_ell(fam, 1)
    dia = ops.plan_dia(ell.cols, ell.vals, ell.R)
    cp = dia.compact
    assert cp.table is not None and cp.vals is None
    assert 1 < cp.table.numel() <= plan.TABLE_MAX and cp.vidx is not None
    assert (cp.diag is not None) == (0 in dia.offsets)
    assert torch.equal(cp.to_dvals(len(dia.offsets)), dia.dvals)
    assert cp.dtype == torch.complex128


def test_convert_carries_complex_objects():
    """A complex DistEll, DiaPlan and FDState come across ``convert``
    unchanged."""
    jm = JExciton(L=2)
    jell = jbuild(jm, 1, dtype=np.complex128)
    cell = convert.dist_ell_from_arrays(np.asarray(jell.cols),
                                        np.asarray(jell.vals), D=jell.D)
    tell = build_dist_ell(Exciton(L=2), 1)
    assert torch.equal(cell.vals, tell.vals) and cell.span == tell.span
    dia = ops.plan_dia(tell.cols, tell.vals, tell.R)
    cdia = convert.dia_plan_from_arrays(dia.offsets, dia.dvals.numpy()[None])
    assert cdia.offsets == dia.offsets and torch.equal(cdia.dvals, dia.dvals)
    V = _crandn(np.random.default_rng(1), (jm.D, 4))
    st = convert.fd_state_from_arrays(V, (-9.5, 13.5), iteration=2)
    assert st.V.dtype == torch.complex128 and np.array_equal(st.V.numpy(), V)
    assert st.lam == (-9.5, 13.5) and st.iteration == 2
