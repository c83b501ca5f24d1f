"""The port's operator, SpMV, fused step, filter, Lanczos and copied host
modules held against the JAX package on the CPU.

The reference runs on a (1, 1) mesh with Auto axes (``make_solver_mesh``
builds Explicit axes, on which the reference's FD path fails under the
installed jax). Inputs are made with numpy from a seed and fed to both.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import AxisType

import repro.core.filter_diag as jfd
import repro.core.filters as jfilters
import repro.matrices.basis as jbasis
from repro.core import build_dist_ell as jbuild, chebyshev_filter as jcheb
from repro.core import make_fused_cheb_step as jfused, make_spmv as jmake_spmv
from repro.core import stack
from repro.core.lanczos import lanczos_interval as jlanczos
from repro.kernels import ops as jops
from repro.matrices import Hubbard as JHubbard, SpinChainXXZ as JSpinChain

import repro_torch.core.filter_diag as tfd
import repro_torch.core.filters as tfilters
import repro_torch.matrices.basis as tbasis
from repro_torch import convert
from repro_torch.core import (build_dist_ell, build_filter, chebyshev_filter,
                              lanczos_interval, make_fused_cheb_step, make_spmv,
                              scale_params)
from repro_torch.kernels import ops
from repro_torch.matrices import Hubbard, SpinChainXXZ, get_family

MATS = {
    "spin10": ("SpinChainXXZ", dict(n_sites=10, n_up=5)),
    "spin12": ("SpinChainXXZ", dict(n_sites=12, n_up=6)),
    "hub6": ("Hubbard", dict(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)),
}
JFAM = {"SpinChainXXZ": JSpinChain, "Hubbard": JHubbard}


def _mesh():
    return jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2)


def _pair(key):
    fam, params = MATS[key]
    return JFAM[fam](**params), get_family(fam, **params)


@pytest.fixture(scope="module")
def mesh():
    return _mesh()


# ------------------------------------------------------------ operator --

@pytest.mark.parametrize("key", list(MATS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_operator_build_equals_reference(key, dtype):
    """cols/vals of the one-shard ELL block and the DIA plan's
    offsets/dvals are equal to the reference's, array for array, and
    carry across through ``convert``."""
    jm, tm = _pair(key)
    jell = jbuild(jm, 1, dtype=np.dtype(dtype))
    tell = build_dist_ell(tm, 1, dtype=dtype)
    assert np.array_equal(tell.cols.numpy(), np.asarray(jell.cols)[0])
    assert np.array_equal(tell.vals.numpy(), np.asarray(jell.vals)[0])
    assert tell.vals.numpy().dtype == np.dtype(dtype)
    jdia = jops.plan_dia(np.asarray(jell.cols), np.asarray(jell.vals), jell.R)
    tdia = ops.plan_dia(tell.cols, tell.vals, tell.R)
    assert tdia is not None and tdia.offsets == jdia.offsets
    assert np.array_equal(tdia.dvals.numpy(), np.asarray(jdia.dvals)[0])
    cell = convert.dist_ell_from_arrays(np.asarray(jell.cols),
                                        np.asarray(jell.vals), D=jell.D)
    assert torch.equal(cell.cols, tell.cols) and torch.equal(cell.vals, tell.vals)
    cdia = convert.dia_plan_from_arrays(jdia.offsets, np.asarray(jdia.dvals))
    assert cdia.offsets == tdia.offsets and torch.equal(cdia.dvals, tdia.dvals)


# ------------------------------------------------ SpMV and fused step --

@pytest.mark.parametrize("key", list(MATS))
@pytest.mark.parametrize("nb", [1, 8])
def test_spmv_and_fused_step_bitwise(mesh, key, nb):
    """fp64 SpMV and one fused step equal the reference bit for bit (the
    addcmul recipe), kernels on (DIA whole-step) and off (ELL + epilogue)."""
    jm, tm = _pair(key)
    rng = np.random.default_rng(nb)
    with mesh:
        jell = jbuild(jm, 1)
        lay = stack(mesh)
        jspmv = jmake_spmv(mesh, lay, jell)
        jstep = jfused(mesh, lay, jell)
        x = rng.standard_normal((jm.D, nb))
        w2 = rng.standard_normal((jm.D, nb))
        a, b = scale_params(-7.3, 11.9)
        y_ref = np.asarray(jspmv(jnp.asarray(x)))
        s_ref = np.asarray(jstep(jnp.asarray(x), jnp.asarray(w2), a, b))
    tell = build_dist_ell(tm, 1)
    for use_kernel in (False, True):
        y = make_spmv(tell, use_kernel=use_kernel)(torch.from_numpy(x))
        assert np.array_equal(y.numpy(), y_ref)
        step = make_fused_cheb_step(tell, use_kernel=use_kernel)
        assert hasattr(step, "dia") == use_kernel  # DIA form taken when on
        s = step(torch.from_numpy(x), torch.from_numpy(w2), a, b)
        assert np.array_equal(s.numpy(), s_ref)


# ------------------------------------------------------------- filter --

@pytest.mark.parametrize("use_kernel", [False, True])
def test_chebyshev_filter_matches_reference(mesh, use_kernel):
    """A degree-128 filter agrees to 1e-12 relative: each step is bitwise
    equal, but XLA fuses the scan's Y + mu_k·T_k and T1 differently from
    torch, and those last-bit differences grow through the recurrence."""
    jm, tm = _pair("hub6")
    rng = np.random.default_rng(3)
    V = rng.standard_normal((jm.D, 4))
    lam = (-9.5, 30.0)
    poly = build_filter((-2.0, 1.0), lam, degree=128)
    a, b = scale_params(*lam)
    with mesh:
        jell = jbuild(jm, 1)
        lay = stack(mesh)
        jspmv = jmake_spmv(mesh, lay, jell)
        want = np.asarray(jax.jit(lambda v: jcheb(jspmv, jnp.asarray(poly.mu),
                                                  a, b, v))(jnp.asarray(V)))
    tell = build_dist_ell(tm, 1)
    fused = make_fused_cheb_step(tell, use_kernel=True) if use_kernel else None
    got = chebyshev_filter(make_spmv(tell, use_kernel=use_kernel), poly.mu,
                           a, b, torch.from_numpy(V), fused_step=fused).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ------------------------------------------------------------ Lanczos --

@pytest.mark.parametrize("key", ["spin12", "hub6"])
def test_lanczos_interval_matches_reference(mesh, key):
    """From the same start vector the interval agrees to 1e-12 relative."""
    jm, tm = _pair(key)
    k0 = jax.random.PRNGKey(11)
    v0 = np.asarray(jax.random.normal(k0, (jm.D, 1)))
    with mesh:
        jell = jbuild(jm, 1)
        jspmv = jax.jit(jmake_spmv(mesh, stack(mesh), jell))
        want = jlanczos(jspmv, jm.D, jm.D, jnp.float64, k0, 30)
    tell = build_dist_ell(tm, 1)
    got = lanczos_interval(make_spmv(tell, use_kernel=True), tm.D,
                           torch.float64, "cpu", v0=v0, steps=30)
    scale = want[1] - want[0]
    assert abs(got[0] - want[0]) <= 1e-12 * scale
    assert abs(got[1] - want[1]) <= 1e-12 * scale


# ----------------------------------------------------- orthogonalize --

def test_orthogonalize_matches_reference(mesh):
    """TSQR's local QR with the sign fix, the Gram product and SVQB agree
    with the reference's to 1e-12 (LAPACK QR/eigh differ in the last bits
    between the two backends, so not bitwise)."""
    from repro.core import make_gram, make_svqb, make_tsqr
    from repro_torch.core import gram, qr_fixed, svqb

    rng = np.random.default_rng(4)
    V = rng.standard_normal((300, 12))
    W = rng.standard_normal((300, 12))
    with mesh:
        lay = stack(mesh)
        jQ, jR = (np.asarray(a) for a in make_tsqr(mesh, lay)(jnp.asarray(V)))
        jG = np.asarray(make_gram(mesh, lay)(jnp.asarray(V), jnp.asarray(W)))
        jS = np.asarray(make_svqb(mesh, lay)(jnp.asarray(V)))
    Q, R = (t.numpy() for t in qr_fixed(torch.from_numpy(V)))
    assert (np.diag(R) > 0).all()
    np.testing.assert_allclose(Q, jQ, rtol=0, atol=1e-12)
    np.testing.assert_allclose(R, jR, rtol=0, atol=1e-12 * np.abs(jR).max())
    np.testing.assert_allclose(gram(torch.from_numpy(V), torch.from_numpy(W)).numpy(),
                               jG, rtol=0, atol=1e-12 * np.abs(jG).max())
    S = svqb(torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(S.T @ S, np.eye(12), atol=1e-12)
    # the same basis up to the order/sign of eigenvectors: equal projectors
    np.testing.assert_allclose(S @ S.T, jS @ jS.T, atol=1e-12)


# ----------------------------------------------------- copied modules --

def test_basis_copy_equals_reference():
    rng = np.random.default_rng(0)
    for n, k in [(10, 5), (12, 6), (14, 3)]:
        assert np.array_equal(tbasis.binom_table(n), jbasis.binom_table(n))
        masks = tbasis.enumerate_masks(n, k)
        assert np.array_equal(masks, jbasis.enumerate_masks(n, k))
        ranks = rng.integers(0, len(masks), 50)
        assert np.array_equal(tbasis.unrank(ranks, n, k), jbasis.unrank(ranks, n, k))
        assert np.array_equal(tbasis.rank_masks(masks, n, k),
                              jbasis.rank_masks(masks, n, k))
        for per in (False, True):
            for a, b in zip(tbasis.hop_neighbors(masks, n, k, per),
                            jbasis.hop_neighbors(masks, n, k, per)):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("fam,params", [
    ("Hubbard", dict(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)),
    ("Hubbard", dict(n_sites=8, n_fermions=4)),
    ("Hubbard", dict(n_sites=7, n_fermions=2, t=0.5, U=2.0, ranpot=0.3, seed=3)),
    ("SpinChainXXZ", dict(n_sites=12, n_up=6)),
    ("SpinChainXXZ", dict(n_sites=11, n_up=4, Jxy=0.7, Jz=1.3)),
])
def test_generator_copies_equal_reference(fam, params):
    jm, tm = JFAM[fam](**params), get_family(fam, **params)
    assert (tm.D, tm.describe()) == (jm.D, jm.describe())
    rows = np.random.default_rng(1).permutation(jm.D)[:200]
    for a, b in zip(tm.row_entries(rows), jm.row_entries(rows)):
        assert np.array_equal(a, b)
    for a, b in zip(tm.row_cols(rows), jm.row_cols(rows)):
        assert np.array_equal(a, b)
    jc, tc = jm.build_csr(), tm.build_csr()
    assert np.array_equal(tc.indptr, jc.indptr)
    assert np.array_equal(tc.indices, jc.indices)
    assert np.array_equal(tc.data, jc.data)


def test_filters_copy_equals_reference():
    for n in (2, 17, 300):
        assert np.array_equal(tfilters.jackson_damping(n), jfilters.jackson_damping(n))
        assert np.array_equal(tfilters.window_coeffs(-0.3, 0.4, n),
                              jfilters.window_coeffs(-0.3, 0.4, n))
    for search, lam in [((-0.2, 0.1), (-3.0, 3.0)), ((1.0, 2.5), (0.5, 40.0))]:
        assert tfilters.degree_for(search, lam) == jfilters.degree_for(search, lam)
        p, q = tfilters.build_filter(search, lam), jfilters.build_filter(search, lam)
        assert p.degree == q.degree and np.array_equal(p.mu, q.mu)
        x = np.linspace(*lam, 7)
        assert np.array_equal(p.eval(x), q.eval(x))


def test_fdconfig_fields_equal_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tfd.FDConfig) == fields(jfd.FDConfig)


def test_hubbard_main_path_config_has_a_dia_form():
    """Hubbard(6,3) fits the DIA kernel's 64 diagonals, so the fused
    step takes the DIA route; the main path's Hubbard(12,6) does too
    (61 diagonals), counted on the card by chip_smoke.py."""
    tell = build_dist_ell(Hubbard(6, 3, U=4.0, ranpot=1.0), 1)
    dia = ops.plan_dia(tell.cols, tell.vals, tell.R)
    assert dia is not None and len(dia.offsets) <= ops.DIA_MAX_DIAGS
    assert build_dist_ell(SpinChainXXZ(10, 5), 1).W == 10
