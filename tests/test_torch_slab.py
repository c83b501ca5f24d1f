"""The host-side plan of the kernels' slab-ordered sweep, on the CPU.

The compact DIA form, the recorded span of an operator and the slab-width
rule (``repro_torch.kernels.plan``), and the plain versions that follow the
CUDA kernels' schedule (``ref.cheb_dia_compact_ref``,
``ref.ell_spmv_slab_ref``): the CUDA kernels themselves run only on the
card (``tests/test_torch_cuda.py``). Inputs are made with numpy from a
seed; the JAX package's reference is the yardstick where it has one.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import build_dist_ell as jbuild
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.matrices import Hubbard as JHubbard, SpinChainXXZ as JSpinChain

from repro_torch import convert
from repro_torch.core import build_dist_ell
from repro_torch.kernels import ops, plan, ref
from repro_torch.matrices import Hubbard, SpinChainXXZ

MATS = {
    "hub6": (JHubbard, Hubbard, dict(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)),
    "spin10": (JSpinChain, SpinChainXXZ, dict(n_sites=10, n_up=5)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operator(key):
    _, fam, params = MATS[key]
    ell = build_dist_ell(fam(**params), 1)
    return ell, ops.plan_dia(ell.cols, ell.vals, ell.R)


def _random_dia(rng, R, Rx, offsets, dtype, sparsity=0.3):
    dvals = rng.standard_normal((len(offsets), R)).astype(dtype)
    idx = np.arange(R)
    for d, o in enumerate(offsets):
        dvals[d, (idx + o < 0) | (idx + o >= Rx)] = 0.0
    dvals[rng.random(dvals.shape) < sparsity] = 0.0
    return dvals


# ------------------------------------------------------ compact form --

@pytest.mark.parametrize("key", list(MATS))
def test_compact_dia_rebuilds_dvals_in_offset_order(key):
    """The compact form holds exactly the stored entries of dvals, each
    row's ids strictly ascending (the ELL slot order)."""
    _, dia = _operator(key)
    cp = dia.compact
    n_diag, R = dia.dvals.shape
    assert cp.R == R and cp.nnz == int((dia.dvals != 0).sum())
    assert torch.equal(cp.to_dvals(n_diag), dia.dvals)
    rp = cp.rowptr.to(torch.int64)
    assert cp.rowptr.dtype == torch.int32 and cp.ids.dtype == torch.uint8
    assert int(rp[0]) == 0 and int(rp[-1]) == cp.nnz
    assert cp.max_row == int((rp[1:] - rp[:-1]).max())
    ids = cp.ids.to(torch.int64)
    same_row = torch.repeat_interleave(torch.arange(R), rp[1:] - rp[:-1])
    step = ids[1:] - ids[:-1]
    assert bool((step[same_row[1:] == same_row[:-1]] > 0).all())
    assert cp.ids.numel() == cp.nnz
    # lattice models: one value off the main diagonal (−t, J/2), kept in a
    # table; the main diagonal dense
    assert cp.vals is None and cp.table.numel() == 1 and cp.vidx is None
    assert torch.equal(cp.diag, dia.dvals[dia.offsets.index(0)])
    assert cp.bytes_per_row < 2 * cp.nnz / R + 8 + 4 + 1e-9


@pytest.mark.parametrize("n_values", [1, 3, 256, 2000])
def test_compact_dia_value_table(n_values):
    """Off-diagonal values from a table of up to 256 (uint8 indices; none
    for one value), per entry beyond; either way the form rebuilds dvals
    exactly, with or without a main diagonal."""
    rng = np.random.default_rng(n_values)
    R, offsets = 300, (-7, -2, 0, 5)
    pool = rng.standard_normal(n_values)
    dvals = pool[rng.integers(0, n_values, size=(4, R))]
    dvals[2] = rng.standard_normal(R)
    dvals[rng.random(dvals.shape) < 0.2] = 0.0
    dvals = _t(dvals)
    for diag_id in (2, None):
        d = dvals if diag_id is not None else dvals[[0, 1, 3]]
        cp = plan.compact_dia(d, diag_id)
        assert torch.equal(cp.to_dvals(d.shape[0]), d)
        off = d[[0, 1, 3]] if diag_id is not None else d
        distinct = len(torch.unique(off[off != 0]))
        assert (cp.table is not None) == (distinct <= plan.TABLE_MAX)
        if cp.table is not None:
            assert (cp.vidx is None) == (distinct == 1) and cp.vals is None
            assert (cp.diag is not None) == (diag_id is not None)


@pytest.mark.parametrize("key", list(MATS))
def test_recorded_span_is_max_distance(key):
    """The span recorded on the ELL operator and on its DIA plan is
    ``max |col − row|`` over the stored entries (padding ignored), and
    carries across ``convert``."""
    ell, dia = _operator(key)
    cols, vals = ell.cols.numpy(), ell.vals.numpy()
    rows = np.broadcast_to(np.arange(ell.R)[:, None], cols.shape)
    want = int(np.abs(cols - rows)[vals != 0].max())
    assert want > 0
    assert ell.span == want and dia.span == want
    assert plan.span_of_ell(ell.cols, ell.vals) == want
    assert plan.span_of_dia(dia.offsets, dia.dvals) == want
    jm = MATS[key][0](**MATS[key][2])
    jell = jbuild(jm, 1)
    cell = convert.dist_ell_from_arrays(np.asarray(jell.cols),
                                        np.asarray(jell.vals))
    assert cell.span == want


def _ell_case(key):
    """An ELL block: a lattice model's, or a random one with zero slots
    inside rows, padding at their ends and an empty row."""
    if key in MATS:
        ell, _ = _operator(key)
        return ell.cols, ell.vals
    rng = np.random.default_rng(11)
    R, Rx, W = 700, 900, 9
    cols = rng.integers(0, Rx, size=(R, W)).astype(np.int32)
    vals = rng.standard_normal((R, W))
    vals[rng.random((R, W)) < 0.3] = 0.0
    vals[:, W - 2:] = 0.0
    vals[5] = 0.0
    return _t(cols), _t(vals)


@pytest.mark.parametrize("key", list(MATS) + ["random"])
def test_compact_ell_keeps_stored_entries_in_slot_order(key):
    """The padding-free ELL form holds each row's stored entries in slot
    order with int32 row pointers, bounds every 256-row tile, and a
    contraction over it (re-padded to its widest row) is bit-equal to one
    over the padded block."""
    cols, vals = _ell_case(key)
    cp = plan.compact_ell(cols, vals)
    nz = vals != 0
    counts = nz.sum(dim=1)
    assert cp.rowptr.dtype == torch.int32 and cp.cols.dtype == torch.int32
    assert cp.R == cols.shape[0] and int(cp.rowptr[0]) == 0
    assert torch.equal((cp.rowptr[1:] - cp.rowptr[:-1]).to(torch.int64),
                       counts)
    assert torch.equal(cp.cols, cols[nz]) and torch.equal(cp.vals, vals[nz])
    assert cp.max_row == int(counts.max())
    rows = plan.ELL_TILE_ROWS
    assert cp.tile_max == max(int(counts[r:r + rows].sum())
                              for r in range(0, cp.R, rows))
    c2, v2 = cp.to_ell()
    x = _t(np.random.default_rng(3).standard_normal((int(cols.max()) + 1, 5)))
    x = x.to(vals.dtype)
    assert torch.equal(ref.ell_spmv_ref(c2, v2, x),
                       ref.ell_spmv_ref(cols, vals, x))


@pytest.mark.parametrize("R", [1, 127, 128, 256, 300, 1024])
@pytest.mark.parametrize("rows", [1, 128, 256])
def test_tile_max_covers_every_tile(R, rows):
    """``tile_max`` is the most entries in any ``rows`` rows from a
    multiple of ``rows``, when R is a multiple of ``rows`` too (TopIns(40),
    R = 256,000 = 2,000 · 128, once made the last tile's bound run off the
    row pointers)."""
    counts = torch.as_tensor(np.random.default_rng(R + rows).integers(0, 9, R))
    rp = plan.row_pointers(counts)
    want = max(int(counts[r:r + rows].sum()) for r in range(0, R, rows))
    assert plan.tile_max(rp, rows) == want


# -------------------------------------------------------- slab rule --

@pytest.mark.parametrize("S", [8, 4])
def test_slab_rule_narrows_for_a_far_reaching_operator(S):
    """Hubbard(12,6)'s span (232,848 rows) at n_b = 512: the full-width x
    window is far larger than L2, so the rule takes the measured slab of
    256 bytes a row, c = 32 in fp64 and 64 in fp32; a block narrower than
    that is swept in one slab."""
    span, nb = 232_848, 512
    assert 2 * span * nb * S > plan.L2_BYTES
    c = plan.slab_width(nb, S, span)
    assert c < nb and c * S == plan.SLAB_ROW_BYTES
    assert plan.slab_width(c // 2, S, span) == c // 2
    assert plan.slab_width(1, S, span) == 1
    # the schedule's bytes: x, w2, y once, the operator once per slab
    R, op = 853_776, 25.0
    assert plan.model_bytes(R, nb, S, c, op) == (
        3 * R * nb * S + (nb // c) * R * op)


@pytest.mark.parametrize("nb", [1, 3, 64, 512])
def test_slab_rule_keeps_full_width_for_a_small_span(nb):
    """When the whole window fits at full width, slabs only re-read the
    operator: the rule keeps c = n_b (today's one-pass schedule)."""
    ell, dia = _operator("spin10")
    assert 2 * ell.span * nb * 8 <= plan.L2_BYTES
    assert plan.slab_width(nb, 8, ell.span) == nb
    assert plan.slab_width(nb, 8, dia.span) == nb


def test_ell_keeps_full_width_unless_forced():
    """The ELL product reads its padded rows once per slab, 276 bytes a
    row at Hubbard(12,6) fp64, so its launches keep c = n_b (SpinChainXXZ
    (22,11), span 184,756, included); ``slab=`` still forces a width."""
    from repro_torch.kernels.ell_gather import slab_for

    ell = build_dist_ell(SpinChainXXZ(n_sites=22, n_up=11), 1)
    assert ell.span == 184_756
    for nb in (1, 64, 512):
        assert slab_for(nb) == nb
    assert slab_for(512, 32) == 32
    with pytest.raises(ValueError, match="slab width"):
        slab_for(8, 9)


def test_forced_slab_is_checked():
    assert plan.check_slab(None, 8) is None
    assert plan.check_slab(8, 8) == 8
    for bad in (0, 9):
        with pytest.raises(ValueError, match="slab width"):
            plan.check_slab(bad, 8)


# ----------------------------------- plain versions of the schedule --

SLAB_CASES = [  # R, Rx, nb, c
    (100, 130, 100, 8),   # ragged n_b: 12 slabs of 8 and one of 4
    (100, 100, 100, 100),
    (257, 300, 64, 4),
    (64, 64, 3, 1),
    (64, 80, 1, 1),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R,Rx,nb,c", SLAB_CASES)
def test_compact_slab_contraction_equals_cheb_dia_ref(R, Rx, nb, c, dtype):
    """The fused DIA step over the compact form, one slab at a time and
    only the stored entries, is bit-equal to ``ref.cheb_dia_ref`` (every
    diagonal over the whole block), halo region (Rx > R) included."""
    rng = np.random.default_rng(R * 3 + nb + c)
    offsets = (-41, -13, -1, 0, 1, 7, 29)
    dvals = _t(_random_dia(rng, R, Rx, offsets, dtype))
    x, = (_t(rng.standard_normal((Rx, nb)).astype(dtype)),)
    w1, w2 = (_t(rng.standard_normal((R, nb)).astype(dtype)) for _ in range(2))
    want = ref.cheb_dia_ref(offsets, dvals, x, w1, w2, 0.9, -0.3)
    got = ref.cheb_dia_compact_ref(offsets, plan.compact_dia(dvals), x, w1, w2,
                                   0.9, -0.3, c)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("R,Rx,nb,c", SLAB_CASES)
def test_ell_slab_contraction_equals_ell_spmv_ref(R, Rx, nb, c, dtype):
    """The ELL contraction one slab at a time is bit-equal to
    ``ref.ell_spmv_ref`` and, with y0 threaded, to ``ell_spmv_acc_ref``."""
    rng = np.random.default_rng(R * 5 + nb + c)
    W = 9
    cols = _t(rng.integers(0, Rx, size=(R, W)).astype(np.int32))
    vals = rng.standard_normal((R, W)).astype(dtype)
    vals[rng.random((R, W)) < 0.3] = 0.0
    vals = _t(vals)
    x = _t(rng.standard_normal((Rx, nb)).astype(dtype))
    y0 = _t(rng.standard_normal((R, nb)).astype(dtype))
    assert torch.equal(ref.ell_spmv_slab_ref(cols, vals, x, None, c),
                       ref.ell_spmv_ref(cols, vals, x))
    assert torch.equal(ref.ell_spmv_slab_ref(cols, vals, x, y0, c),
                       ref.ell_spmv_acc_ref(y0, cols, vals, x))


@pytest.mark.parametrize("key", list(MATS))
@pytest.mark.parametrize("c", [1, 4, 8])
def test_compact_slab_step_equals_reference_ell_step(key, c):
    """On a real operator, the compact slab step equals the JAX package's
    ELL contraction plus the reference epilogue bit for bit in fp64 (the
    port's ELL plain version equals the reference's, tests/
    test_torch_kernels.py), ragged n_b = 12 included."""
    ell, dia = _operator(key)
    jm = MATS[key][0](**MATS[key][2])
    jell = jbuild(jm, 1)
    rng = np.random.default_rng(c)
    nb = 12
    x = rng.standard_normal((ell.R, nb))
    w2 = rng.standard_normal((ell.R, nb))
    jy = np.asarray(jref.ell_spmv_ref(jnp.asarray(np.asarray(jell.cols)[0]),
                                      jnp.asarray(np.asarray(jell.vals)[0]),
                                      jnp.asarray(x)))
    want = ref.cheb_epilogue(_t(jy), _t(x), _t(w2), 0.4, -0.1)
    got = ref.cheb_dia_compact_ref(dia.offsets, dia.compact, _t(x), _t(x),
                                   _t(w2), 0.4, -0.1, c)
    assert torch.equal(got, want)
    jdia = jops.plan_dia(np.asarray(jell.cols), np.asarray(jell.vals), jell.R)
    assert jdia.offsets == dia.offsets
