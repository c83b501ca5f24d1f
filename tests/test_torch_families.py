"""The port's copies of the four matrix families added after the first
slice (Exciton, TopIns, RoadNet, HubNet), the windowed generator protocol,
the DIA extraction and the eigen configs, held equal to the JAX package's
originals array for array on the CPU, and the operator built from each.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.matrices.matfree as jmatfree
from repro.core import build_dist_ell as jbuild
from repro.kernels import ops as jops
from repro.matrices import get_family as jget_family

import repro_torch.configs as tconfigs
import repro_torch.matrices.matfree as tmatfree
from repro_torch import convert
from repro_torch.core import build_dist_ell
from repro_torch.kernels import ops
from repro_torch.matrices import available_families, get_family

CASES = [
    ("Exciton", dict(L=2)),
    ("Exciton", dict(L=3)),
    ("Exciton", dict(L=2, t=0.7, V=1.3, so=0.2)),
    ("TopIns", dict(Lx=4)),
    ("TopIns", dict(Lx=5)),
    ("TopIns", dict(Lx=3, Ly=4, Lz=5, t=0.8)),
    ("RoadNet", dict(n=4000, w=2, m=256, k=4)),   # roadnet48k's SMOKE
    ("RoadNet", dict(n=900, w=3, m=100, k=2, c0=300, seed=4)),
    ("HubNet", dict(n=4000, w=2, h=4, m=192, k=4)),  # hubnet48k's SMOKE
    ("HubNet", dict(n=3000, w=1, h=3, m=64, k=3, seed=2)),
]
IDS = [f"{f}-{'-'.join(f'{k}{v}' for k, v in p.items())}" for f, p in CASES]


def _pair(fam, params):
    return jget_family(fam, **params), get_family(fam, **params)


def test_registry_holds_all_six_families():
    from repro.matrices import available_families as javailable

    assert available_families() == javailable()


@pytest.mark.parametrize("fam,params", CASES, ids=IDS)
def test_generator_equals_reference(fam, params):
    """``row_cols``, ``row_entries``, ``build_csr``, ``describe``,
    ``reach``, ``S_d`` and ``spectral_bounds_hint`` equal the original's."""
    jm, tm = _pair(fam, params)
    assert (tm.D, tm.describe(), tm.reach, tm.S_d, tm.is_complex) == (
        jm.D, jm.describe(), jm.reach, jm.S_d, jm.is_complex)
    assert tm.spectral_bounds_hint() == jm.spectral_bounds_hint()
    rows = np.random.default_rng(1).permutation(jm.D)[:300]
    for a, b in zip(tm.row_entries(rows), jm.row_entries(rows)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tm.row_cols(rows), jm.row_cols(rows)):
        assert np.array_equal(a, b)
    jc, tc = jm.build_csr(), tm.build_csr()
    assert np.array_equal(tc.indptr, jc.indptr)
    assert np.array_equal(tc.indices, jc.indices)
    assert tc.data.dtype == jc.data.dtype and np.array_equal(tc.data, jc.data)
    # the complex CSR's host products (the re-check of returned pairs)
    x = np.random.default_rng(2).standard_normal((tm.D, 3)) + 0j
    assert np.array_equal(tc.matvec(x), jc.matvec(x))
    np.testing.assert_allclose(tc.to_scipy() @ x, jc.matvec(x), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("window", [1, 7, 64, 1000, 262_144])
@pytest.mark.parametrize("fam,params", CASES[::2], ids=IDS[::2])
def test_windowed_protocol_equals_reference(fam, params, window):
    """``collect_row_entries`` and ``iter_row_entries`` give the
    original's arrays in the original's order at every window size, and
    the same multiset as one ``row_entries`` call."""
    jm, tm = _pair(fam, params)
    rows = np.arange(tm.D, dtype=np.int64)
    got = tmatfree.collect_row_entries(tm, rows, window)
    want = jmatfree.collect_row_entries(jm, rows, window)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    parts = list(tmatfree.iter_row_entries(tm, rows[:2 * window + 3], window))
    assert len(parts) == len(list(jmatfree.iter_row_entries(
        jm, rows[:2 * window + 3], window)))
    whole = tm.row_entries(rows)
    o1, o2 = np.lexsort(got[1::-1]), np.lexsort(whole[1::-1])
    for a, b in zip(got, whole):
        assert np.array_equal(a[o1], b[o2])


@pytest.mark.parametrize("fam,params", CASES, ids=IDS)
def test_dia_from_family_equals_reference(fam, params):
    """The lattice families' DIA form equals the original's (complex64
    values, padded rows); the graph families have hundreds of diagonals
    and are refused alike."""
    jm, tm = _pair(fam, params)
    try:
        want = jmatfree.dia_from_family(jm, pad_to=16)
    except ValueError:
        with pytest.raises(ValueError, match="not DIA-structured"):
            tmatfree.dia_from_family(tm, pad_to=16)
        assert fam in ("RoadNet", "HubNet")
        return
    got = tmatfree.dia_from_family(tm, pad_to=16)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fam,params", CASES, ids=IDS)
def test_operator_build_equals_reference(fam, params, dtype):
    """The one-shard ELL block equals the reference's built in the
    working dtype its ``FilterDiag`` uses (a complex family's real
    ``dtype`` promoted to complex of the same precision), and carries
    across ``convert``; the DIA plan exists exactly for the lattice
    families (≤ 64 diagonals) and equals the reference's per-plane."""
    jm, tm = _pair(fam, params)
    wd = np.dtype(dtype)
    if jm.is_complex:
        wd = np.dtype(np.complex128 if dtype == "float64" else np.complex64)
    jell = jbuild(jm, 1, dtype=wd)
    tell = build_dist_ell(tm, 1, dtype=dtype)
    assert tell.vals.numpy().dtype == wd
    assert np.array_equal(tell.cols.numpy(), np.asarray(jell.cols)[0])
    assert np.array_equal(tell.vals.numpy(), np.asarray(jell.vals)[0])
    cell = convert.dist_ell_from_arrays(np.asarray(jell.cols),
                                        np.asarray(jell.vals), D=jell.D)
    assert torch.equal(cell.cols, tell.cols) and torch.equal(cell.vals, tell.vals)
    assert cell.span == tell.span
    dia = ops.plan_dia(tell.cols, tell.vals, tell.R)
    rows = np.arange(tell.R)[:, None]
    stored = tell.vals.numpy() != 0
    n_diag = len(np.unique((tell.cols.numpy() - rows)[stored]))
    assert (dia is not None) == (n_diag <= ops.DIA_MAX_DIAGS)
    if fam in ("Exciton", "TopIns"):  # 11 and 26 diagonals at every size
        assert n_diag == {"Exciton": 11, "TopIns": 26}[fam]
    elif params.get("n") == 4000:  # the SMOKE graphs take the ELL route
        assert dia is None
    if dia is None:
        return
    # the reference plans real operators only: compare plane by plane
    jc, jv = np.asarray(jell.cols), np.asarray(jell.vals)
    planes = ((np.real, dia.dvals.real), (np.imag, dia.dvals.imag)) if \
        dia.dvals.is_complex() else ((np.real, dia.dvals),)
    for part, plane in planes:
        want = jops.plan_dia(jc, part(jv), tell.R)
        full = torch.zeros_like(plane)
        idx = [dia.offsets.index(o) for o in want.offsets]
        full[idx] = torch.tensor(np.asarray(want.dvals)[0])
        assert torch.equal(plane, full)


@pytest.mark.parametrize("name", jconfigs.EIGEN_CONFIGS)
def test_eigen_configs_equal_reference(name):
    """The port's eigen configs (``get_config`` / ``get_smoke_config``)
    equal the reference's: the matrix, every FDConfig field and the
    layouts; the LM configs are not ported."""
    assert tconfigs.EIGEN_CONFIGS == jconfigs.EIGEN_CONFIGS
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke_config, jconfigs.get_smoke_config)):
        t, j = get_t(name), get_j(name)
        assert set(t) == set(j) and t["matrix"] == j["matrix"]
        assert dataclasses.asdict(t["fd"]) == dataclasses.asdict(j["fd"])
        assert t.get("layouts") == j.get("layouts")
        m = dict(t["matrix"])
        fam = get_family(m.pop("family"), **m) if get_t is tconfigs.get_smoke_config else None
        assert fam is None or fam.describe() == jget_family(
            j["matrix"]["family"], **{k: v for k, v in j["matrix"].items()
                                      if k != "family"}).describe()
    with pytest.raises(KeyError):
        tconfigs.get_config("qwen3-0.6b")
