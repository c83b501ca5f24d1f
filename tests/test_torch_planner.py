"""The port's planner (``repro_torch/core/planner.py``) against the JAX
package's (``repro/core/planner.py``) on the CPU.

* ``comm_plan`` — ``n_vc``, ``L``, the per-pair volumes and the rounds
  and round sums H of both schedules — equals the reference's on
  SpinChainXXZ(12,6), Hubbard(6,3), RoadNet(4000) and HubNet(4000) at
  2, 4 and 8 row shards, on equal rows and on the reference's commvol map
  (planned at P = 8, carried across as plain arrays), and the same L and
  H are what the port's built operator realizes.
* ``plan_layout`` under the reference's ``tpu-v5e`` and ``meggie``
  models (carried across as values) ranks the same candidates in the
  same order with the same times at P = 8, kernel axis on.
* ``plan_on_grid`` takes the three splits ``P × 1``, ``n_row × n_col``
  and ``1 × P``, as the reference's ``plan_for_mesh`` does.
* The s-step axis ranks (its parity is ``tests/test_torch_sstep.py``'s).
"""
import numpy as np
import pytest
import torch

from repro.core import perf_model as ref_pm
from repro.core import planner as ref_planner
from repro.core.partition import plan_rowmap as ref_plan_rowmap
from repro.matrices import get_family as ref_family
from repro_torch import convert
from repro_torch.core import build_dist_ell
from repro_torch.core import planner
from repro_torch.matrices import get_family

MATS = {"spin": ("SpinChainXXZ", dict(n_sites=12, n_up=6)),
        "hubbard": ("Hubbard", dict(n_sites=6, n_fermions=3)),
        "roadnet": ("RoadNet", dict(n=4000, w=2, m=256, k=4)),
        "hubnet": ("HubNet", dict(n=4000, w=2, h=4, m=192, k=4))}
ROWS = [2, 4, 8]
SCHEDULES = ("cyclic", "matching")
MACHINES = {"tpu-v5e": ref_pm.TPU_V5E, "meggie": ref_pm.MEGGIE}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the operators here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_cache: dict = {}


def _mats(name):
    """(reference family, port family) of the same parameters."""
    if name not in _cache:
        fam, params = MATS[name]
        _cache[name] = (ref_family(fam, **params), get_family(fam, **params))
    return _cache[name]


def _commvol(name):
    """The reference's commvol map at P = 8 and its port copy."""
    key = name + "-commvol"
    if key not in _cache:
        ref_m, _ = _mats(name)
        rm = ref_plan_rowmap(ref_m, 8, balance="commvol")
        _cache[key] = (rm, convert.rowmap_from_arrays(
            rm.D, rm.P, rm.perm, rm.boundaries, rm.R, balance=rm.balance,
            reorder=rm.reorder, sstep=rm.sstep))
    return _cache[key]


def _assert_same_comm_plan(mine, ref):
    want = convert.comm_plan_from_fields(ref)
    for f in ("n_row", "D", "L", "exact", "d_pad"):
        assert getattr(mine, f) == getattr(want, f), f
    for f in ("n_vc", "pair_counts"):
        a, b = getattr(mine, f), getattr(want, f)
        assert (a is None) == (b is None) and (a is None
                                               or np.array_equal(a, b)), f
    for f in ("chi1", "chi2", "chi3"):
        assert getattr(mine.chi, f) == getattr(ref.chi, f), f
    assert np.array_equal(mine.chi.n_vm, ref.chi.n_vm)
    for sch in SCHEDULES:
        if ref.pair_counts is not None:
            assert mine.permute_schedule(sch) == ref.permute_schedule(sch)
            assert mine.rounds_per_exchange("compressed", sch) == \
                ref.rounds_per_exchange("compressed", sch)
        for comm in ("a2a", "compressed"):
            assert mine.moved_entries_per_device(comm, sch) == \
                ref.moved_entries_per_device(comm, sch)
            assert mine.comm_bytes_per_device(comm, 64, 8, sch) == \
                ref.comm_bytes_per_device(comm, 64, 8, sch)


@pytest.mark.parametrize("n_row", ROWS)
@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("part", ["rows", "commvol"])
def test_comm_plan_equals_the_reference_and_the_built_operator(part, name,
                                                               n_row):
    ref_m, m = _mats(name)
    if part == "rows":
        ref_cp = ref_planner.comm_plan(ref_m, n_row)
        cp = planner.comm_plan(m, n_row)
        rowmap = None
    else:
        ref_rm, rowmap = _commvol(name)
        ref_cp = ref_planner.comm_plan(ref_m, n_row, rowmap=ref_rm)
        cp = planner.comm_plan(m, n_row, rowmap=rowmap)
    assert cp.exact
    _assert_same_comm_plan(cp, ref_cp)
    ell = build_dist_ell(m, n_row, rowmap=rowmap, device="cpu")
    assert ell.L == cp.L
    assert np.array_equal(ell.pair_counts, cp.pair_counts)
    for sch in SCHEDULES:
        assert ell.neighbor_plan(schedule=sch).H == \
            cp.moved_entries_per_device("compressed", sch)


def test_estimated_comm_plan_equals_the_reference():
    """Without the exact pass (``exact=False``, or a given ``n_vc``), L is
    the χ-based estimate, as in the reference."""
    ref_m, m = _mats("roadnet")
    for n_row in ROWS:
        _assert_same_comm_plan(planner.comm_plan(m, n_row, exact=False),
                               ref_planner.comm_plan(ref_m, n_row,
                                                     exact=False))
        n_vc = np.arange(n_row) * 7 + 3
        _assert_same_comm_plan(planner.comm_plan(m, n_row, n_vc=n_vc),
                               ref_planner.comm_plan(ref_m, n_row,
                                                     n_vc=n_vc))


def _assert_same_plan(mine, ref):
    want = convert.plan_from_fields(ref)
    assert (mine.matrix, mine.D, mine.n_devices, mine.n_search, mine.degree,
            mine.machine) == (want.matrix, want.D, want.n_devices,
                              want.n_search, want.degree, want.machine)
    assert [c.describe() for c in mine.candidates] == \
        [c.describe() for c in want.candidates]
    for a, b in zip(mine.candidates, want.candidates):
        for f in ("t_iter", "t_redist", "t_pass", "chi1", "chi2", "chi_eng"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-300), (f, x, y)
        assert a.comm_bytes_per_device == b.comm_bytes_per_device
        assert (a.rowmap is None) == (b.rowmap is None)
        if a.rowmap is not None:
            assert np.array_equal(a.rowmap.boundaries, b.rowmap.boundaries)
            assert np.array_equal(a.rowmap.perm, b.rowmap.perm)
    assert mine.best.describe() == want.best.describe()
    assert mine.report().splitlines()[1:] == ref.report().splitlines()[1:]


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("name", sorted(MATS))
def test_plan_layout_ranks_as_the_reference(name, machine):
    ref_m, m = _mats(name)
    D = m.D
    kw = dict(n_search=16, d_pad=-(-D // 8) * 8, kernel=(False, True))
    ref_plan = ref_planner.plan_layout(ref_m, 8, machine=MACHINES[machine],
                                       **kw)
    plan = planner.plan_layout(
        m, 8, machine=convert.machine_from_fields(MACHINES[machine]), **kw)
    _assert_same_plan(plan, ref_plan)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_plan_on_grid_takes_the_three_splits(grid):
    n_row, n_col = grid
    ref_m, m = _mats("roadnet")
    splits = []
    for s in ((8, 1), grid, (1, 8)):
        if s not in splits:
            splits.append(s)
    machine = ref_pm.TPU_V5E
    ref_plan = ref_planner.plan_layout(ref_m, 8, n_search=16, splits=splits,
                                       machine=machine)
    plan = planner.plan_on_grid(
        m, n_row, n_col, n_search=16,
        machine=convert.machine_from_fields(machine))
    assert {(c.n_row, c.n_col) for c in plan.candidates} == set(splits)
    _assert_same_plan(plan, ref_plan)


def test_sstep_axis_is_not_ported_yet():
    """The s-step axis is ported (``tests/test_torch_sstep.py`` holds it
    to the reference): ``plan_layout`` ranks the depth-2 candidates beside
    s = 1, ``comm_plan(sstep=2)`` is a depth-2 plan, and a depth below 1
    raises as in the reference."""
    _, m = _mats("spin")
    plan = planner.plan_layout(m, 4, n_search=16, sstep=(1, 2))
    assert {c.sstep for c in plan.candidates} == {1, 2}
    assert any(c.name.endswith("+s2") for c in plan.candidates)
    assert planner.comm_plan(m, 4, sstep=2).sstep == 2
    with pytest.raises(ValueError, match="sstep values must be >= 1"):
        planner.plan_layout(m, 4, n_search=16, sstep=(0,))
    with pytest.raises(ValueError, match="sstep must be >= 1"):
        planner.comm_plan(m, 4, sstep=0)


def test_plan_layout_refuses_what_the_reference_refuses():
    _, m = _mats("spin")
    with pytest.raises(ValueError, match="divides n_search"):
        planner.plan_layout(m, 4, n_search=3, splits=[])
    with pytest.raises(ValueError, match="unknown schedule"):
        planner.plan_layout(m, 4, n_search=16, schedule=("ring",))
    with pytest.raises(ValueError, match="unknown plan_mode"):
        planner.plan_layout(m, 4, n_search=16, plan_mode="guess")
