"""The port's sampled planner (``repro_torch/core/sketch.py`` and
``plan_rowmap(plan_mode="sampled")``) against the JAX package's on the
CPU.

For the same ``(seed, fraction)`` both packages draw the same rows from
one ``np.random.default_rng(seed)``, block by block, so the estimates
must be equal: ``estimate_comm``'s per-pair counts, ``n_vc``, χ and
confidence band (on equal rows and on a planned map),
``coarsened_commvol_boundaries`` and the sampled row map; and at
``fraction >= 1`` the estimate is the exact pattern pass.
"""
import numpy as np
import pytest

from repro.core import perf_model as ref_pm
from repro.core import planner as ref_planner
from repro.core import sketch as ref_sketch
from repro.core.partition import plan_rowmap as ref_plan_rowmap
from repro.matrices import get_family as ref_family
from repro_torch import convert
from repro_torch.core import planner, sketch
from repro_torch.core.partition import plan_rowmap
from repro_torch.matrices import get_family

MATS = {"spin": ("SpinChainXXZ", dict(n_sites=12, n_up=6)),
        "roadnet": ("RoadNet", dict(n=4000, w=2, m=256, k=4)),
        "hubnet": ("HubNet", dict(n=4000, w=2, h=4, m=192, k=4))}

_cache: dict = {}


def _mats(name):
    if name not in _cache:
        fam, params = MATS[name]
        _cache[name] = (ref_family(fam, **params), get_family(fam, **params))
    return _cache[name]


def _assert_same_estimate(mine, ref):
    want = convert.sampled_estimate_from_fields(ref)
    for f in ("n_row", "D", "fraction", "seed", "sampled_rows", "d_pad", "L"):
        assert getattr(mine, f) == getattr(want, f), f
    for f in ("pair_counts", "n_vc", "n_vm"):
        assert np.array_equal(getattr(mine, f), getattr(want, f)), f
    for f in ("chi1", "chi2", "chi3"):
        assert getattr(mine.chi, f) == getattr(want.chi, f), f
    assert mine.band == want.band
    cp, ref_cp = mine.comm_plan(), ref.comm_plan()
    assert not cp.exact and cp.L == ref_cp.L
    assert np.array_equal(cp.pair_counts, ref_cp.pair_counts)


@pytest.mark.parametrize("fraction,seed", [(0.3, 0), (0.5, 3), (None, 1)])
@pytest.mark.parametrize("n_row", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(MATS))
def test_estimate_comm_equals_the_reference(name, n_row, fraction, seed):
    ref_m, m = _mats(name)
    _assert_same_estimate(
        sketch.estimate_comm(m, n_row, fraction=fraction, seed=seed),
        ref_sketch.estimate_comm(ref_m, n_row, fraction=fraction, seed=seed))


@pytest.mark.parametrize("name", ["roadnet", "hubnet"])
def test_estimate_comm_on_a_planned_map_equals_the_reference(name):
    """On the reference's sampled commvol map at P = 8, carried across,
    at every level the map serves."""
    ref_m, m = _mats(name)
    ref_rm = ref_plan_rowmap(ref_m, 8, balance="commvol",
                             plan_mode="sampled", sample_fraction=0.4)
    rm = convert.rowmap_from_arrays(ref_rm.D, ref_rm.P, ref_rm.perm,
                                    ref_rm.boundaries, ref_rm.R,
                                    balance=ref_rm.balance,
                                    reorder=ref_rm.reorder)
    for n_row in (2, 4, 8):
        _assert_same_estimate(
            sketch.estimate_comm(m, n_row, rowmap=rm, fraction=0.35, seed=5),
            ref_sketch.estimate_comm(ref_m, n_row, rowmap=ref_rm,
                                     fraction=0.35, seed=5))


@pytest.mark.parametrize("name", sorted(MATS))
def test_full_fraction_is_the_exact_pass(name):
    """At fraction 1 the sample is every row: the estimate equals the
    port's exact ``comm_plan``."""
    _, m = _mats(name)
    for n_row in (2, 4, 8):
        est = sketch.estimate_comm(m, n_row, fraction=1.0, seed=9)
        cp = planner.comm_plan(m, n_row)
        assert np.array_equal(est.pair_counts, cp.pair_counts)
        assert np.array_equal(est.n_vc, cp.n_vc) and est.L == cp.L
        for f in ("chi1", "chi2", "chi3"):
            assert getattr(est.chi, f) == getattr(cp.chi, f)
        assert est.band.valid() and est.band.contains(cp.chi)


@pytest.mark.parametrize("P,fraction,seed", [(4, 0.25, 0), (8, None, 2),
                                             (8, 0.5, 7)])
@pytest.mark.parametrize("name", sorted(MATS))
def test_coarsened_commvol_boundaries_equal_the_reference(name, P, fraction,
                                                          seed):
    ref_m, m = _mats(name)
    mine = sketch.coarsened_commvol_boundaries(m, P, fraction=fraction,
                                               seed=seed)
    ref = ref_sketch.coarsened_commvol_boundaries(ref_m, P,
                                                  fraction=fraction,
                                                  seed=seed)
    assert np.array_equal(mine, ref)


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("name", ["roadnet", "hubnet"])
def test_sampled_rowmap_equals_the_reference(name, P):
    ref_m, m = _mats(name)
    kw = dict(balance="commvol", plan_mode="sampled", sample_seed=4,
              sample_fraction=0.3)
    mine, ref = plan_rowmap(m, P, **kw), ref_plan_rowmap(ref_m, P, **kw)
    assert (mine.D, mine.P, mine.R, mine.balance, mine.reorder) == \
        (ref.D, ref.P, ref.R, ref.balance, ref.reorder)
    assert np.array_equal(mine.boundaries, ref.boundaries)
    assert np.array_equal(mine.perm, ref.perm)
    assert mine.is_bijection()
    with pytest.raises(ValueError, match="cannot plan reorder"):
        plan_rowmap(m, P, balance="commvol", reorder="rcm",
                    plan_mode="sampled")


def test_sampled_plan_layout_ranks_as_the_reference():
    """``plan_layout(plan_mode="sampled")`` on HubNet(4000) at P = 8 —
    every comm plan and the commvol map from the sample (at this
    fraction the map keeps the equal cuts) — ranks as the reference's
    under its ``tpu-v5e`` model."""
    ref_m, m = _mats("hubnet")
    kw = dict(n_search=16, d_pad=4000, plan_mode="sampled", sample_seed=1,
              sample_fraction=0.3)
    ref_plan = ref_planner.plan_layout(ref_m, 8, machine=ref_pm.TPU_V5E, **kw)
    plan = planner.plan_layout(
        m, 8, machine=convert.machine_from_fields(ref_pm.TPU_V5E), **kw)
    assert [c.describe() for c in plan.candidates] == \
        [c.describe() for c in ref_plan.candidates]
    assert [c.t_pass for c in plan.candidates] == \
        [c.t_pass for c in ref_plan.candidates]


def test_default_fraction_equals_the_reference():
    for D, blocks in ((4000, 1), (853_776, 4), (10_000_000, 64),
                      (10_000_000, 4096)):
        assert sketch.default_fraction(D, blocks) == \
            ref_sketch.default_fraction(D, blocks)
