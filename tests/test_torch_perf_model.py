"""The port's analytic performance model (``repro_torch/core/perf_model.py``)
against the JAX package's (``repro/core/perf_model.py``) on the CPU.

The reference's builtin models (TPU v5e, its high-latency variant and
Meggie) come across as plain values (``convert.machine_from_fields``):
the port holds no constant of theirs. Over a grid of inputs Eq. 12, the
overlap model, the engine χ, the round-sum schedule cost and the speedup
helpers must give the reference's numbers exactly (the same arithmetic);
``MachineModel.fit`` on the same samples the same model, its ``b_c = inf``
warning included; and a model survives ``save_machine``/``load_machine``.
"""
import itertools
import math
import warnings

import numpy as np
import pytest

from repro.core import perf_model as ref_pm
from repro_torch import convert
from repro_torch.core import perf_model as pm

REF_MACHINES = {"tpu-v5e": ref_pm.TPU_V5E, "meggie": ref_pm.MEGGIE,
                "tpu-v5e-highlat": ref_pm.TPU_V5E_HIGHLAT}
#: Eq. 12 inputs: (D, N_p, n_b, chi, n_nzr, S_d, rounds)
GRID = list(itertools.product((853_776, 48_000), (1, 4, 8), (1, 64, 512),
                              (0.0, 0.37, 3.2), (4.5, 13.0), (8, 16),
                              (0.0, 3.0)))


def _pair(name):
    m = REF_MACHINES[name]
    return m, convert.machine_from_fields(m)


def test_no_tpu_or_meggie_constant_in_the_port():
    """The port's registry holds the H100 model only."""
    for const in ("TPU_V5E", "TPU_V5E_HIGHLAT", "MEGGIE"):
        assert not hasattr(pm, const)
    assert set(pm.BUILTIN_MACHINES) == {"h100-1card"}
    m = pm.BUILTIN_MACHINES["h100-1card"]
    assert m is pm.H100_1CARD and m.name == "h100-1card"
    assert all(math.isfinite(v) and v > 0 for v in (m.b_m, m.b_c, m.kappa))
    assert m.alpha >= 0


def test_machine_values_carry_across():
    for name in REF_MACHINES:
        r, p = _pair(name)
        assert (p.name, p.b_m, p.b_c, p.kappa, p.alpha) == \
            (r.name, r.b_m, r.b_c, r.kappa, r.alpha)
        assert p.bc_over_bm == r.bc_over_bm


@pytest.mark.parametrize("name", sorted(REF_MACHINES))
def test_eq12_and_overlap_model_equal_the_reference(name):
    r, p = _pair(name)
    for D, N_p, n_b, chi, n_nzr, S_d, rounds in GRID:
        kw = dict(D=D, N_p=N_p, n_b=n_b, chi=chi, n_nzr=n_nzr, S_d=S_d)
        assert pm.cheb_iter_time(p, **kw, rounds=rounds) == \
            ref_pm.cheb_iter_time(r, **kw, rounds=rounds)
        assert pm.cheb_iter_time(p, **kw, work_factor=1.3) == \
            ref_pm.cheb_iter_time(r, **kw, work_factor=1.3)
        for hf in (None, 0.25):
            assert pm.cheb_iter_time_overlap(
                p, **kw, halo_frac=hf, rounds=rounds) == \
                ref_pm.cheb_iter_time_overlap(r, **kw, halo_frac=hf,
                                              rounds=rounds)
            assert pm.overlap_speedup(p, **kw, halo_frac=hf) == \
                ref_pm.overlap_speedup(r, **kw, halo_frac=hf)
        km, kr = pm.fused_kernel_machine(p), ref_pm.fused_kernel_machine(r)
        assert (km.name, km.kappa) == (kr.name, kr.kappa)
        assert pm.cheb_iter_time(km, **kw) == ref_pm.cheb_iter_time(kr, **kw)


@pytest.mark.parametrize("name", sorted(REF_MACHINES))
def test_engine_chi_and_schedule_cost_equal_the_reference(name):
    r, p = _pair(name)
    for moved, D, N_p in itertools.product((0, 17, 4096, 324_324),
                                           (4000, 853_776), (1, 2, 8)):
        assert pm.engine_chi(moved, D, N_p) == ref_pm.engine_chi(moved, D, N_p)
    for round_L, n_b, S_d in itertools.product(
            ((), (5,), (120, 7, 33), (1000,) * 7), (1, 64), (8, 16)):
        assert pm.schedule_comm_time(p, round_L, n_b=n_b, S_d=S_d) == \
            ref_pm.schedule_comm_time(r, round_L, n_b=n_b, S_d=S_d)


@pytest.mark.parametrize("name", sorted(REF_MACHINES))
def test_speedup_helpers_equal_the_reference(name):
    r, p = _pair(name)
    for chi_P, chi_panel, n_col in itertools.product(
            (0.0, 0.4, 2.5, 11.0), (0.0, 0.1, 1.3), (1, 2, 8)):
        assert pm.panel_speedup(p, chi_P, chi_panel) == \
            ref_pm.panel_speedup(r, chi_P, chi_panel)
        assert pm.redistribution_factor(p, n_col, chi_panel) == \
            ref_pm.redistribution_factor(r, n_col, chi_panel)
        assert pm.parallel_efficiency_bound(p, chi_P) == \
            ref_pm.parallel_efficiency_bound(r, chi_P)
        assert pm.pillar_condition(chi_P) == ref_pm.pillar_condition(chi_P)
        for n_nzr, S_d, n_b in itertools.product((4.5, 13.0), (8, 16),
                                                 (16, 512)):
            kw = dict(chi_P=chi_P, chi_panel=chi_panel, n_nzr=n_nzr,
                      S_d=S_d, n_b_stack=n_b, n_col=n_col)
            assert pm.layout_speedup_full(p, **kw) == \
                ref_pm.layout_speedup_full(r, **kw)
    for s, rr, n in itertools.product((0.5, 1.0, 1.7, 6.0), (0.0, 0.3, 4.0),
                                      (1, 40, 800)):
        assert pm.amortized_speedup(s, rr, n) == \
            ref_pm.amortized_speedup(s, rr, n)
        assert pm.break_even_degree(s, rr) == ref_pm.break_even_degree(s, rr)


def _samples(seed, with_rounds=True, comm_free=False):
    """Synthetic timings from a known model plus noise."""
    rng = np.random.default_rng(seed)
    true = pm.MachineModel("true", b_m=3.0e12, b_c=8.0e11, kappa=6.2,
                           alpha=2.5e-5)
    out = []
    for D, N_p, n_b, chi in itertools.product((853_776, 48_000), (1, 2, 4),
                                              (1, 128, 512), (0.4, 2.1)):
        chi = 0.0 if (comm_free or N_p == 1) else chi
        rounds = (1.0 if N_p > 1 else 0.0) if with_rounds else 0.0
        t = pm.cheb_iter_time(true, D=D, N_p=N_p, n_b=n_b, chi=chi,
                              n_nzr=13.0, S_d=8, rounds=rounds)
        s = dict(t=t * (1 + 0.02 * rng.standard_normal()), D=D, N_p=N_p,
                 n_b=n_b, chi=chi, n_nzr=13.0, S_d=8)
        if with_rounds:
            s["rounds"] = rounds
        out.append(s)
    return out


@pytest.mark.parametrize("case", ["rounds", "no-rounds", "comm-free"])
def test_fit_equals_the_reference(case):
    samples = _samples(3, with_rounds=case == "rounds",
                       comm_free=case == "comm-free")
    p = pm.MachineModel.fit(samples, b_m=3.0e12, name="fit")
    r = ref_pm.MachineModel.fit(samples, b_m=3.0e12, name="fit")
    assert (p.name, p.b_m, p.b_c, p.kappa, p.alpha) == \
        (r.name, r.b_m, r.b_c, r.kappa, r.alpha)
    if case == "comm-free":
        assert p.b_c == float("inf") and p.alpha == 0.0
    else:
        assert math.isfinite(p.b_c) and p.kappa > 0


def test_fit_leaves_b_c_infinite_with_the_references_warning():
    """Timings that fall as χ grows: the comm coefficient fits
    non-positive, b_c stays +inf, and both packages warn."""
    samples = [dict(t=1e-3 / (1 + chi), D=48_000, N_p=4, n_b=64, chi=chi,
                    n_nzr=9.0, S_d=8) for chi in (0.1, 0.5, 1.0, 2.0)]
    with pytest.warns(RuntimeWarning, match="FREE"):
        p = pm.MachineModel.fit(samples, b_m=3.0e12)
    with pytest.warns(RuntimeWarning, match="FREE"):
        r = ref_pm.MachineModel.fit(samples, b_m=3.0e12)
    assert p.b_c == r.b_c == float("inf")
    assert (p.kappa, p.alpha) == (r.kappa, r.alpha)
    with pytest.raises(ValueError, match="at least one sample"):
        pm.MachineModel.fit([], b_m=1.0)


@pytest.mark.parametrize("b_c", [8.0e11, float("inf")])
def test_save_and_load_round_trip(tmp_path, b_c):
    m = pm.MachineModel("fitted-local", b_m=2.9e12, b_c=b_c, kappa=6.5,
                        alpha=3.1e-5)
    path = str(tmp_path / "fit.json")
    pm.save_machine(m, path)
    assert pm.load_machine(path) == m
    assert pm.resolve_machine(path) == m
    # a model the reference saved loads in the port, and back
    ref_path = str(tmp_path / "ref.json")
    ref_pm.save_machine(ref_pm.TPU_V5E, ref_path)
    assert pm.load_machine(ref_path) == convert.machine_from_fields(
        ref_pm.TPU_V5E)


def test_resolve_machine():
    assert pm.resolve_machine("h100-1card") is pm.H100_1CARD
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="neither a builtin"):
            pm.resolve_machine("tpu-v5e")
