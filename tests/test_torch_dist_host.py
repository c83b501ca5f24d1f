"""The horizontal layer's host side, port against the JAX package on the
CPU: the P-shard operator, its split-phase form, the neighbour schedules
and plans, the χ metrics and the port's copies of the host functions.

The reference's host side runs in this process (it needs no devices).
Cases: RoadNet(4000) and HubNet(4000) (their configs' SMOKE matrices),
SpinChainXXZ(10,5) (D = 252: padded at P = 8), Hubbard(6,3, U=4,
ranpot=1) (D = 400, also at P = 3: padded) and Exciton(L=2) in complex128
(D = 375: padded at every P). Also here: the entry points' default
device, and the port's isolation from JAX.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core.metrics as jmetrics
import repro.matrices.sparse as jsparse
from repro.core.planner import comm_plan
from repro.core.spmv import build_dist_ell as jbuild
from repro.core.spmv import neighbor_schedule as jschedule
from repro.matrices import get_family as jget_family

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_dist_ell, chi_from_nvc, chi_metrics
from repro_torch.core import neighbor_schedule
from repro_torch.matrices import get_family
from repro_torch.matrices.sparse import uniform_partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small, so more threads
    only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(name):
    m = dict(get_smoke_config(name)["matrix"])
    return m.pop("family"), m


CASES = {
    "roadnet": _smoke("roadnet48k"),
    "hubnet": _smoke("hubnet48k"),
    "spin10": ("SpinChainXXZ", dict(n_sites=10, n_up=5)),
    "hub6": ("Hubbard", dict(n_sites=6, n_fermions=3, U=4.0, ranpot=1.0)),
    "exciton2": ("Exciton", dict(L=2)),
}
GRID = [(k, P) for k in CASES for P in (2, 4, 8)] + [("hub6", 3)]


def _pair(key):
    fam, params = CASES[key]
    return jget_family(fam, **params), get_family(fam, **params)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _both(key, P):
    jm, tm = _pair(key)
    dt = np.complex128 if jm.is_complex else np.float64
    jell = jbuild(jm, P, dtype=dt, split_halo=True)
    tell = build_dist_ell(tm, P, split_halo=True, device="cpu")
    return jell, tell


@pytest.mark.parametrize("key,P", GRID)
def test_operator_equals_reference(key, P):
    """cols, vals, send_idx, pair_counts, n_vc, L and R of the P-shard
    operator, array for array; the pad rows are empty."""
    jell, tell = _both(key, P)
    assert (tell.P, tell.R, tell.L, tell.D) == (jell.P, jell.R, jell.L, jell.D)
    for name in ("cols", "vals", "send_idx"):
        assert _eq(getattr(tell, name), getattr(jell, name)), name
    assert _eq(tell.pair_counts, jell.pair_counts)
    assert _eq(tell.n_vc, jell.n_vc)
    assert tell.comm_bytes_per_spmv == jell.comm_bytes_per_spmv
    assert tell.halo_nnz_fraction == jell.halo_nnz_fraction
    pad = np.arange(P * tell.R) >= tell.D
    assert not (tell.vals.numpy().reshape(P * tell.R, -1)[pad] != 0).any()


@pytest.mark.parametrize("key,P", GRID)
def test_split_and_neighbor_plans_equal_reference(key, P):
    """``split()``, both neighbour schedules and their plans (``send_nbr``,
    ``cols_nbr``, ``cols_halo_nbr``, the halo rounds) equal the
    reference's; the port's schedule copy gives the same rounds."""
    jell, tell = _both(key, P)
    for a, b in zip(tell.split(), jell.split()):
        assert _eq(a, b)
    for sched in ("cyclic", "matching"):
        jn = jell.neighbor_plan(split_halo=True, schedule=sched)
        tn = tell.neighbor_plan(split_halo=True, schedule=sched)
        assert tn.perms == jn.perms and tn.round_L == jn.round_L
        assert tn.H == jn.H
        assert (tn.perms, tn.round_L) == neighbor_schedule(jell.pair_counts,
                                                           sched)
        for name in ("send_nbr", "cols_nbr", "cols_halo_nbr"):
            assert _eq(getattr(tn, name), getattr(jn, name)), name
        assert len(tn.halo_rounds) == len(jn.halo_rounds)
        for (tc, tv), (jc, jv) in zip(tn.halo_rounds, jn.halo_rounds):
            assert _eq(tc, jc) and _eq(tv, jv)


@pytest.mark.parametrize("key,P", [("roadnet", 8), ("exciton2", 4)])
def test_convert_carries_a_p_shard_operator(key, P):
    """``convert.dist_ell_from_arrays`` carries the reference's operator,
    its split and its neighbour plans across, equal to the port's own."""
    jell, tell = _both(key, P)
    nbr = {s: jell.neighbor_plan(split_halo=True, schedule=s)
           for s in ("cyclic", "matching")}
    cell = convert.dist_ell_from_arrays(
        np.asarray(jell.cols), np.asarray(jell.vals), D=jell.D,
        send_idx=np.asarray(jell.send_idx), pair_counts=jell.pair_counts,
        n_vc=jell.n_vc, split=[np.asarray(a) for a in jell.split()], nbr=nbr,
        device="cpu")
    assert (cell.P, cell.R, cell.L, cell.D) == (tell.P, tell.R, tell.L, tell.D)
    for name in ("cols", "vals", "send_idx", "cols_loc", "vals_loc",
                 "cols_halo", "vals_halo"):
        assert torch.equal(getattr(cell, name), getattr(tell, name)), name
    assert cell.span == tell.span
    for s in nbr:
        cn, tn = cell.nbr[s], tell.neighbor_plan(split_halo=True, schedule=s)
        assert (cn.perms, cn.round_L) == (tn.perms, tn.round_L)
        assert torch.equal(cn.send_nbr, tn.send_nbr)
        assert torch.equal(cn.cols_halo_nbr, tn.cols_halo_nbr)
        for (a, b), (c, d) in zip(cn.halo_rounds, tn.halo_rounds):
            assert torch.equal(a, c) and torch.equal(b, d)


@pytest.mark.parametrize("key,P", GRID)
def test_chi_metrics_equal_reference(key, P):
    """The port's χ metrics (uniform partition, streamed ``n_vc``) and
    those of the operator's own equal-rows partition equal the
    reference's."""
    jm, tm = _pair(key)
    want = jmetrics.chi_metrics(jm, P)
    got = chi_metrics(tm, P)
    assert (got.chi1, got.chi2, got.chi3, got.imbalance) == \
        (want.chi1, want.chi2, want.chi3, want.imbalance)
    assert _eq(got.n_vc, want.n_vc) and _eq(got.n_vm, want.n_vm)
    cp = comm_plan(jm, P)
    tell = build_dist_ell(tm, P, device="cpu")
    n_vm = tell.rowmap.block_sizes()
    mine = chi_from_nvc(tell.n_vc, n_vm, tm.D)
    assert (mine.chi1, mine.chi2, mine.chi3) == \
        (cp.chi.chi1, cp.chi.chi2, cp.chi.chi3)


@pytest.mark.parametrize("D,P", [(10, 3), (252, 8), (853_776, 4), (7, 7),
                                 (680_943, 4)])
def test_uniform_partition_equals_original(D, P):
    assert _eq(uniform_partition(D, P), jsparse.uniform_partition(D, P))


@settings(max_examples=60, deadline=2000,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(min_value=2, max_value=9).flatmap(
    lambda P: st.lists(st.integers(min_value=0, max_value=6),
                       min_size=P * P, max_size=P * P).map(
        lambda v: np.array(v, dtype=np.int64).reshape(P, P))),
       st.sampled_from(["cyclic", "matching"]))
def test_neighbor_schedule_copy_equals_original(pc, schedule):
    """On random pair-volume matrices (zero pairs included) the port's
    copy of ``neighbor_schedule`` returns the original's rounds."""
    np.fill_diagonal(pc, 0)
    assert neighbor_schedule(pc, schedule) == jschedule(pc, schedule)


# ------------------------------------------------------ default device --

def test_entry_points_default_to_the_card(monkeypatch):
    """``build_dist_ell`` and the three ``convert`` functions run on the
    card unless given ``device="cpu"``: with no card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _pair("spin10")
    cols = np.zeros((1, 4, 2), dtype=np.int32)
    vals = np.zeros((1, 4, 2))
    calls = [
        lambda: build_dist_ell(tm, 2),
        lambda: convert.dist_ell_from_arrays(cols, vals),
        lambda: convert.dia_plan_from_arrays((0,), np.ones((1, 4))),
        lambda: convert.fd_state_from_arrays(np.ones((4, 2)), (-1.0, 1.0)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_dist_ell(tm, 2, device="cpu").vals.device.type == "cpu"


# ----------------------------------------------------------- isolation --

def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of ``repro_torch`` (the LM side's ``models``, its
    configs, ``optim``, ``data`` and ``launch.train`` included) and
    ``chip_smoke.py``, imported in a fresh interpreter, bring in neither
    ``jax`` nor ``repro``."""
    script = r"""
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imported")
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.",
                                                                 "repro.")))
print(len(names), bad)
assert not bad, bad
lm = {"repro_torch.models." + m for m in ("config", "layers", "attention",
                                          "moe", "ssm", "transformer",
                                          "decode", "steps")}
lm |= {"repro_torch.configs." + m for m in ("qwen3_0p6b", "arctic_480b",
                                            "rwkv6_1p6b", "hymba_1p5b")}
lm |= {"repro_torch.optim.adamw", "repro_torch.optim.compress",
       "repro_torch.data.pipeline", "repro_torch.launch.train"}
assert lm <= set(names), sorted(lm - set(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", script,
                        os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split()[0])
    assert n >= 70  # every module was reached
