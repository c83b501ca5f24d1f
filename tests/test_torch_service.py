"""The port's eigensolve service (``repro_torch/service``) on the CPU.

* **Keys and plans against the reference**: ``pattern_hash`` (the full
  pattern pass and the probe above ``PATTERN_HASH_PROBE_D``),
  ``machine_fingerprint``, ``cache_key`` and ``rowmap_fingerprint`` equal
  the reference's on every family; ``plan_to_json`` writes the
  reference's JSON for the same plan, and the port's own plan's JSON
  equals it up to the planners' 1e-12 float agreement.
* **The plan cache**: a hit skips the planner, a version bump or a
  re-fit machine misses, a corrupt store misses on ``get`` and refuses
  on ``put``, ``put`` merges, concurrent writers lose nothing, and a
  store written by the reference reads in the port.
* **Resume**, port against port: a fault injected mid-solve, a crash
  that also destroys the newest commit marker, and a fresh process
  resuming: bit-identical eigenvalues, residuals, history and
  ``FDResult.exchange``; a mismatched row map is refused.
* **Batching**, port against port: two requests of different targets,
  seeds and degrees, batched, equal each served alone bit for bit on
  SpinChainXXZ(8,4) at 1×1 (through the service and its plan cache) and
  1×2, on RoadNet(1000) at 2×2 on the commvol map, and on an s-step
  group (which filters each request on its own); the per-column μ pins
  (``chebyshev_filter`` with a 2-D μ).
* **Against the reference's jobs** on an Auto-axis mesh
  (``jax.make_mesh((1, 1), ("row", "col"), axis_types=(AxisType.Auto,) *
  2)``; ``make_solver_mesh``'s Explicit axes fail on jax 0.9.0), from its
  draws: ``FilterDiagJob`` with a fault at iteration 4 and
  ``BatchedJob``: equal iterations, eigenvalues to 1e-9.
* **The CLI**: ``--serve``, ``--plan-cache`` (a second run hits),
  ``--degraded-ok`` (a failed solve retried on one column group fewer; a
  kernel's error raised, not retried).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch
from jax.sharding import AxisType

from repro.core import FDConfig as RefFDConfig
from repro.core import FilterDiag as RefFilterDiag
from repro.core import perf_model as ref_pm
from repro.core import planner as ref_planner
from repro.core.partition import plan_rowmap as ref_plan_rowmap
from repro.matrices import get_family as ref_family
from repro.matrices.sparse import CSR as RefCSR
from repro.runtime import Supervisor as RefSupervisor
from repro.runtime import SupervisorConfig as RefSupervisorConfig
from repro.service import BatchedJob as RefBatchedJob
from repro.service import FilterDiagJob as RefFilterDiagJob
from repro.service import SolveRequest as RefSolveRequest
from repro.service import plan_cache as ref_pc
from repro.service.jobs import rowmap_fingerprint as ref_rowmap_fingerprint
from repro_torch import convert
from repro_torch.core import (FDConfig, FilterDiag, build_dist_ell,
                              chebyshev_filter, make_fused_cheb_step,
                              make_spmv, plan_rowmap)
from repro_torch.core import perf_model as pm
from repro_torch.core import planner
from repro_torch.core.chebyshev import chebyshev_filter_sstep
from repro_torch.kernels import ref as kernels_ref
from repro_torch.launch import solve as cli
from repro_torch.matrices import get_family
from repro_torch.matrices.sparse import CSR
from repro_torch.runtime import StragglerWatchdog, Supervisor, SupervisorConfig
from repro_torch.service import (CACHE_VERSION, BatchedJob, EigenService,
                                 FilterDiagJob, PlanCache, SolveRequest,
                                 cache_key, cached_plan_layout,
                                 machine_fingerprint, pattern_hash,
                                 plan_from_json, plan_to_json)
from repro_torch.service import plan_cache as plan_cache_mod
from repro_torch.service.jobs import (pack_state, rowmap_fingerprint,
                                      unpack_state)
from tests.conftest import SRC


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "hubbard": ("Hubbard", dict(n_sites=6, n_fermions=3)),
    "spin": ("SpinChainXXZ", dict(n_sites=8, n_up=4)),
    "exciton": ("Exciton", dict(L=2)),
    "topins": ("TopIns", dict(Lx=4)),
    "roadnet": ("RoadNet", dict(n=500, w=2, m=64, k=4)),
    "hubnet": ("HubNet", dict(n=500, w=2, h=4, m=48, k=4)),
}


def _both(name):
    fam, params = FAMILIES[name]
    return ref_family(fam, **params), get_family(fam, **params)


# --------------------------------------------- keys against the reference --


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_pattern_hash_equals_the_reference(name):
    ref_m, m = _both(name)
    assert pattern_hash(m) == ref_pc.pattern_hash(ref_m)


def _random_csr(D: int, seed: int, cls, avg_deg: int = 4):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 2 * avg_deg, size=D)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    cols = rng.integers(0, D, size=int(indptr[-1])).astype(np.int64)
    return cls(indptr=indptr, indices=cols, data=None, shape=(D, D))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pattern_hash_of_a_csr_is_slot_order_invariant(seed):
    m = _random_csr(40 + seed, seed, CSR)
    rng = np.random.default_rng(seed + 7)
    idx = np.concatenate([m.indptr[r] + rng.permutation(
        m.indptr[r + 1] - m.indptr[r]) for r in range(m.shape[0])])
    shuffled = CSR(indptr=m.indptr, indices=m.indices[idx], data=None,
                   shape=m.shape)
    dup = CSR(indptr=m.indptr * 2, indices=np.repeat(m.indices, 2),
              data=None, shape=m.shape)
    ref_m = _random_csr(40 + seed, seed, RefCSR)
    assert pattern_hash(m) == pattern_hash(shuffled) == pattern_hash(dup) \
        == ref_pc.pattern_hash(ref_m)


def test_probe_pattern_hash_equals_the_reference():
    """Past ``PATTERN_HASH_PROBE_D`` the hash probes the generator's rows:
    the same probe, the same hash as the reference's; distinct across
    sizes and families."""
    big = get_family("RoadNet", n=3_000_000, w=1, m=400, k=2)
    assert big.D > plan_cache_mod.PATTERN_HASH_PROBE_D
    h = pattern_hash(big)
    assert h == pattern_hash(big) == ref_pc.pattern_hash(
        ref_family("RoadNet", n=3_000_000, w=1, m=400, k=2))
    assert h != pattern_hash(get_family("RoadNet", n=3_000_001, w=1, m=400,
                                        k=2))
    assert h != pattern_hash(get_family("HubNet", n=3_000_000, w=1, h=4,
                                        m=400, k=2))
    small = get_family("RoadNet", n=4000, w=2, m=256, k=4)
    assert pattern_hash(small) == pattern_hash(small.build_csr())


MACHINES = {"tpu-v5e": ref_pm.TPU_V5E, "meggie": ref_pm.MEGGIE}


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_machine_fingerprint_and_cache_key_equal_the_reference(machine):
    ref_m = MACHINES[machine]
    m = convert.machine_from_fields(ref_m)
    assert machine_fingerprint(m) == ref_pc.machine_fingerprint(ref_m)
    kw = dict(n_search=16, degree=100, d_pad=504, kernel=(False, True),
              plan_mode="exact")
    assert cache_key("ph", 8, m, **kw) == ref_pc.cache_key("ph", 8, ref_m,
                                                           **kw)
    refit = pm.MachineModel(name=m.name, b_m=m.b_m, b_c=m.b_c,
                            kappa=m.kappa * 1.01, alpha=m.alpha)
    assert machine_fingerprint(refit) != machine_fingerprint(m)
    assert cache_key("ph", 8, refit, **kw) != cache_key("ph", 8, m, **kw)


@pytest.mark.parametrize("balance,reorder", [("commvol", "none"),
                                             ("rows", "rcm"),
                                             ("commvol", "rcm")])
@pytest.mark.parametrize("name", ["spin", "roadnet", "hubnet"])
def test_rowmap_fingerprint_equals_the_reference(name, balance, reorder):
    ref_m, m = _both(name)
    rm = plan_rowmap(m, 4, balance=balance, reorder=reorder)
    want = ref_rowmap_fingerprint(ref_plan_rowmap(ref_m, 4, balance=balance,
                                                  reorder=reorder))
    assert rowmap_fingerprint(rm) == want is not None


def test_equal_rows_map_has_no_fingerprint():
    """The reference's solver holds the equal-rows partition as no map."""
    _, m = _both("spin")
    assert rowmap_fingerprint(plan_rowmap(m, 4)) is None
    assert ref_rowmap_fingerprint(None) is None


def _close(a, b, where="plan"):
    """JSON trees equal, floats to 1e-12 relative."""
    if isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (where, a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", ["spin", "roadnet", "hubnet"])
def test_plan_json_equals_the_reference(name):
    ref_m, m = _both(name)
    kw = dict(n_search=16, d_pad=-(-m.D // 8) * 8)
    ref_plan = ref_planner.plan_layout(ref_m, 8, machine=ref_pm.TPU_V5E, **kw)
    plan = planner.plan_layout(
        m, 8, machine=convert.machine_from_fields(ref_pm.TPU_V5E), **kw)
    want = json.loads(json.dumps(ref_pc.plan_to_json(ref_plan)))
    # the same plan serializes to the same JSON ...
    assert json.loads(json.dumps(plan_to_json(
        convert.plan_from_fields(ref_plan)))) == want
    # ... the reference's JSON reads losslessly in the port ...
    back = convert.plan_from_json(want)
    assert json.loads(json.dumps(plan_to_json(back))) == want
    assert back.candidates == convert.plan_from_fields(ref_plan).candidates
    # ... and the port's own plan's JSON is the reference's
    _close(json.loads(json.dumps(plan_to_json(plan))), want)


@pytest.mark.parametrize("name", ["spin", "roadnet", "hubnet"])
def test_plan_roundtrip_lossless(name):
    """plan → JSON → plan keeps every candidate and row map; the comm plan
    recomputed from the restored best candidate reproduces its bytes."""
    _, m = _both(name)
    d_pad = -(-m.D // 8) * 8
    plan = planner.plan_layout(m, 8, n_search=16, d_pad=d_pad)
    plan2 = plan_from_json(json.loads(json.dumps(plan_to_json(plan))))
    assert plan2.candidates == plan.candidates
    for c, c2 in zip(plan.candidates, plan2.candidates):
        assert (c.rowmap is None) == (c2.rowmap is None)
        if c.rowmap is not None:
            assert np.array_equal(c.rowmap.perm, c2.rowmap.perm)
            assert np.array_equal(c.rowmap.boundaries, c2.rowmap.boundaries)
            assert (c.rowmap.R, c.rowmap.sstep) == (c2.rowmap.R,
                                                    c2.rowmap.sstep)
    best = plan2.best
    cp = (planner.comm_plan(m, best.n_row, rowmap=best.rowmap)
          if best.rowmap is not None else
          planner.comm_plan(m, best.n_row, d_pad=d_pad, sstep=best.sstep))
    n_b = plan.n_search // best.n_col
    assert cp.comm_bytes_per_device(best.comm, n_b, getattr(m, "S_d", 8),
                                    best.schedule) \
        == plan.best.comm_bytes_per_device


# -------------------------------------------------------- the plan cache --


def _spin():
    return get_family("SpinChainXXZ", n_sites=8, n_up=4)


def test_cache_hit_skips_planner(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = plan_cache_mod.planner.plan_layout

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(plan_cache_mod.planner, "plan_layout", counting)
    cache = PlanCache(str(tmp_path / "plans.json"))
    plan1, hit1 = cached_plan_layout(_spin(), 4, n_search=8, cache=cache)
    plan2, hit2 = cached_plan_layout(_spin(), 4, n_search=8, cache=cache)
    assert (hit1, hit2) == (False, True)
    assert calls["n"] == 1 and cache.plan_calls == 1
    assert cache.hits == 1 and cache.misses == 1
    assert plan2.candidates == plan1.candidates and plan2.best == plan1.best
    assert plan1.machine == pm.H100_1CARD.name
    _, hit3 = cached_plan_layout(_spin(), 4, n_search=16, cache=cache)
    assert not hit3 and calls["n"] == 2


def test_cache_version_bump_invalidates(tmp_path, monkeypatch):
    cache = PlanCache(str(tmp_path / "plans.json"))
    assert not cached_plan_layout(_spin(), 4, n_search=8, cache=cache)[1]
    assert CACHE_VERSION == 1
    monkeypatch.setattr(plan_cache_mod, "CACHE_VERSION", CACHE_VERSION + 1)
    assert not cached_plan_layout(_spin(), 4, n_search=8, cache=cache)[1]


def test_cache_refit_machine_misses(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    m = pm.H100_1CARD
    refit = pm.MachineModel(name=m.name, b_m=m.b_m, b_c=m.b_c * 1.01,
                            kappa=m.kappa, alpha=m.alpha)
    assert not cached_plan_layout(_spin(), 4, n_search=8, cache=cache)[1]
    assert not cached_plan_layout(_spin(), 4, n_search=8, cache=cache,
                                  machine=refit)[1]
    assert cached_plan_layout(_spin(), 4, n_search=8, cache=cache)[1]


def test_corrupt_store_miss_on_get_refuse_on_put(tmp_path):
    path = tmp_path / "plans.json"
    cache = PlanCache(str(path))
    plan, _ = cached_plan_layout(_spin(), 4, n_search=8, cache=cache)
    path.write_text("{not json")
    assert cache.get("anything") is None
    with pytest.raises(ValueError, match="refusing to merge"):
        cache.put("k", plan)
    path.write_text(json.dumps({"schema": "bogus", "entries": {}}))
    assert cache.get("anything") is None
    with pytest.raises(ValueError, match="refusing to merge"):
        cache.put("k", plan)


def test_merge_on_write_keeps_existing_entries(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    cached_plan_layout(_spin(), 4, n_search=8, cache=cache)
    cached_plan_layout(_spin(), 4, n_search=16, cache=cache)
    with open(cache.path) as f:
        assert len(json.load(f)["entries"]) == 2


def test_sampled_plan_keys_distinct_from_exact(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    hits = [cached_plan_layout(_spin(), 4, n_search=8, cache=cache,
                               plan_mode=mode)[1]
            for mode in ("exact", "sampled", "exact", "sampled")]
    assert hits == [False, False, True, True] and cache.plan_calls == 2


def test_reference_store_reads_in_the_port(tmp_path):
    """A store the reference's cache wrote (TPU machine carried across as
    values) is a hit for the port under the same key."""
    path = str(tmp_path / "plans.json")
    ref_m = ref_family("SpinChainXXZ", n_sites=8, n_up=4)
    ref_plan, hit = ref_pc.cached_plan_layout(
        ref_m, 4, n_search=8, cache=ref_pc.PlanCache(path),
        machine=ref_pm.TPU_V5E)
    assert not hit
    cache = PlanCache(path)
    plan, hit = cached_plan_layout(
        _spin(), 4, n_search=8, cache=cache,
        machine=convert.machine_from_fields(ref_pm.TPU_V5E))
    assert hit and cache.plan_calls == 0
    assert plan.candidates == convert.plan_from_fields(ref_plan).candidates


def test_concurrent_writers_lose_no_records(tmp_path):
    path = tmp_path / "plans.json"
    plan, _ = cached_plan_layout(_spin(), 4, n_search=8,
                                 cache=PlanCache(str(path)))
    (tmp_path / "plan.json").write_text(json.dumps(plan_to_json(plan)))
    n_writers, n_keys = 6, 5
    script = (
        "import json, sys\n"
        "from repro_torch.service import PlanCache, plan_from_json\n"
        "wid = int(sys.argv[1])\n"
        f"plan = plan_from_json(json.load(open("
        f"{str(tmp_path / 'plan.json')!r})))\n"
        f"cache = PlanCache({str(path)!r})\n"
        f"for j in range({n_keys}):\n"
        "    cache.put(f'writer{wid}-key{j}', plan)\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=dict(os.environ, PYTHONPATH=SRC),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for i in range(n_writers)]
    while any(p.poll() is None for p in procs):
        if path.exists():
            try:
                store = json.loads(path.read_text())
            except ValueError as e:  # pragma: no cover - the defect
                for p in procs:
                    p.kill()
                raise AssertionError(f"torn store observed mid-race: {e}")
            assert "entries" in store
    for p in procs:
        out, err = p.communicate()
        assert p.returncode == 0, f"writer failed:\n{out}\n{err}"
    store = json.loads(path.read_text())
    keys = {f"writer{i}-key{j}" for i in range(n_writers)
            for j in range(n_keys)}
    assert not keys - set(store["entries"])
    fresh = PlanCache(str(path))
    for k in sorted(keys):
        got = fresh.get(k)
        assert got is not None and got.best == plan.best, k


# ------------------------------------------------------------------- resume --

FD = dict(n_search=8, n_target=4, target=-1.5, tol=1e-8, max_iters=30, seed=3)
GRIDS = [("stack", 1, 1), ("stack", 2, 1), ("pillar", 1, 2)]


def _fd(layout="stack", n_row=1, n_col=1, **kw):
    return FilterDiag(_spin(), FDConfig(layout=layout, **{**FD, **kw}),
                      device="cpu", n_row=n_row, n_col=n_col)


_clean: dict = {}


def _clean_result(grid):
    if grid not in _clean:
        _clean[grid] = _fd(*grid).solve()
    return _clean[grid]


def _same_result(res, clean):
    assert np.array_equal(res.eigenvalues, clean.eigenvalues)
    assert np.array_equal(res.residuals, clean.residuals)
    assert np.array_equal(res.eigenvectors, clean.eigenvectors)
    assert (res.iterations, res.total_spmvs, res.redistributions) == \
        (clean.iterations, clean.total_spmvs, clean.redistributions)
    assert res.history == clean.history
    assert res.exchange == clean.exchange


@pytest.mark.parametrize("grid", GRIDS)
def test_fault_injection_resume_bit_identical(tmp_path, grid):
    """A fault before iteration 5, the last checkpoint at 4: the replayed
    iteration is counted once, and the result (exchange counters too)
    equals the uninterrupted solve's bit for bit."""
    clean = _clean_result(grid)
    assert clean.n_converged >= 4
    faults = {"armed": True}

    def fault_hook(step):
        if step == 5 and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("simulated node failure mid-sweep")

    sup = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=2,
                                                     max_restarts=2))
    job = FilterDiagJob(_fd(*grid))
    state = sup.run_job(job, fault_hook=fault_hook,
                        watchdog=StragglerWatchdog())
    assert sup.restarts == 1 and not faults["armed"]
    _same_result(job.result(state), clean)


def test_crash_mid_checkpoint_falls_back_to_committed(tmp_path):
    clean = _clean_result(GRIDS[1])
    faults = {"armed": True}

    def fault_hook(step):
        if step >= 5 and faults["armed"]:
            faults["armed"] = False
            newest = max(n for n in os.listdir(tmp_path)
                         if n.startswith("step_") and not n.endswith(".tmp"))
            os.remove(tmp_path / newest / "_COMMITTED")
            raise RuntimeError("node died while committing")

    sup = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=1,
                                                     max_restarts=2))
    job = FilterDiagJob(_fd(*GRIDS[1]))
    state = sup.run_job(job, fault_hook=fault_hook)
    assert sup.restarts == 1
    _same_result(job.result(state), clean)


@pytest.mark.parametrize("grid", GRIDS[1:])
def test_fresh_process_resumes_with_the_counters(tmp_path, grid):
    """A job that dies (no restarts allowed) resumes in a new solver from
    its checkpoint: the counters come from the checkpoint, so the result
    reports the uninterrupted solve's exchanges."""
    clean = _clean_result(grid)

    def die(step):
        if step == 5:
            raise RuntimeError("the process is gone")

    sup = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=2,
                                                     max_restarts=0))
    with pytest.raises(RuntimeError, match="gone"):
        sup.run_job(FilterDiagJob(_fd(*grid)), fault_hook=die)
    sup2 = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=2))
    job = FilterDiagJob(_fd(*grid))
    state = sup2.run_job(job)
    assert sup2.restarts == 0
    _same_result(job.result(state), clean)


def test_resume_refuses_mismatched_rowmap():
    fd = _fd()
    tree, extra = pack_state(fd.init_state(), fd)
    rm = plan_rowmap(_spin(), 2, balance="commvol")
    fd2 = FilterDiag(_spin(), FDConfig(n_search=8, spmv_balance="commvol"),
                     device="cpu", n_row=2, rowmap=rm)
    with pytest.raises(ValueError, match="rowmap"):
        unpack_state(tree, extra, fd2)


def test_pack_refuses_a_pending_filter():
    fd = _fd()
    state = fd.step_analyze(fd.init_state())
    assert state.pending is not None
    with pytest.raises(ValueError, match="iteration boundary"):
        pack_state(state, fd)


# ----------------------------------------------------------------- batching --

_REQS = dict(family="SpinChainXXZ", params=dict(n_sites=8, n_up=4),
             n_target=3, n_search=8, tol=1e-8, max_iters=30)


def _requests():
    return {"a": SolveRequest("a", **_REQS, target=-1.5, seed=11),
            "b": SolveRequest("b", **_REQS, target=0.5, seed=22)}


def _degrees(res):
    return [h.get("degree") for h in res.history]


def _same_as_solo(both: dict, solo: dict):
    for rid, s in solo.items():
        r = both[rid]
        assert np.array_equal(r.eigenvalues, s.eigenvalues), rid
        assert np.array_equal(r.residuals, s.residuals), rid
        assert np.array_equal(r.eigenvectors, s.eigenvectors), rid
        assert (r.iterations, r.total_spmvs) == (s.iterations,
                                                 s.total_spmvs), rid
        assert _degrees(r) == _degrees(s), rid


def test_duplicate_request_id_rejected():
    svc = EigenService(device="cpu")
    svc.submit(SolveRequest("a", **_REQS))
    with pytest.raises(ValueError, match="duplicate"):
        svc.submit(SolveRequest("a", **_REQS))


def test_batched_demux_matches_solo_through_the_service(tmp_path):
    """Two co-batched requests (different targets, seeds and degrees)
    equal their solo drains; the plan comes through the cache, planned
    once over three drains."""
    cache = PlanCache(str(tmp_path / "plans.json"))

    def run(ids):
        svc = EigenService(device="cpu", plan_cache=cache,
                           ckpt_root=str(tmp_path / "_".join(ids)))
        for i in ids:
            svc.submit(_requests()[i])
        out = svc.drain()
        assert svc.groups[0]["requests"] == ids
        return out

    both = run(["a", "b"])
    assert _degrees(both["a"]) != _degrees(both["b"])
    _same_as_solo(both, {"a": run(["a"])["a"], "b": run(["b"])["b"]})
    assert cache.plan_calls == 1 and cache.hits >= 2


def _run_job(fd, reqs):
    job = BatchedJob(fd, reqs)
    states = job.init()
    while not job.done(states):
        states = job.step(states)
    return job.results(states)


def _batched_and_solo(make_fd, reqs):
    fd = make_fd()
    both = _run_job(fd, list(reqs.values()))
    solo, exchanges = {}, 0
    for rid, r in reqs.items():
        fd1 = make_fd()
        solo[rid] = _run_job(fd1, [r])[rid]
        exchanges += fd1.filter_exchanges
    _same_as_solo(both, solo)
    return fd, both, exchanges


def test_batched_demux_matches_solo_pillar_1x2():
    _batched_and_solo(
        lambda: FilterDiag(_spin(), FDConfig(n_search=8, layout="pillar",
                                             spmv_kernel=True),
                           device="cpu", n_row=1, n_col=2), _requests())


def test_batched_demux_matches_solo_roadnet_2x2_commvol():
    """RoadNet(1000) at its upper edge on a panel 2×2 over the commvol
    map: bit-identical demux, and one shared sweep a batched iteration —
    its halo exchanges follow the larger degree, fewer than the solo
    runs' together."""
    mat = get_family("RoadNet", n=1000, w=2, m=64, k=4)
    top = float(sla.eigsh(mat.build_csr().to_scipy(), k=1, which="LA",
                          return_eigenvectors=False)[0])
    rm = plan_rowmap(mat, 4, balance="commvol")
    R = dict(n_search=16, tol=1e-8, max_iters=60, target=top + 0.1)
    reqs = {"a": SolveRequest("a", n_target=4, seed=11, **R),
            "b": SolveRequest("b", n_target=2, seed=22, **R)}
    fd, both, solo_exchanges = _batched_and_solo(
        lambda: FilterDiag(mat, FDConfig(n_search=16, layout="panel",
                                         spmv_kernel=True),
                           device="cpu", n_row=2, n_col=2, rowmap=rm), reqs)
    da, db = _degrees(both["a"])[:-1], _degrees(both["b"])[:-1]
    steps = [max(x for x in pair if x is not None) for pair in
             zip(da + [None] * (len(db) - len(da)),
                 db + [None] * (len(da) - len(db)))]
    assert fd.filter_exchanges == sum(fd.exchanges_per_filter(d)
                                      for d in steps) * fd.N_col
    assert 0 < fd.filter_exchanges < solo_exchanges


def test_sstep_group_filters_each_request():
    """An s-step cell (depth 2 over 2 row shards) filters each request on
    its own and still demuxes bit for bit."""
    _batched_and_solo(
        lambda: FilterDiag(_spin(), FDConfig(n_search=8, layout="stack",
                                             spmv_sstep=2, spmv_kernel=True),
                           device="cpu", n_row=2, n_col=1), _requests())


def test_batched_resume_bit_identical(tmp_path):
    """A batch supervised with a fault: the same results as the
    unsupervised batch."""
    def make():
        return FilterDiag(_spin(), FDConfig(n_search=8, layout="pillar"),
                          device="cpu", n_row=1, n_col=2)

    clean = _run_job(make(), list(_requests().values()))
    faults = {"armed": True}

    def fault_hook(step):
        if step == 7 and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("simulated failure")

    sup = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=3,
                                                     max_restarts=1))
    job = BatchedJob(make(), list(_requests().values()))
    got = job.results(sup.run_job(job, fault_hook=fault_hook))
    assert sup.restarts == 1
    for rid in clean:
        _same_result(got[rid], clean[rid])


# ------------------------------------------------------- the per-column μ --

def _filter_setup(family, params, dtype):
    mat = get_family(family, **params)
    ell = build_dist_ell(mat, 1, dtype=dtype, device="cpu")
    spmv = make_spmv(ell)
    fused = make_fused_cheb_step(ell, use_kernel=True)
    g = torch.Generator().manual_seed(5)
    V = torch.randn((ell.D_pad, 12), generator=g, dtype=torch.float64)
    V = V.to(ell.vals.dtype)
    if ell.vals.dtype.is_complex:
        V = V + 1j * torch.randn((ell.D_pad, 12), generator=g,
                                 dtype=torch.float64).to(V.dtype)
    return spmv, fused, V


CASES = [("SpinChainXXZ", dict(n_sites=8, n_up=4), "float64"),
         ("SpinChainXXZ", dict(n_sites=8, n_up=4), "float32"),
         ("Exciton", dict(L=2), "float64"),
         ("Exciton", dict(L=2), "float32")]
ALPHA, BETA = 0.21, -0.07


@pytest.mark.parametrize("fused_step", [False, True])
@pytest.mark.parametrize("family,params,dtype", CASES)
def test_equal_columns_of_a_2d_mu_give_the_1d_bits(family, params, dtype,
                                                   fused_step):
    """Pinned: ``Y.addcmul_(T, mu[k])`` rounds as ``Y.add_(T,
    alpha=mu_k)`` (one fused multiply-add each) in fp64, fp32, complex128
    and complex64, so equal columns give the 1-D filter's bits."""
    spmv, fused, V = _filter_setup(family, params, dtype)
    mu = np.random.default_rng(1).standard_normal(9)
    step = fused if fused_step else None
    want = chebyshev_filter(spmv, mu, ALPHA, BETA, V, fused_step=step)
    Mu = np.repeat(mu[:, None], V.shape[1], axis=1)
    got = chebyshev_filter(spmv, Mu, ALPHA, BETA, V, fused_step=step)
    assert torch.equal(got, want)


@pytest.mark.parametrize("family,params,dtype", CASES)
def test_zero_padded_columns_give_their_own_degree(family, params, dtype):
    spmv, fused, V = _filter_setup(family, params, dtype)
    rng = np.random.default_rng(2)
    mu_a, mu_b = rng.standard_normal(6), rng.standard_normal(10)
    Mu = np.zeros((10, 12))
    Mu[:6, :5] = mu_a[:, None]
    Mu[:, 5:] = mu_b[:, None]
    got = chebyshev_filter(spmv, Mu, ALPHA, BETA, V, fused_step=fused)
    want_a = chebyshev_filter(spmv, mu_a, ALPHA, BETA,
                              V[:, :5].contiguous(), fused_step=fused)
    want_b = chebyshev_filter(spmv, mu_b, ALPHA, BETA,
                              V[:, 5:].contiguous(), fused_step=fused)
    assert torch.equal(got[:, :5], want_a)
    assert torch.equal(got[:, 5:], want_b)


def test_2d_mu_shape_is_checked_and_the_sstep_filter_refuses_it():
    spmv, _, V = _filter_setup("SpinChainXXZ", dict(n_sites=8, n_up=4),
                               "float64")
    with pytest.raises(ValueError, match="mu must be"):
        chebyshev_filter(spmv, np.zeros((5, 3)), ALPHA, BETA, V)
    with pytest.raises(ValueError, match="1-D mu"):
        chebyshev_filter_sstep(None, np.zeros((5, 12)), ALPHA, BETA, V, 2)


def test_filter_block_splits_the_columns_over_the_bundles():
    """``FilterDiag.filter_block`` at N_col = 2 over a 16-wide block of two
    requests equals each request's 8 columns filtered alone."""
    fd = FilterDiag(_spin(), FDConfig(n_search=8, layout="panel"),
                    device="cpu", n_row=2, n_col=2)
    state = fd.init_state()
    rng = np.random.default_rng(3)
    mu_a, mu_b = rng.standard_normal(5), rng.standard_normal(8)
    Mu = np.zeros((8, 16))
    Mu[:5, :8] = mu_a[:, None]
    Mu[:, 8:] = mu_b[:, None]
    V = torch.cat([state.V, state.V.flip(1)], dim=1)
    tally = type(state)(V=None, lam=state.lam)
    Y = fd.filter_block(V, Mu, 7, state.lam, tally)
    assert tally.redistributions == 2
    for cols, mu in ((slice(0, 8), mu_a), (slice(8, 16), mu_b)):
        want = fd.filter_block(V[:, cols].contiguous(), mu, len(mu) - 1,
                               state.lam, tally)
        assert torch.equal(Y[:, cols], want)


# ------------------------------------------- against the reference's jobs --


def _auto_mesh():
    return jax.make_mesh((1, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


def _ref_fd(mesh, **kw):
    cfg = RefFDConfig(**{**FD, **kw})
    fd = RefFilterDiag(ref_family("SpinChainXXZ", n_sites=8, n_up=4), mesh,
                       cfg)
    # compiled once: called eagerly, each Lanczos SpMV re-dispatches
    fd.spmv_stack = jax.jit(fd.spmv_stack)
    return fd


def test_filter_diag_job_against_the_reference(tmp_path):
    faults = {"ref": True, "port": True}

    def hook(which):
        def fault_hook(step):
            if step == 4 and faults[which]:
                faults[which] = False
                raise RuntimeError("simulated node failure")
        return fault_hook

    mesh = _auto_mesh()
    with mesh:
        fd = _ref_fd(mesh)
        sup = RefSupervisor(str(tmp_path / "ref"), RefSupervisorConfig(
            checkpoint_interval=1, max_restarts=2))
        job = RefFilterDiagJob(fd)
        want = job.result(sup.run_job(job, fault_hook=hook("ref")))
        k0, k1 = jax.random.split(jax.random.PRNGKey(FD["seed"]))
        v0 = np.asarray(jax.random.normal(k0, (fd.D_pad, 1)))
        V0 = np.asarray(jax.random.normal(k1, (fd.D_pad, FD["n_search"])))
    assert sup.restarts == 1
    psup = Supervisor(str(tmp_path / "port"), SupervisorConfig(
        checkpoint_interval=1, max_restarts=2))
    pjob = FilterDiagJob(_fd(), V0=V0, v0=v0)
    got = pjob.result(psup.run_job(pjob, fault_hook=hook("port")))
    assert psup.restarts == 1
    assert got.iterations == want.iterations
    assert np.abs(np.sort(got.eigenvalues)
                  - np.sort(np.asarray(want.eigenvalues))).max() <= 1e-9


def test_batched_job_against_the_reference():
    """The reference's ``BatchedJob`` built on an Auto-axis solver (not
    through ``EigenService``, which builds Explicit axes), and the port's
    from the reference's draws."""
    reqs = dict(a=dict(target=-1.5, seed=11), b=dict(target=0.5, seed=22))
    mesh = _auto_mesh()
    with mesh:
        fd = _ref_fd(mesh, n_search=8)
        job = RefBatchedJob(fd, [RefSolveRequest(rid, **_REQS, **kw)
                                 for rid, kw in reqs.items()],
                            service_seed=0)
        states = job.init()
        while not job.done(states):
            states = job.step(states)
        want = job.results(states)
        v0 = np.asarray(jax.random.normal(
            jax.random.split(jax.random.PRNGKey(0))[0], (fd.D_pad, 1)))
        V0 = {rid: np.asarray(jax.random.normal(
            jax.random.split(jax.random.PRNGKey(kw["seed"]))[1],
            (fd.D_pad, _REQS["n_search"]))) for rid, kw in reqs.items()}
    pjob = BatchedJob(_fd(), [SolveRequest(rid, **_REQS, **kw)
                              for rid, kw in reqs.items()],
                      **convert.batch_draws_from_arrays(v0, V0))
    states = pjob.init()
    while not pjob.done(states):
        states = pjob.step(states)
    got = pjob.results(states)
    for rid in reqs:
        assert got[rid].iterations == want[rid].iterations, rid
        assert np.abs(np.sort(got[rid].eigenvalues) - np.sort(np.asarray(
            want[rid].eigenvalues))).max() <= 1e-9, rid


# ----------------------------------------------------------------- the CLI --


def _requests_json(tmp_path, **extra):
    path = tmp_path / "requests.json"
    path.write_text(json.dumps(dict(requests=[
        dict(req_id=rid, family="SpinChainXXZ",
             params=dict(n_sites=8, n_up=4), n_target=3, n_search=8,
             target=r.target, tol=1e-8, max_iters=30, seed=r.seed)
        for rid, r in _requests().items()], service_seed=0, **extra)))
    return str(path)


def test_cli_serve_with_a_plan_cache(tmp_path, capsys):
    reqs = _requests_json(tmp_path)
    cache = str(tmp_path / "cache.json")
    argv = ["--serve", reqs, "--plan-cache", cache, "--device", "cpu",
            "--n-row", "2", "--spmv-kernel"]
    first = cli.main(argv, verbose=False)
    out1 = capsys.readouterr().out
    second = cli.main(argv, verbose=False)
    out2 = capsys.readouterr().out
    assert "[plan-cache] hits=0 misses=1 plan_calls=1" in out1
    assert "[plan-cache] hits=1 misses=0 plan_calls=0" in out2
    assert "served 2 requests" in out2
    assert sorted(first) == ["a", "b"]
    _same_as_solo(second, first)
    # the service over the same cell equals the Python API's drain
    svc = EigenService(n_shards=2, device="cpu", spmv_kernel=True,
                       plan_cache=PlanCache(cache))
    for r in _requests().values():
        svc.submit(r)
    _same_as_solo(svc.drain(), first)


def test_cli_serve_with_a_checkpoint_root(tmp_path, capsys):
    reqs = _requests_json(tmp_path, checkpoint_root=str(tmp_path / "ck"))
    res = cli.main(["--serve", reqs, "--device", "cpu"], verbose=False)
    assert os.path.isdir(tmp_path / "ck" / "group_000")
    assert all(r.n_converged >= 3 for r in res.values())


def test_cli_auto_layout_with_a_plan_cache(tmp_path, capsys):
    argv = ["--family", "SpinChainXXZ", "--params", "n_sites=8,n_up=4",
            "--n-target", "3", "--n-search", "8", "--target", "-1.5",
            "--tol", "1e-8", "--max-iters", "30", "--layout", "auto",
            "--n-row", "2", "--device", "cpu", "--plan-cache",
            str(tmp_path / "cache.json")]
    r1 = cli.main(argv, verbose=False)
    assert "[plan-cache] miss" in capsys.readouterr().out
    r2 = cli.main(argv, verbose=False)
    assert "[plan-cache] hit" in capsys.readouterr().out
    assert np.array_equal(r1.eigenvalues, r2.eigenvalues)


DEGRADED = ["--family", "SpinChainXXZ", "--params", "n_sites=8,n_up=4",
            "--n-target", "2", "--n-search", "8", "--target", "-1.5",
            "--tol", "1e-8", "--max-iters", "30", "--layout", "pillar",
            "--n-col", "2", "--device", "cpu", "--degraded-ok"]


def test_cli_degraded_ok_retries_on_one_column_group_fewer(monkeypatch,
                                                           capsys):
    real = FilterDiag.solve
    seen = []

    def flaky(self, *a, **kw):
        seen.append((self.N_col, self.cfg.n_search, self.device.type,
                     self.cfg.spmv_kernel))
        if len(seen) == 1:
            raise RuntimeError("lost a column group")
        return real(self, *a, **kw)

    monkeypatch.setattr(FilterDiag, "solve", flaky)
    res = cli.main(DEGRADED + ["--spmv-kernel"], verbose=False)
    out = capsys.readouterr().out
    assert seen == [(2, 8, "cpu", True), (1, 4, "cpu", True)]
    assert "[degraded]" in out and "lost a column group" in out
    assert "pillar(1x1)" in out and res.n_converged >= 2
    want = FilterDiag(_spin(), FDConfig(n_target=2, n_search=4,
                                        target=-1.5, tol=1e-8, max_iters=30,
                                        layout="pillar", spmv_kernel=True),
                      device="cpu", n_row=1, n_col=1).solve()
    assert np.array_equal(res.eigenvalues, want.eigenvalues)


def test_cli_degraded_ok_raises_a_kernel_error(monkeypatch):
    """A failure inside a kernel's wrapper (the DIA step's, with
    ``--spmv-kernel``; on the CPU the wrapper runs the plain version) is
    raised, never retried on fewer columns."""
    def broken(*a, **kw):
        raise RuntimeError("cheb_dia: launch failed")

    monkeypatch.setattr(kernels_ref, "cheb_dia_ref", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        cli.main(DEGRADED + ["--spmv-kernel"], verbose=False)


@pytest.mark.parametrize("exc,fault", [
    (RuntimeError("CUDA error: an illegal memory access"), True),
    (RuntimeError("lost a column group"), False),
    (ValueError("n_search=7 is not divisible by N_col=2"), False)])
def test_device_fault_tells_the_card_apart(exc, fault):
    assert cli.device_fault(exc) is fault


def test_cli_needs_a_family_or_serve():
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"], verbose=False)
