"""The s-step filter of the port (``build_sstep_ell``, ``make_sstep_cheb``,
``chebyshev_filter_sstep``, ``comm_plan(sstep=s)``, ``plan_layout``'s
s-step axis, ``FDConfig(spmv_sstep)``, ``--spmv-sstep``) and KPM, on the
CPU, against the JAX package's and against the port's own s = 1 path.

* ``sstep_ghosts`` and every array of ``build_sstep_ell`` (the step
  blocks, the exchange plan, the ghost statistics, both neighbour plans
  and the split-phase form) equal the reference's, on equal rows and on
  commvol and RCM maps planned at depth s, one family complex; at s = 1
  ``as_dist_ell()`` is the port's ``build_dist_ell``.
* The port's s ∈ {2, 3} filter equals its s = 1 filter (the fused step)
  bit for bit over {a2a, compressed-cyclic, compressed-matching} ×
  {plain, overlap} in fp64, complex128 and complex64 at degrees 2, 3, 4
  and 8, and
  the shard group counts ``P·sstep_collectives`` bytes and
  ``sstep_collectives`` calls; it is held to the reference's
  ``make_sstep_cheb`` at 1e-13 of max|Y| (the ROADMAP's whole-filter
  tolerance: no FMA grouping came closer than 2.8e-14).
* ``comm_plan(sstep=s)``, its work factor, collectives and stale-depth
  warning, and ``plan_layout(sstep=(1, 2, 3))`` under ``h100-1card`` and
  the reference's high-α model equal the reference's.
* FD solves of SpinChainXXZ(10,5) at s ∈ {1, 2, 3} (stack 4 × 1, panel
  4 × 2) take the same iterations and return the same eigenvalues bit for
  bit, within 1e-9 of the reference's s = 2 solve (from its draws, one
  ``run_distributed`` subprocess on an Auto-axis mesh, which also computes
  the reference's filters).
* The CLI's ``--spmv-sstep``; ``kpm_moments`` to 1e-12 relative and
  ``kpm_dos`` exactly; ``spmv_sstep < 1`` raises.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import perf_model as ref_pm
from repro.core import planner as ref_planner
from repro.core.chebyshev import kpm_dos as ref_kpm_dos
from repro.core.chebyshev import kpm_moments as ref_kpm_moments
from repro.core.partition import _pattern_csr as ref_pattern_csr
from repro.core.partition import plan_rowmap as ref_plan_rowmap
from repro.core.spmv import build_sstep_ell as ref_build_sstep_ell
from repro.core.spmv import sstep_ghosts as ref_sstep_ghosts
from repro.matrices import get_family as ref_family
from repro_torch import convert
from repro_torch.core import (FDConfig, FilterDiag, ShardGroup,
                              build_dist_ell, build_sstep_ell,
                              chebyshev_filter, chebyshev_filter_sstep,
                              kpm_dos, kpm_moments, make_fused_cheb_step,
                              make_spmv, make_sstep_cheb, scale_params,
                              sstep_ghosts)
from repro_torch.core import perf_model as pm
from repro_torch.core import planner
from repro_torch.launch import solve as cli
from repro_torch.matrices import get_family
from repro_torch.matrices.sparse import CSR
from tests._hypothesis_compat import given, settings, st
from tests.conftest import run_distributed

HUBNET_SMALL = dict(n=4000, w=2, h=4, m=192, k=4)
ROADNET_SMALL = dict(n=4000, w=2, m=256, k=4)
MATS = {"roadnet": ("RoadNet", ROADNET_SMALL),
        "hubnet": ("HubNet", HUBNET_SMALL),
        "spin": ("SpinChainXXZ", dict(n_sites=10, n_up=5)),
        "exciton": ("Exciton", dict(L=2)),
        "hubbard": ("Hubbard", dict(n_sites=6, n_fermions=3)),
        "topins": ("TopIns", dict(Lx=4))}
#: (comm, schedule, overlap) of the engines
ENGINES = [(c, s, ov) for c, s in (("a2a", "cyclic"), ("compressed", "cyclic"),
                                   ("compressed", "matching"))
           for ov in (False, True)]
DEGREES = (2, 3, 4, 8)
FILTER_TOL = 1e-13  # of max|Y|, against the reference's filter
SPIN_FD = dict(n_target=4, n_search=16, target=-0.15, tol=1e-8,
               max_iters=25)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small."""
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


def _rowmap(name, P, kind, s):
    """(reference map, its port copy) planned at P and depth s (None, None
    on equal rows)."""
    if kind == "rows":
        return None, None
    key = (name, P, kind, s)
    if key not in _cache:
        ref_m, _ = _mats(name)
        plan = (dict(balance="commvol") if kind == "commvol"
                else dict(reorder="rcm"))
        rm = ref_plan_rowmap(ref_m, P, sstep=s, **plan)
        _cache[key] = (rm, convert.rowmap_from_arrays(
            rm.D, rm.P, rm.perm, rm.boundaries, rm.R, balance=rm.balance,
            reorder=rm.reorder, sstep=rm.sstep))
    return _cache[key]


def _dtype(name):
    return "complex128" if name in ("exciton", "topins") else None


# ------------------------------------------------------------- ghosts --

def _random_pattern(rng, n, density, P):
    """A random symmetric pattern with its diagonal over the padded
    position space [0, P·R)."""
    a = rng.random((n, n)) < density
    a |= a.T
    np.fill_diagonal(a, True)
    R = -(-n // P)
    counts = np.concatenate([a.sum(axis=1), np.zeros(P * R - n, dtype=int)])
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cols = np.concatenate([np.flatnonzero(a[i]) for i in range(n)])
    return indptr, cols.astype(np.int64), R


def _same_ghosts(mine, ref):
    assert len(mine) == len(ref)
    for (gp, gd), (rp, rd) in zip(mine, ref):
        assert np.array_equal(gp, np.asarray(rp))
        assert np.array_equal(gd, np.asarray(rd))


@settings(max_examples=12)
@given(n=st.integers(8, 48), P=st.integers(2, 4), s=st.integers(1, 3),
       seed=st.integers(0, 10_000))
def test_sstep_ghosts_equal_the_reference_on_random_patterns(n, P, s, seed):
    rng = np.random.default_rng(seed)
    indptr, cols, R = _random_pattern(rng, n, rng.uniform(0.03, 0.25), P)
    _same_ghosts(sstep_ghosts(indptr, cols, P, R, s),
                 ref_sstep_ghosts(indptr, cols, P, R, s))


@pytest.mark.parametrize("name", sorted(MATS))
def test_sstep_ghosts_equal_the_reference_on_every_family(name):
    ref_m, _ = _mats(name)
    indptr, cols = ref_pattern_csr(ref_m)
    P, D = 4, ref_m.D
    R = -(-D // P)
    indptr = np.concatenate([indptr, np.full(P * R - D, indptr[-1])])
    _same_ghosts(sstep_ghosts(indptr, cols, P, R, 3),
                 ref_sstep_ghosts(indptr, cols, P, R, 3))


# ----------------------------------------------------------- operator --

def _assert_same_sstep_ell(mine, ref):
    for f in ("R", "G", "L", "P", "D", "s"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert len(mine.steps) == len(ref.steps) == mine.s
    for (c, v), (rc, rv) in zip(mine.steps, ref.steps):
        assert np.array_equal(c.numpy(), np.asarray(rc))
        assert v.numpy().dtype == np.asarray(rv).dtype
        assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(mine.send_idx.numpy(), np.asarray(ref.send_idx))
    assert np.array_equal(mine.gather_a2a.numpy(), np.asarray(ref.gather_a2a))
    for f in ("n_vc", "pair_counts", "ghost_owner", "ghost_rank"):
        assert np.array_equal(getattr(mine, f), np.asarray(getattr(ref, f))), f
    assert mine.ghost_cum == ref.ghost_cum
    for sch in ("cyclic", "matching"):
        a, b = mine.neighbor_plan(sch), ref.neighbor_plan(sch)
        assert (a.perms, a.round_L, a.H) == (b.perms, b.round_L, b.H)
        assert np.array_equal(a.send_nbr.numpy(), np.asarray(b.send_nbr))
        assert np.array_equal(a.gather.numpy(), np.asarray(b.gather))
    for a, b in zip(mine.split(), ref.split()):
        assert np.array_equal(a.numpy(), np.asarray(b))


SELL_CASES = ([(name, P, s, "rows") for name in ("roadnet", "hubnet", "spin",
                                                 "exciton")
               for P in (2, 4) for s in (1, 2, 3)]
              + [(name, 4, s, kind) for name in ("roadnet", "spin")
                 for kind in ("commvol", "rcm") for s in (1, 2, 3)])


@pytest.mark.parametrize("name,P,s,kind", SELL_CASES,
                         ids=[f"{n}-P{P}-s{s}-{k}" for n, P, s, k in SELL_CASES])
def test_build_sstep_ell_equals_the_reference(name, P, s, kind):
    """Every array of the depth-s operator equals the reference's; the
    converter carries the reference's across unchanged; at s = 1 the
    operator is the port's ``build_dist_ell``."""
    ref_m, m = _mats(name)
    ref_rm, rm = _rowmap(name, P, kind, s)
    ref = ref_build_sstep_ell(ref_m, P, s, dtype=_dtype(name), rowmap=ref_rm)
    mine = build_sstep_ell(m, P, s, dtype=_dtype(name), rowmap=rm,
                           device="cpu")
    _assert_same_sstep_ell(mine, ref)
    carried = convert.sstep_ell_from_arrays(
        ref.steps, send_idx=ref.send_idx, gather_a2a=ref.gather_a2a, R=ref.R,
        D=ref.D, s=ref.s, n_vc=ref.n_vc, pair_counts=ref.pair_counts,
        ghost_cum=ref.ghost_cum, ghost_owner=ref.ghost_owner,
        ghost_rank=ref.ghost_rank, split=ref.split(),
        nbr={sch: ref.neighbor_plan(sch) for sch in ("cyclic", "matching")},
        rowmap=rm, device="cpu")
    _assert_same_sstep_ell(carried, ref)
    assert carried.span == mine.span
    if s == 1:
        want = build_dist_ell(m, P, dtype=_dtype(name), rowmap=rm,
                              device="cpu")
        got = mine.as_dist_ell()
        for f in ("cols", "vals", "send_idx"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in ("R", "L", "P", "D", "D_pad", "span"):
            assert getattr(got, f) == getattr(want, f), f
        assert np.array_equal(got.n_vc, want.n_vc)
        assert np.array_equal(got.pair_counts, want.pair_counts)
    else:
        with pytest.raises(ValueError, match="s == 1"):
            mine.as_dist_ell()


def test_sstep_ell_takes_a_csr_and_refuses_a_bad_depth():
    _, m = _mats("spin")
    csr = m.build_csr()
    assert isinstance(csr, CSR)
    a = build_sstep_ell(csr, 4, 2, device="cpu")
    b = build_sstep_ell(m, 4, 2, device="cpu")
    for (c, v), (rc, rv) in zip(a.steps, b.steps):
        assert torch.equal(c, rc) and torch.equal(v, rv)
    with pytest.raises(ValueError, match="sstep must be >= 1"):
        build_sstep_ell(m, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="requires s >= 2"):
        make_sstep_cheb(build_sstep_ell(m, 4, 1, device="cpu"))


# ------------------------------------------------------------- filter --

FILTER_CASES = {"roadnet-fp64": ("roadnet", "float64"),
                "exciton-c128": ("exciton", "complex128"),
                "exciton-c64": ("exciton", "complex64")}


def _filter_inputs(name, dtype, P=4, nb=5):
    """The s = 1 operator at P shards, a seeded block and the mapped
    interval's alpha, beta."""
    _, m = _mats(name)
    ell = build_dist_ell(m, P, dtype=dtype, split_halo=True, device="cpu")
    rng = np.random.default_rng(11)
    V = rng.standard_normal((ell.D_pad, nb))
    if dtype.startswith("complex"):
        V = V + 1j * rng.standard_normal((ell.D_pad, nb))
    V[ell.D:] = 0
    alpha, beta = scale_params(*m.spectral_bounds_hint())
    return m, ell, torch.from_numpy(V).to(ell.vals.dtype), alpha, beta


def _mu(degree):
    return np.random.default_rng(degree).standard_normal(degree + 1)


def _s1_filter(ell, engine, V, mu, alpha, beta):
    comm, sched, ov = engine
    g = ShardGroup(ell.P, "cpu")
    kw = dict(group=g, use_kernel=True, overlap=ov, comm=comm,
              schedule=sched, pipeline=False)
    return chebyshev_filter(make_spmv(ell, **kw), mu, alpha, beta, V,
                            fused_step=make_fused_cheb_step(ell, **kw))


@pytest.mark.parametrize("engine", ENGINES,
                         ids=[f"{c}-{s}" + ("-ov" if o else "")
                              for c, s, o in ENGINES])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_sstep_filter_equals_the_s1_filter_bitwise(case, s, engine):
    """At degrees 2, 3, 4 and 8 the s-step filter returns the s = 1
    filter's bits; one filter's bytes and calls are ``P·sstep_collectives``
    and ``sstep_collectives`` of the depth-s plan."""
    name, dtype = FILTER_CASES[case]
    m, ell, V, alpha, beta = _filter_inputs(name, dtype)
    comm, sched, ov = engine
    sell = build_sstep_ell(m, ell.P, s, dtype=dtype, split_halo=ov,
                           device="cpu")
    cp = planner.comm_plan(m, ell.P, sstep=s)
    g = ShardGroup(ell.P, "cpu")
    f = make_sstep_cheb(sell, group=g, use_kernel=True, overlap=ov, comm=comm,
                        schedule=sched)
    assert f.kind.endswith(f"+s{s}") and f.group is g
    kind = "all_to_all" if comm == "a2a" else "ppermute"
    for degree in DEGREES:
        mu = _mu(degree)
        want = _s1_filter(ell, engine, V, mu, alpha, beta)
        g.reset_counts()
        got = f(V, mu, alpha, beta)
        assert torch.equal(got, want), degree
        assert not got[ell.D:].any()
        terms = cp.sstep_collectives(comm, sched, V.shape[1],
                                     V.element_size(), degree)
        assert g.bytes[kind] == ell.P * sum(b * c for _, b, c in terms)
        assert g.calls[kind] == sum(c for _, _, c in terms)
        assert sum(g.calls.values()) == g.calls[kind]
    assert not torch.equal(V, torch.zeros_like(V))  # V is not touched


def test_sstep_filter_without_a_halo_equals_the_dia_step():
    """At one shard there is no exchange: the s-step filter's ELL blocks
    give the bits of the s = 1 filter through the DIA step."""
    _, m = _mats("spin")
    ell = build_dist_ell(m, 1, device="cpu")
    V = torch.from_numpy(np.random.default_rng(2).standard_normal((m.D, 3)))
    step = make_fused_cheb_step(ell, use_kernel=True)
    assert step.kind == "dia"
    for s in (2, 3):
        g = ShardGroup(1, "cpu")
        f = make_sstep_cheb(build_sstep_ell(m, 1, s, device="cpu"), group=g,
                            use_kernel=True, comm="compressed")
        for degree in (2, 7):
            want = chebyshev_filter(make_spmv(ell, use_kernel=True), _mu(degree),
                                    0.3, -0.1, V, fused_step=step)
            assert torch.equal(f(V, _mu(degree), 0.3, -0.1), want)
        assert sum(g.bytes.values()) == 0 and sum(g.calls.values()) == 0


def test_sstep_filter_loop_checks_its_groups():
    """``chebyshev_filter_sstep`` splits a degree-n filter into a first
    group of min(s, n) steps and groups of s, the last holding the rest;
    it refuses s = 1 and a degree below 2."""
    calls = []

    def group(n_steps, first, carry, coeffs, emit):
        calls.append((n_steps, first))
        for _ in range(n_steps):
            emit(carry)
        return carry

    V = torch.ones((4, 2), dtype=torch.float64)
    for n, s, want in ((2, 3, [(2, True)]), (7, 3, [(3, True), (3, False),
                                                    (1, False)]),
                       (6, 2, [(2, True), (2, False), (2, False)])):
        calls.clear()
        chebyshev_filter_sstep(group, np.ones(n + 1), 0.5, 0.0, V, s)
        assert calls == want
    with pytest.raises(ValueError, match="s = 1"):
        chebyshev_filter_sstep(group, np.ones(4), 0.5, 0.0, V, 1)
    with pytest.raises(ValueError, match="degree must be >= 2"):
        chebyshev_filter_sstep(group, np.ones(2), 0.5, 0.0, V, 2)


# ---------------------------------------------------------- comm plan --

def _assert_same_sstep_plan(mine, ref):
    want = convert.comm_plan_from_fields(ref)
    for f in ("n_row", "D", "L", "exact", "d_pad", "sstep", "ghost_cum"):
        assert getattr(mine, f) == getattr(want, f), f
    assert np.array_equal(mine.n_vc, want.n_vc)
    assert np.array_equal(mine.pair_counts, want.pair_counts)
    assert mine.level_R == ref.level_R
    assert mine.n_groups(17) == ref.n_groups(17)
    assert mine.sstep_work_factor() == ref.sstep_work_factor()
    for sch in ("cyclic", "matching"):
        assert mine.permute_schedule(sch) == ref.permute_schedule(sch)
        for comm in ("a2a", "compressed"):
            assert mine.sstep_collectives(comm, sch, 16, 8, 17) == \
                ref.sstep_collectives(comm, sch, 16, 8, 17)
            assert mine.rounds_per_exchange(comm, sch) == \
                ref.rounds_per_exchange(comm, sch)


@pytest.mark.parametrize("kind", ["rows", "commvol"])
@pytest.mark.parametrize("name", ["roadnet", "hubnet", "spin"])
def test_sstep_comm_plan_equals_the_reference_and_the_operator(name, kind):
    ref_m, m = _mats(name)
    for s in (2, 3):
        ref_rm, rm = _rowmap(name, 4, kind, s)
        ref = ref_planner.comm_plan(ref_m, 4, sstep=s, rowmap=ref_rm)
        mine = planner.comm_plan(m, 4, sstep=s, rowmap=rm)
        _assert_same_sstep_plan(mine, ref)
        sell = build_sstep_ell(m, 4, s, rowmap=rm, device="cpu")
        assert (mine.L, mine.ghost_cum) == (sell.L, sell.ghost_cum)
        assert np.array_equal(mine.pair_counts, sell.pair_counts)
    one = planner.comm_plan(m, 1, sstep=3)
    assert one.ghost_cum == (0, 0, 0, 0) and one.sstep_collectives(
        "a2a", "cyclic", 4, 8, 9) == ()
    with pytest.raises(ValueError, match="depth-s plan"):
        planner.comm_plan(m, 4).sstep_collectives("a2a", "cyclic", 4, 8, 9)


def test_sstep_comm_plan_warns_on_a_stale_map_as_the_reference():
    """A map planned at depth 1 scored at s = 2 warns in both packages; a
    map planned at depth 2 does not."""
    ref_m, m = _mats("spin")
    ref1, rm1 = _rowmap("spin", 4, "commvol", 1)
    _, rm2 = _rowmap("spin", 4, "commvol", 2)
    with pytest.warns(UserWarning, match="sstep") as mine:
        planner.comm_plan(m, 4, rowmap=rm1, sstep=2)
    with pytest.warns(UserWarning, match="sstep") as ref:
        ref_planner.comm_plan(ref_m, 4, rowmap=ref1, sstep=2)
    assert str(mine[0].message) == str(ref[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        planner.comm_plan(m, 4, rowmap=rm2, sstep=2)
        planner.comm_plan(m, 4, rowmap=rm1)


REF_H100 = ref_pm.MachineModel(
    "h100-1card", b_m=pm.H100_1CARD.b_m, b_c=pm.H100_1CARD.b_c,
    kappa=pm.H100_1CARD.kappa, alpha=pm.H100_1CARD.alpha)
SSTEP_MACHINES = {"h100-1card": REF_H100,
                  "tpu-v5e-highlat": ref_pm.TPU_V5E_HIGHLAT}


@pytest.mark.parametrize("machine", sorted(SSTEP_MACHINES))
@pytest.mark.parametrize("name", ["roadnet", "hubnet", "spin"])
def test_plan_layout_sstep_axis_ranks_as_the_reference(name, machine):
    """The same candidates, ``+s2``/``+s3`` among them, in the same order
    with the same times; the s > 1 ones on equal rows without overlap."""
    ref_m, m = _mats(name)
    kw = dict(n_search=16, d_pad=-(-m.D // 4) * 4, kernel=(False, True),
              sstep=(1, 2, 3))
    ref = ref_planner.plan_layout(ref_m, 4, machine=SSTEP_MACHINES[machine],
                                  **kw)
    mine = planner.plan_layout(
        m, 4, machine=convert.machine_from_fields(SSTEP_MACHINES[machine]),
        **kw)
    want = convert.plan_from_fields(ref)
    assert [c.describe() for c in mine.candidates] == \
        [c.describe() for c in want.candidates]
    for a, b in zip(mine.candidates, want.candidates):
        assert a.sstep == b.sstep
        for f in ("t_iter", "t_pass", "chi_eng"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-300), (f, x, y)
        assert a.comm_bytes_per_device == b.comm_bytes_per_device
    assert mine.report().splitlines()[1:] == ref.report().splitlines()[1:]
    deep = [c for c in mine.candidates if c.sstep > 1]
    assert deep and all(not c.overlap and c.balance == "rows"
                        and c.rowmap is None for c in deep)


# ---------------------------------------------- the reference's filters --

REF_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import FDConfig, FilterDiag, panel
from repro.core.spmv import build_sstep_ell, make_sstep_cheb
from repro.matrices import get_family
d = dict(np.load({inputs!r}))
out = {{}}
for case, (fam, params, dtype, s, comm, sched, ov) in {cells!r}.items():
    m = get_family(fam, **params)
    mesh = jax.make_mesh((4, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    with mesh:
        sell = build_sstep_ell(m, 4, s, dtype=dtype)
        app = make_sstep_cheb(mesh, panel(mesh), sell, comm=comm,
                              schedule=sched, overlap=ov)
        V = d[case + "_V"]
        out[case] = np.asarray(jax.jit(lambda X: app(
            X, d[case + "_mu"], float(d[case + "_ab"][0]),
            float(d[case + "_ab"][1])))(V))
m = get_family("SpinChainXXZ", n_sites=10, n_up=5)
cfg = FDConfig(layout="stack", spmv_sstep=2, **{fd!r})
mesh = jax.make_mesh((4, 1), ("row", "col"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
key = jax.random.PRNGKey(cfg.seed)
with mesh:
    fd = FilterDiag(m, mesh, cfg)
    fd.spmv_stack = jax.jit(fd.spmv_stack)
    k0, k1 = jax.random.split(key)
    out["fd_v0"] = np.asarray(jax.random.normal(k0, (fd.D_pad, 1)))
    out["fd_V0"] = np.asarray(jax.random.normal(k1, (fd.D_pad, cfg.n_search)))
    res = fd.solve(key)
out["fd_eigenvalues"] = res.eigenvalues
out["fd_iterations"] = np.array(res.iterations)
out["fd_n_converged"] = np.array(res.n_converged)
np.savez({path!r}, **out)
print("ok")
"""

#: the reference's filter cells: (family, params, dtype, s, comm,
#: schedule, overlap), each at degree 8 on a seeded block
REF_CELLS = {
    "roadnet-s2-a2a": ("RoadNet", ROADNET_SMALL, None, 2, "a2a", "cyclic",
                       False),
    "roadnet-s3-mat-ov": ("RoadNet", ROADNET_SMALL, None, 3, "compressed",
                          "matching", True),
    "exciton-s3-cmp": ("Exciton", dict(L=2), "complex128", 3, "compressed",
                       "cyclic", False),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("sstep")
    inputs = {}
    for case, (fam, params, dtype, s, *_) in REF_CELLS.items():
        name = "roadnet" if fam == "RoadNet" else "exciton"
        _, _, V, alpha, beta = _filter_inputs(
            name, "complex128" if dtype else "float64")
        inputs[case + "_V"] = V.numpy()
        inputs[case + "_mu"] = _mu(8)
        inputs[case + "_ab"] = np.array([alpha, beta])
    np.savez(str(d / "inputs.npz"), **inputs)
    path = str(d / "ref.npz")
    run_distributed(REF_SCRIPT.format(inputs=str(d / "inputs.npz"),
                                      cells=REF_CELLS, fd=SPIN_FD, path=path),
                    n_devices=8, timeout=900)
    return inputs, dict(np.load(path))


@pytest.mark.parametrize("case", sorted(REF_CELLS))
def test_sstep_filter_is_held_to_the_reference(reference, case):
    inputs, out = reference
    fam, params, dtype, s, comm, sched, ov = REF_CELLS[case]
    m = get_family(fam, **params)
    f = make_sstep_cheb(build_sstep_ell(m, 4, s, dtype=dtype, device="cpu"),
                        use_kernel=True, overlap=ov, comm=comm,
                        schedule=sched)
    alpha, beta = inputs[case + "_ab"]
    got = f(torch.from_numpy(inputs[case + "_V"]), inputs[case + "_mu"],
            float(alpha), float(beta)).numpy()
    want = out[case]
    assert np.abs(got - want).max() <= FILTER_TOL * np.abs(want).max()


# -------------------------------------------------------------- solves --

def test_fd_sstep_solves_equal_the_s1_solve_and_the_reference(reference):
    """SpinChainXXZ(10,5) from the reference's draws: in stack 4 × 1 and
    in panel 4 × 2, s = 2 and 3 take the s = 1 solve's iterations and
    return its eigenvalues bit for bit, all within 1e-9 of the
    reference's s = 2 solve (the stack solves in its iterations); the
    filter's exchanges fall to ceil(degree/s)."""
    _, out = reference
    m = get_family("SpinChainXXZ", n_sites=10, n_up=5)
    results = {}
    for layout, n_row, n_col in (("stack", 4, 1), ("panel", 4, 2)):
        for s in (1, 2, 3):
            cfg = FDConfig(layout=layout, spmv_sstep=s, spmv_kernel=True,
                           spmv_comm="compressed", spmv_overlap=s == 2,
                           **SPIN_FD)
            fd = FilterDiag(m, cfg, device="cpu", n_row=n_row, n_col=n_col)
            assert (fd.sell_panel is None) == (s == 1)
            res = fd.solve(v0=out["fd_v0"], V0=out["fd_V0"])
            results[(layout, s)] = res
            ex = res.exchange
            assert ex["sstep"] == s
            assert ex["filter_engine"].endswith(f"+s{s}") == (s > 1)
            degrees = [h["degree"] for h in res.history if "degree" in h]
            assert ex["filter_exchanges"] == n_col * sum(
                -(-d // s) for d in degrees)
    for (layout, s), res in results.items():
        base = results[(layout, 1)]
        assert res.iterations == base.iterations, (layout, s)
        assert np.array_equal(res.eigenvalues, base.eigenvalues), (layout, s)
        assert res.n_converged >= 4
        np.testing.assert_allclose(np.sort(res.eigenvalues),
                                   np.sort(out["fd_eigenvalues"]), rtol=0,
                                   atol=1e-9)
    assert results[("stack", 2)].iterations == int(out["fd_iterations"])


def test_fd_sstep_auto_plans_the_depth():
    """``layout="auto"`` with ``spmv_sstep=3`` ranks depths 1 and 3 and
    runs the winner's depth; the solve returns the eigenvalues of the
    s = 1 solve of its layout."""
    m = get_family("SpinChainXXZ", n_sites=10, n_up=5)
    cfg = FDConfig(layout="auto", spmv_sstep=3, spmv_kernel=True, **SPIN_FD)
    fd = FilterDiag(m, cfg, device="cpu", n_row=4)
    assert {c.sstep for c in fd.plan.candidates} == {1, 3}
    assert fd.cfg.spmv_sstep == fd.plan.best.sstep
    res = fd.solve()
    assert res.n_converged >= 4


def test_cli_runs_the_sstep_filter(capsys):
    fam, params = MATS["roadnet"]
    base = ["--family", fam,
            "--params", ",".join(f"{k}={v}" for k, v in params.items()),
            "--n-target", "4", "--n-search", "16", "--target", "12.94",
            "--tol", "1e-8", "--max-iters", "40", "--spmv-kernel",
            "--device", "cpu"]
    res = cli.main(base + ["--n-row", "4", "--spmv-comm", "compressed",
                           "--spmv-sstep", "2"], verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4 and "compressed-cyclic+s2 over 4 row" in out
    assert res.exchange["sstep"] == 2
    res = cli.main(base + ["--n-row", "4", "--layout", "auto",
                           "--spmv-sstep", "3"], verbose=False)
    out = capsys.readouterr().out
    assert res.n_converged >= 4 and "+s3(" in out and "spmv_sstep=" in out
    args = cli.build_parser().parse_args(["--family", "Hubbard"])
    assert cli.config_from_args(args).spmv_sstep == 1


@pytest.mark.parametrize("s", [0, -1])
def test_fdconfig_refuses_a_depth_below_one(s):
    m = get_family("SpinChainXXZ", n_sites=6, n_up=3)
    with pytest.raises(ValueError, match="spmv_sstep must be >= 1"):
        FilterDiag(m, FDConfig(spmv_sstep=s), device="cpu", n_row=2)


# ----------------------------------------------------------------- KPM --

@pytest.mark.parametrize("name", ["spin", "exciton"])
def test_kpm_moments_and_dos_equal_the_reference(name):
    """The moments of a seeded block through the port's SpMV and the
    reference's moments through a jnp CSR product of the same operator
    agree to 1e-12 of the largest; the DOS from the same moments is the
    reference's exactly."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    ref_m, m = _mats(name)
    csr = ref_m.build_csr()
    dtype = "complex128" if name == "exciton" else "float64"
    ell = build_dist_ell(m, 1, dtype=dtype, device="cpu")
    rng = np.random.default_rng(3)
    V = rng.standard_normal((m.D, 4)).astype(ell.vals.numpy().dtype)
    alpha, beta = scale_params(*m.spectral_bounds_hint())
    mine = kpm_moments(make_spmv(ell), alpha, beta, torch.from_numpy(V),
                       40).numpy()
    A = jsparse.BCSR((jnp.asarray(csr.data), jnp.asarray(csr.indices),
                      jnp.asarray(csr.indptr)), shape=csr.shape)
    ref = np.asarray(ref_kpm_moments(lambda x: A @ x, alpha, beta,
                                     jnp.asarray(V), 40))
    assert mine.shape == ref.shape == (40,)
    assert np.abs(mine - ref).max() <= 1e-12 * np.abs(ref).max()
    for jackson in (True, False):
        x, rho = kpm_dos(ref, n_bins=64, jackson=jackson)
        rx, rrho = ref_kpm_dos(ref, n_bins=64, jackson=jackson)
        assert np.array_equal(x, rx) and np.array_equal(rho, rrho)
    with pytest.raises(ValueError, match="n_moments >= 2"):
        kpm_moments(make_spmv(ell), alpha, beta, torch.from_numpy(V), 1)
