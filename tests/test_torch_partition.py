"""Planned row maps (``core/partition.py``), port against the JAX package
on the CPU: ``plan_rowmap`` array for array, the ``RowMap`` embed/extract
round trip, the mapped ``build_dist_ell`` at the plan level and at a
grouped level, the mapped SpMV and fused step of the a2a and compressed
engines bit for bit, and the Lanczos interval with the map's mask.

The reference runs once, in one subprocess with 8 fake CPU devices on an
Auto-axis mesh (the recipe of ``tests/test_torch_solve_dist.py``), kernels
off; its SpMVs are jitted, its fused steps called on their own (ROADMAP,
Open items 3). The port builds its operators from the reference's maps,
carried across by ``convert.rowmap_from_arrays``, and its inputs are
handed to the reference through an ``.npz``.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import (RowMap, ShardGroup, build_dist_ell,
                              lanczos_interval, make_fused_cheb_step,
                              make_spmv, plan_rowmap)
from repro_torch.core.partition import (PARTITION_PLAN_MAX_P, equal_cuts,
                                        pattern_bandwidth, rcm_permutation)
from repro_torch.matrices import get_family
from tests.conftest import run_distributed


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


MATS = {"roadnet": _smoke("roadnet48k"), "hubnet": _smoke("hubnet48k"),
        "spin": ("SpinChainXXZ", dict(n_sites=10, n_up=5))}
MODES = [("commvol", "none"), ("rows", "rcm"), ("commvol", "rcm")]
PS = [2, 4, 8]
#: the mapped operators: (matrix, balance, reorder, plan P, levels, dtype)
MAPPED = {"roadnet": ("roadnet", "commvol", "rcm", 8, (8, 4, 2), "float64"),
          "spin": ("spin", "rows", "rcm", 4, (4, 2), "float64")}
#: (comm, schedule, overlap, pipeline) of the engines held bit for bit
ENGINES = [("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "cyclic", False, True),
           ("compressed", "matching", True, True)]
NB = 5
ALPHA, BETA = 0.37, -0.21


def _key(*parts):
    return "_".join(str(p) for p in parts)


REF_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.core import stack
from repro.core.lanczos import lanczos_interval
from repro.core.partition import plan_rowmap
from repro.core.spmv import build_dist_ell, make_fused_cheb_step, make_spmv
from repro.matrices import get_family
MATS, MODES, PS, MAPPED = {mats!r}, {modes!r}, {ps!r}, {mapped!r}
ENGINES, ALPHA, BETA = {engines!r}, {alpha!r}, {beta!r}
inp = np.load({inputs!r})
out = {{}}
def key(*parts):
    return "_".join(str(p) for p in parts)
for name, (fam, params) in MATS.items():
    m = get_family(fam, **params)
    for bal, reo in MODES:
        for P in PS:
            rm = plan_rowmap(m, P, balance=bal, reorder=reo)
            k = key(name, bal, reo, P)
            out[k + "_perm"] = rm.perm
            out[k + "_bnd"] = rm.boundaries
            out[k + "_R"] = np.array(rm.R)
for case, (name, bal, reo, P, levels, dt) in MAPPED.items():
    fam, params = MATS[name]
    m = get_family(fam, **params)
    rm = plan_rowmap(m, P, balance=bal, reorder=reo)
    for lvl in levels:
        ell = build_dist_ell(m, lvl, dtype=np.dtype(dt), rowmap=rm)
        for a in ("cols", "vals", "send_idx", "pair_counts", "n_vc"):
            out[key(case, lvl, a)] = np.asarray(getattr(ell, a))
        out[key(case, lvl, "L")] = np.array(ell.L)
    ell = build_dist_ell(m, P, dtype=np.dtype(dt), rowmap=rm,
                         split_halo=True)
    mesh = jax.make_mesh((P, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:P])
    x, w2 = inp[case + "_x"], inp[case + "_w2"]
    with mesh:
        for comm, sched, ov, pipe in ENGINES:
            kw = dict(overlap=ov, comm=comm, schedule=sched, pipeline=pipe)
            f = jax.jit(make_spmv(mesh, stack(mesh), ell, **kw))
            g = make_fused_cheb_step(mesh, stack(mesh), ell, **kw)
            k = key(case, comm, sched, int(ov), int(pipe))
            out[k + "_y"] = np.asarray(f(x))
            out[k + "_s"] = np.asarray(g(x, w2, ALPHA, BETA))
        lk = jax.random.PRNGKey(3)
        spmv = jax.jit(make_spmv(mesh, stack(mesh), ell))
        lam = lanczos_interval(spmv, m.D, rm.D_pad, np.dtype(dt), lk, 30,
                               mask=jnp.asarray(rm.valid_mask()))
        out[case + "_lam"] = np.array(lam)
        out[case + "_v0"] = np.asarray(jax.random.normal(lk, (rm.D_pad, 1)))
np.savez({path!r}, **out)
print("ok")
"""


def _family(name):
    fam, params = MATS[name]
    return get_family(fam, **params)


def _ref_map(reference, name, bal, reo, P) -> RowMap:
    """The reference's map, carried across."""
    k = _key(name, bal, reo, P)
    return convert.rowmap_from_arrays(
        _family(name).D, P, reference[k + "_perm"], reference[k + "_bnd"],
        int(reference[k + "_R"]), balance=bal, reorder=reo)


def _inputs(rm: RowMap, dtype):
    """x and w2 [D_pad, NB] in position space from a seed, the pad
    positions zero."""
    rng = np.random.default_rng(rm.D)
    return [rm.embed(rng.standard_normal((rm.D, NB))).astype(dtype)
            for _ in range(2)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's maps, mapped operators, engines and Lanczos
    interval, from the port's inputs (made on the port's own maps), run
    once in the 8-device subprocess."""
    d = tmp_path_factory.mktemp("partition")
    inputs = {}
    for case, (name, bal, reo, P, _, dt) in MAPPED.items():
        rm = plan_rowmap(_family(name), P, balance=bal, reorder=reo)
        inputs[case + "_x"], inputs[case + "_w2"] = _inputs(rm, dt)
    np.savez(d / "inputs.npz", **inputs)
    run_distributed(REF_SCRIPT.format(
        mats=MATS, modes=MODES, ps=PS, mapped=MAPPED, engines=ENGINES,
        alpha=ALPHA, beta=BETA, inputs=str(d / "inputs.npz"),
        path=str(d / "ref.npz")), n_devices=8, timeout=900)
    return dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: "+".join(m))
@pytest.mark.parametrize("name", list(MATS))
def test_plan_rowmap_matches_reference(reference, name, mode, P):
    """The port's ``plan_rowmap`` equals the reference's: perm,
    boundaries, R and D_pad."""
    bal, reo = mode
    rm = plan_rowmap(_family(name), P, balance=bal, reorder=reo)
    want = _ref_map(reference, name, bal, reo, P)
    assert np.array_equal(rm.perm, want.perm)
    assert np.array_equal(rm.boundaries, want.boundaries)
    assert (rm.R, rm.D_pad) == (want.R, want.D_pad)
    assert rm.is_bijection()


def test_planned_maps_are_real_maps():
    """The maps the parity tests build on are not the equal-rows path:
    RoadNet's commvol cuts and RCM order, SpinChain's RCM order; RCM
    narrows RoadNet's bandwidth."""
    m = _family("roadnet")
    rm = plan_rowmap(m, 8, balance="commvol", reorder="rcm")
    assert not rm.identity and rm.D_pad > m.D
    assert not np.array_equal(rm.boundaries, equal_cuts(m.D, 8))
    assert not plan_rowmap(_family("spin"), 4, reorder="rcm").identity
    perm = rcm_permutation(m)
    assert pattern_bandwidth(m, perm) < pattern_bandwidth(m)


@pytest.mark.parametrize("name,bal,reo,P", [
    ("roadnet", "commvol", "rcm", 8), ("hubnet", "commvol", "none", 8),
    ("spin", "rows", "rcm", 4)])
def test_embed_extract_round_trip(name, bal, reo, P):
    """``extract(embed(X))`` is X bit for bit, the pads are exact zeros,
    and a grouped level's block sizes add up to the rows."""
    rm = plan_rowmap(_family(name), P, balance=bal, reorder=reo)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((rm.D, 3)) + 1j * rng.standard_normal((rm.D, 3))
    E = rm.embed(X)
    assert E.shape == (rm.D_pad, 3)
    assert np.array_equal(rm.extract(E), X)
    assert not E[~rm.valid_mask()].any()
    assert rm.block_sizes(2).sum() == rm.D == rm.block_sizes().sum()


@pytest.mark.parametrize("case,level", [
    (case, lvl) for case, spec in MAPPED.items() for lvl in spec[4]])
def test_mapped_dist_ell_matches_reference(reference, case, level):
    """The mapped operator at the plan level and at grouped levels,
    array for array: cols, vals, send_idx, pair_counts, n_vc and L; and
    the operator carried across from those arrays (``convert``) is the
    same, its span included."""
    name, bal, reo, P, _, dt = MAPPED[case]
    rm = _ref_map(reference, name, bal, reo, P)
    ell = build_dist_ell(_family(name), level, dtype=dt, rowmap=rm,
                         device="cpu")
    assert ell.rowmap is rm and ell.D_pad == rm.D_pad
    for a in ("cols", "vals", "send_idx", "pair_counts", "n_vc"):
        got = getattr(ell, a)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(got, reference[_key(case, level, a)]), a
    assert ell.L == int(reference[_key(case, level, "L")])
    back = convert.dist_ell_from_arrays(
        reference[_key(case, level, "cols")],
        reference[_key(case, level, "vals")], rm.D,
        send_idx=reference[_key(case, level, "send_idx")],
        pair_counts=reference[_key(case, level, "pair_counts")],
        n_vc=reference[_key(case, level, "n_vc")], rowmap=rm, device="cpu")
    assert back.span == ell.span and back.rowmap is rm


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: _key(*e))
@pytest.mark.parametrize("case", list(MAPPED))
def test_mapped_spmv_and_step_bitwise(reference, case, engine):
    """SpMV and fused step of the mapped operator equal the reference's
    engine with ``np.array_equal``, kernels on (their plain versions
    here) and off; the pad positions stay zero."""
    name, bal, reo, P, _, dt = MAPPED[case]
    comm, sched, ov, pipe = engine
    rm = _ref_map(reference, name, bal, reo, P)
    ell = build_dist_ell(_family(name), P, dtype=dt, rowmap=rm,
                         device="cpu")
    x, w2 = (torch.from_numpy(a) for a in _inputs(rm, dt))
    k = _key(case, comm, sched, int(ov), int(pipe))
    for use_kernel in (False, True):
        kw = dict(group=ShardGroup(P, "cpu"), use_kernel=use_kernel,
                  overlap=ov, comm=comm, schedule=sched, pipeline=pipe)
        y = make_spmv(ell, **kw)(x)
        s = make_fused_cheb_step(ell, **kw)(x, w2, ALPHA, BETA)
        assert np.array_equal(y.numpy(), reference[k + "_y"])
        assert np.array_equal(s.numpy(), reference[k + "_s"])
        pad = torch.from_numpy(~rm.valid_mask())
        assert not y[pad].any() and not s[pad].any()


@pytest.mark.parametrize("case", list(MAPPED))
def test_lanczos_interval_with_the_mask(reference, case):
    """``lanczos_interval`` on the mapped operator, from the reference's
    start vector and with the map's mask, equals the reference's interval
    to 1e-12."""
    name, bal, reo, P, _, dt = MAPPED[case]
    rm = _ref_map(reference, name, bal, reo, P)
    ell = build_dist_ell(_family(name), P, dtype=dt, rowmap=rm,
                         device="cpu")
    lam = lanczos_interval(make_spmv(ell), rm.D, ell.vals.dtype, "cpu",
                           v0=reference[case + "_v0"], steps=30,
                           D_pad=rm.D_pad, mask=rm.valid_mask())
    np.testing.assert_allclose(lam, reference[case + "_lam"], rtol=0,
                               atol=1e-12)


def test_identity_map_is_the_equal_rows_operator():
    """The identity map (``RowMap.rows``) builds the equal-rows operator
    at its D_pad, array for array."""
    m = _family("spin")
    rm = RowMap.rows(m.D, 4, d_pad=256)
    a = build_dist_ell(m, 4, rowmap=rm, device="cpu")
    b = build_dist_ell(m, 4, d_pad=256, device="cpu")
    assert rm.identity and a.D_pad == b.D_pad == 256
    for f in ("cols", "vals", "send_idx"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="conflicts"):
        build_dist_ell(m, 4, rowmap=rm, d_pad=260, device="cpu")


def test_sampled_planning_plans_the_references_map():
    """``plan_mode="sampled"`` plans the reference's sampled commvol map
    (``core/sketch.py``); ``"auto"`` samples above the exact planner's
    gate and is the exact plan below it."""
    from repro.core.partition import plan_rowmap as ref_plan_rowmap
    from repro.matrices import get_family as ref_family

    fam, params = MATS["roadnet"]
    m, ref_m = _family("roadnet"), ref_family(fam, **params)
    for P, mode in ((8, "sampled"), (2 * PARTITION_PLAN_MAX_P, "auto")):
        mine = plan_rowmap(m, P, balance="commvol", plan_mode=mode)
        want = ref_plan_rowmap(ref_m, P, balance="commvol", plan_mode=mode)
        assert np.array_equal(mine.boundaries, want.boundaries)
        assert mine.R == want.R and mine.is_bijection()
    assert np.array_equal(
        mine.boundaries, plan_rowmap(m, 2 * PARTITION_PLAN_MAX_P,
                                     balance="commvol",
                                     plan_mode="sampled").boundaries)
    auto = plan_rowmap(m, 8, balance="commvol", plan_mode="auto")
    exact = plan_rowmap(m, 8, balance="commvol", plan_mode="exact")
    assert np.array_equal(auto.boundaries, exact.boundaries)
