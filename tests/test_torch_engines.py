"""The eight halo engines of the horizontal layer, port against the JAX
package on the CPU: the SpMV and the fused Chebyshev step of
{a2a, compressed-cyclic, compressed-matching} × {plain, overlap} plus the
round-pipelined compressed engines, on RoadNet(4000) and HubNet(4000)
(their configs' SMOKE matrices) at P = 8 in fp64 and Exciton(L=2) at
P = 4 in complex128 (D = 375, padded to 376), n_b = 5.

The reference runs its engines as its own tests run them: in one
subprocess with 8 fake CPU devices, on an Auto-axis mesh (the default
``make_solver_mesh`` fails under the installed jax), kernels off (the
reference's grid shows kernel-on equal to kernel-off bit for bit). Its
SpMVs are jitted; its fused steps are called on their own, as the
one-shard parity tests call them: under an outer ``jax.jit`` XLA
contracts the step's epilogue ``2a·y + 2b·w1`` into one FMA, called on
their own it rounds each product (ROADMAP, Open items 3), and the port's
kernels follow the latter. The outputs come back through an ``.npz``.
"""
import numpy as np
import pytest
import torch

from repro.core.planner import comm_plan
from repro.matrices import get_family as jget_family

from repro_torch.configs import get_smoke_config
from repro_torch.core import (ShardGroup, build_dist_ell, make_fused_cheb_step,
                              make_spmv)
from repro_torch.matrices import CSR, csr_from_coo, get_family
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


CASES = {
    "roadnet": (*_smoke("roadnet48k"), 8, "float64"),
    "hubnet": (*_smoke("hubnet48k"), 8, "float64"),
    "exciton2": ("Exciton", dict(L=2), 4, "complex128"),
}
#: (comm, schedule, overlap, pipeline) of the eight engines
ENGINES = [("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "cyclic", False, True),
           ("compressed", "cyclic", True, False),
           ("compressed", "cyclic", True, True),
           ("compressed", "matching", False, True),
           ("compressed", "matching", True, False),
           ("compressed", "matching", True, True)]
NB = 5
ALPHA, BETA = 0.37, -0.21


def _key(case, engine):
    comm, sched, ov, pipe = engine
    return f"{case}_{comm}_{sched}_{int(ov)}_{int(pipe)}"


def _inputs(D, D_pad, dtype):
    """x and w2 [D_pad, NB] from a seed, the pad rows zero."""
    rng = np.random.default_rng(D)
    out = []
    for _ in range(2):
        a = rng.standard_normal((D_pad, NB))
        if np.dtype(dtype).kind == "c":
            a = a + 1j * rng.standard_normal((D_pad, NB))
        a[D:] = 0
        out.append(a.astype(dtype))
    return out


REF_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import AxisType
from repro.core import stack
from repro.core.spmv import build_dist_ell, make_fused_cheb_step, make_spmv
from repro.matrices import get_family
CASES, ENGINES, ALPHA, BETA = {cases!r}, {engines!r}, {alpha!r}, {beta!r}
inp = np.load({inputs!r})
out = {{}}
for case, (fam, params, P, dt) in CASES.items():
    m = get_family(fam, **params)
    mesh = jax.make_mesh((P, 1), ("row", "col"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:P])
    ell = build_dist_ell(m, P, dtype=np.dtype(dt), split_halo=True)
    x, w2 = inp[case + "_x"], inp[case + "_w2"]
    with mesh:
        for comm, sched, ov, pipe in ENGINES:
            kw = dict(overlap=ov, comm=comm, schedule=sched, pipeline=pipe)
            f = jax.jit(make_spmv(mesh, stack(mesh), ell, **kw))
            g = make_fused_cheb_step(mesh, stack(mesh), ell, **kw)
            k = f"{{case}}_{{comm}}_{{sched}}_{{int(ov)}}_{{int(pipe)}}"
            out[k + "_y"] = np.asarray(f(x))
            out[k + "_s"] = np.asarray(g(x, w2, ALPHA, BETA))
np.savez({path!r}, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's eight engines on each case, from the port's
    inputs, run once in the 8-device subprocess."""
    d = tmp_path_factory.mktemp("engines")
    inputs = {}
    for case in CASES:
        ell, x, w2 = _port(case)
        inputs[case + "_x"], inputs[case + "_w2"] = x.numpy(), w2.numpy()
    np.savez(d / "inputs.npz", **inputs)
    run_distributed(REF_SCRIPT.format(
        cases=CASES, engines=ENGINES, alpha=ALPHA, beta=BETA,
        inputs=str(d / "inputs.npz"), path=str(d / "ref.npz")),
        n_devices=8, timeout=900)
    return dict(np.load(d / "ref.npz"))


def _pair(case):
    fam, params, P, dt = CASES[case]
    return jget_family(fam, **params), get_family(fam, **params), P, dt


def _port(case):
    _, tm, P, dt = _pair(case)
    ell = build_dist_ell(tm, P, dtype=dt, device="cpu")
    x, w2 = _inputs(tm.D, ell.D_pad, dt)
    return ell, torch.from_numpy(x), torch.from_numpy(w2)


def _predicted(case, comm, sched, ell):
    """Bytes of one SpMV's exchange from the reference planner, summed
    over the P devices."""
    jm, _, P, _ = _pair(case)
    cp = comm_plan(jm, P)
    S = ell.vals.element_size()
    per_device = (cp.a2a_bytes_per_device(NB, S) if comm == "a2a"
                  else cp.permute_bytes_per_device(NB, S, sched))
    return per_device * P


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: _key("", e)[1:])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_equals_reference(reference, case, engine):
    """SpMV and fused step equal the reference's engine with
    ``np.array_equal``, kernels on (their plain versions here) and off;
    the group's bytes of each exchange equal the planner's prediction."""
    comm, sched, ov, pipe = engine
    ell, x, w2 = _port(case)
    k = _key(case, engine)
    want = _predicted(case, comm, sched, ell)
    for use_kernel in (False, True):
        g = ShardGroup(ell.P, "cpu")
        kw = dict(group=g, use_kernel=use_kernel, overlap=ov, comm=comm,
                  schedule=sched, pipeline=pipe)
        y = make_spmv(ell, **kw)(x)
        kind = "all_to_all" if comm == "a2a" else "ppermute"
        assert g.bytes[kind] == want and sum(g.bytes.values()) == want
        s = make_fused_cheb_step(ell, **kw)(x, w2, ALPHA, BETA)
        assert g.bytes[kind] == 2 * want
        assert np.array_equal(y.numpy(), reference[k + "_y"])
        assert np.array_equal(s.numpy(), reference[k + "_s"])


@pytest.mark.parametrize("case", list(CASES))
def test_eight_engines_agree(case):
    """All eight port engines give one result bit for bit, the pad rows
    zero; the compressed engines move no more than the a2a engine."""
    ell, x, w2 = _port(case)
    ys, ss, moved = [], [], {}
    for comm, sched, ov, pipe in ENGINES:
        g = ShardGroup(ell.P, "cpu")
        kw = dict(group=g, use_kernel=True, overlap=ov, comm=comm,
                  schedule=sched, pipeline=pipe)
        ys.append(make_spmv(ell, **kw)(x))
        ss.append(make_fused_cheb_step(ell, **kw)(x, w2, ALPHA, BETA))
        moved[(comm, sched)] = sum(g.bytes.values())
    for y, s in zip(ys[1:], ss[1:]):
        assert torch.equal(y, ys[0]) and torch.equal(s, ss[0])
    assert not ys[0][ell.D:].any() and not ss[0][ell.D:].any()
    assert moved[("compressed", "matching")] <= moved[("compressed", "cyclic")]
    assert moved[("compressed", "cyclic")] <= moved[("a2a", "cyclic")]


def _block_diagonal(D, P):
    """A 1-D Laplacian cut at the equal-rows shard boundaries: no halo."""
    R = -(-D // P)
    r = np.arange(D)
    rows, cols, vals = [r], [r], [np.full(D, 2.0)]
    for off in (-1, 1):
        c = r + off
        ok = (c >= 0) & (c < D) & (c // R == r // R)
        rows.append(r[ok])
        cols.append(c[ok])
        vals.append(np.full(ok.sum(), -1.0))
    return csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (D, D))


def test_zero_halo_operator_moves_nothing_and_takes_the_dia_step():
    """L = 0 at P = 4: every engine moves 0 bytes, and with the kernels on
    the fused step runs per shard in the DIA form, equal bit for bit to
    the ELL step (as the reference dispatches, ``spmv.py:1002-1027``)."""
    A = _block_diagonal(398, 4)
    assert isinstance(A, CSR)
    ell = build_dist_ell(A, 4, device="cpu")
    assert ell.L == 0 and ell.D_pad == 400
    x, w2 = (torch.from_numpy(a) for a in _inputs(398, 400, "float64"))
    want = make_fused_cheb_step(ell)(x, w2, ALPHA, BETA)
    for comm, sched, ov, pipe in ENGINES:
        g = ShardGroup(4, "cpu")
        kw = dict(group=g, overlap=ov, comm=comm, schedule=sched,
                  pipeline=pipe)
        step = make_fused_cheb_step(ell, use_kernel=True, **kw)
        assert step.kind == "dia" and len(step.dia) == 4
        assert torch.equal(step(x, w2, ALPHA, BETA), want)
        y = make_spmv(ell, use_kernel=True, **kw)(x)
        np.testing.assert_allclose(y[:398].numpy(), A.matvec(x[:398].numpy()),
                                   rtol=0, atol=1e-14)
        assert not y[398:].any()
        assert sum(g.bytes.values()) == 0 and sum(g.calls.values()) == 0


def test_p_equal_one_is_the_one_shard_operator():
    """At P = 1 every engine is the one-shard SpMV and step of the first
    slice, and moves nothing; a real operator with a DIA form takes it."""
    fam, params = _smoke("roadnet48k")
    tm = get_family(fam, **params)
    ell = build_dist_ell(tm, 1, device="cpu")
    x, w2 = (torch.from_numpy(a) for a in _inputs(tm.D, tm.D, "float64"))
    outs = []
    for comm, sched, ov, pipe in ENGINES:
        g = ShardGroup(1, "cpu")
        kw = dict(group=g, overlap=ov, comm=comm, schedule=sched,
                  pipeline=pipe)
        outs.append((make_spmv(ell, **kw)(x),
                     make_fused_cheb_step(ell, use_kernel=True, **kw)(
                         x, w2, ALPHA, BETA)))
        assert sum(g.bytes.values()) == 0
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


def test_engine_options_are_checked():
    fam, params = _smoke("roadnet48k")
    ell = build_dist_ell(get_family(fam, **params), 2, device="cpu")
    with pytest.raises(ValueError, match="only applies"):
        make_spmv(ell, comm="a2a", schedule="matching")
    with pytest.raises(ValueError, match="unknown comm"):
        make_spmv(ell, comm="nccl")
    with pytest.raises(ValueError, match="does not hold"):
        make_spmv(ell, group=ShardGroup(4, "cpu"))
