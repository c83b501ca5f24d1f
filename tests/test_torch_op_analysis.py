"""The op census (``repro_torch.launch.op_analysis``) and the roofline on
the CPU.

* a small chain, counted by hand: flops of the dot-like ops only, bytes of
  each op's operands and results, views and allocations skipped, an
  ``out=`` tensor a result only, the shard groups' collectives;
* the forward loss of a SMOKE config: the port's counted flops against
  the reference's ``analyze_hlo(...).flops`` of the same forward compiled
  on the CPU — equal (tolerance 0: both count 2·|result|·|contraction| of
  the same products);
* a kernel call is one op with the bytes of its bound (``PERF.md`` §6:
  the operator as the kernel reads it, x, w1, w2 where it takes them, y)
  and 2·nnz·n_b flops, whatever runs inside it: a one-shard Hubbard(6,3)
  fused step through ``cheb_dia``, and the P-shard ELL engine whose plain
  version stands for the one kernel launch of all P shards.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core.shards import ShardGroup
from repro_torch.core.spmv import build_dist_ell, make_fused_cheb_step
from repro_torch.kernels import ops, plan, ref
from repro_torch.launch import roofline
from repro_torch.launch.op_analysis import OpCensus, count_ops
from repro_torch.matrices import Hubbard, RoadNet
from repro_torch.models import steps
from repro_torch.models import transformer as tfm


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hand_counted_chain():
    a = torch.randn(8, 16, dtype=torch.float64)
    b = torch.randn(16, 4, dtype=torch.float64)
    bias = torch.randn(4, dtype=torch.float64)
    batch = torch.randn(3, 4, 5, dtype=torch.float32)
    g = ShardGroup(2, "cpu")

    def chain():
        c = a @ b                          # mm: 2·8·4·16 flops
        d = torch.addmm(bias, a, b)        # addmm: the same flops
        _ = c.t().reshape(-1)              # a view, then a copy of 32
        e = torch.relu(c)
        e.add_(d)                          # in place: reads e, d, writes e
        f = torch.empty_like(e)            # an allocation: no traffic
        f.copy_(e)                         # writes f without reading it
        torch.bmm(batch, batch.transpose(1, 2))  # 2·3·4·4·5 flops
        out = torch.empty(8, dtype=torch.float64)
        torch.sum(e, dim=1, out=out)       # out= a result only
        g.psum([e[:4], e[4:]])             # one all-reduce of 2 parts
        return out

    _, c = count_ops(chain, groups=(g,))
    S8, S4 = 8, 4
    n_mm = (8 * 16 + 16 * 4 + 8 * 4) * S8
    want_bytes = (n_mm                                  # mm
                  + n_mm + 4 * S8                       # addmm
                  + 2 * 32 * S8                         # the reshape's copy
                  + 2 * 32 * S8                         # relu
                  + 3 * 32 * S8                         # add_
                  + 2 * 32 * S8                         # copy_
                  + (2 * 60 + 48) * S4                  # bmm
                  + (32 + 8) * S8                       # sum(out=)
                  + (16 + 16 + 16) * S8)                # psum's add
    assert c.flops == 2 * (2 * 8 * 4 * 16) + 2 * 3 * 4 * 4 * 5
    assert c.hbm_bytes == want_bytes
    assert c.coll_breakdown["psum"] == 32 * S8 and c.coll_bytes == 32 * S8
    assert c.per_collective == [("psum", 32.0 * S8, 1)]
    assert c.kernels == {}


def test_census_is_read_after_its_window():
    census = OpCensus()
    with pytest.raises(RuntimeError):
        census.costs()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_forward_flops_equal_the_reference_hlo_count(arch):
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    B, S = 2, 64
    params = ref_tfm.init_params(rcfg, jax.random.PRNGKey(0))
    batch = ref_steps.make_batch(rcfg, B, S)
    hlo = jax.jit(lambda p, bb: ref_tfm.loss_fn(p, rcfg, bb)[0]).lower(
        params, batch).compile().as_text()
    want = analyze_hlo(hlo).flops
    model = lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    pbatch = steps.make_batch(cfg, B, S, device="cpu")
    with torch.no_grad():
        _, c = count_ops(lambda: tfm.loss_fn(model, cfg, pbatch))
    assert want > 0 and c.flops == want


def _hubbard_step(kernel_plain=None):
    """One fused step of the one-shard Hubbard(6,3) operator through the
    DIA route, counted."""
    A = Hubbard(6, 3, U=4.0, ranpot=1.0).build_csr()
    ell = build_dist_ell(A, 1, dtype="float64", device="cpu")
    step = make_fused_cheb_step(ell, use_kernel=True)
    assert step.kind == "dia"
    gen = torch.Generator().manual_seed(0)
    w1, w2 = (torch.randn((ell.R, 16), generator=gen, dtype=torch.float64)
              for _ in range(2))
    y, c = count_ops(step, w1, w2, 0.3, -0.1)
    return step.dia[0], w1, y, c


def test_a_dia_step_is_one_cheb_dia_op_with_its_bound_bytes(monkeypatch):
    dia, w1, y, c = _hubbard_step()
    cp = dia.compact
    R, nb, S = cp.R, w1.shape[1], w1.element_size()
    # PERF.md §6's bound: x (= w1), w2 and y once, the compact operator once
    want = 3 * R * nb * S + cp.bytes_per_row * R
    assert c.kernels == {"cheb_dia": {"calls": 1, "bytes": want,
                                      "flops": 2.0 * cp.nnz * nb}}
    # the same count whatever runs inside the call: a plain version of
    # other ops (here the step spelled with a dense product) counts the same
    calls, plain = [], ref.cheb_dia_ref

    def other_plain(offsets, dvals, x, w1_, w2_, alpha, beta):
        calls.append(1)
        A = torch.zeros((R, R), dtype=dvals.dtype)
        for d, off in enumerate(offsets):
            A += torch.diag(dvals[d][:R - off] if off >= 0 else
                            dvals[d][-off:], off)
        return plain(offsets, dvals, x, w1_, w2_, alpha, beta)

    monkeypatch.setattr(ref, "cheb_dia_ref", other_plain)
    _, _, y2, c2 = _hubbard_step()
    assert calls and torch.equal(y2, y)
    assert (c2.kernels, c2.hbm_bytes, c2.flops, c2.ops) == \
        (c.kernels, c.hbm_bytes, c.flops, c.ops)


def test_the_plain_engine_stands_for_the_kernel_launches():
    """With the kernels on, the P-shard ELL engine's plain version on the
    CPU counts as the one kernel launch the card makes for all P shards,
    with the bound bytes of the shards' stacked form; with them off its
    ops are counted instead."""
    A = RoadNet(n=4000, w=2, m=256, k=4).build_csr()
    ell = build_dist_ell(A, 4, dtype="float64", device="cpu")
    gen = torch.Generator().manual_seed(0)
    w1, w2 = (torch.randn((ell.P * ell.R, 8), generator=gen,
                          dtype=torch.float64) for _ in range(2))
    step = make_fused_cheb_step(ell, group=ShardGroup(4, "cpu"),
                                use_kernel=True, comm="a2a")
    assert step.kind != "dia"
    y, c = count_ops(step, w1, w2, 0.3, -0.1, groups=(step.group,))
    k = c.kernels["ell_gather_cheb"]
    assert k["calls"] == 1
    Rx = ell.R + ell.P * ell.L  # each shard's [x_p ‖ halo]
    cpe = plan.compact_ell_grouped(ell.cols, ell.vals)
    want = ops.ell_cost(ell.cols, ell.vals, Rx, 8, True, cpe)[1]
    assert want == (plan.ell_bytes_per_row(cpe) * ell.P * ell.R
                    + ell.P * (Rx + 3 * ell.R) * 8 * 8)
    assert k["bytes"] == want
    assert c.coll_breakdown["all_to_all"] == ell.P * ell.P * ell.L * 8 * 8
    off = make_fused_cheb_step(ell, group=ShardGroup(4, "cpu"),
                               use_kernel=False, comm="a2a")
    y_off, c_off = count_ops(off, w1, w2, 0.3, -0.1)
    assert torch.equal(y_off, y) and c_off.kernels == {}
    assert c_off.ops > c.ops


def test_roofline_terms_on_the_h100():
    c = count_ops(lambda: torch.ones(4) @ torch.ones(4))[1]
    r = roofline.analyze(c, 8.0, 1, dtype="float32")
    assert r.t_compute == c.flops / 67e12
    assert r.t_memory == c.hbm_bytes / 3.35e12
    assert r.t_collective == 0.0
    row = roofline.Roofline(1e12, 3.35e9, None, None, 2e12, 2).row()
    assert row["t_compute_s"] == 1e12 / 989e12
    assert row["t_collective_s"] is None and row["dominant"] == "compute"
    assert row["useful_flops_ratio"] == 1.0
