"""The grouped ELL launch on the CPU: one launch of the ELL kernel for a
block of all P row shards (``kernels/ell_gather.py::EllLaunch``).

The kernel runs only on the card; here its host side is held to the
engines it serves:

* the stacked padding-free form (``plan.compact_ell_grouped``) is the
  shards' own forms joined: row pointers, entries, ``max_row``, and
  ``tile_max`` taken over tiles inside the shards;
* its plain version (``ref.ell_grouped_ref``), which walks the stacked
  form with the shard strides the kernel takes, is bit-equal to the
  engines' plain contraction (``core/spmv.py::_contract_plain``) and to
  ``ref.ell_spmv_acc_ref`` shard by shard, with and without the
  Chebyshev epilogue, on the exact views each engine passes: the full,
  split-phase and round-pipelined modes of the s = 1 engines and the
  s-step groups (step 0 whole or split, the later steps);
* an op census counts each phase as one launch with the stacked form's
  bound bytes, on the CPU as on the card, the epilogue's w1 once with x
  when it is x's leading rows.

RoadNet(4000) and HubNet(4000) (their configs' SMOKE matrices) at
P ∈ {1, 4}, in fp64 and complex128 (the operator's entries turned by
seeded phases), n_b ∈ {1, 8, 37}.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (ShardGroup, build_dist_ell, build_sstep_ell,
                              make_fused_cheb_step, make_spmv,
                              make_sstep_cheb)
from repro_torch.core import spmv as spmv_mod
from repro_torch.kernels import ops, plan, ref
from repro_torch.launch.op_analysis import count_ops
from repro_torch.matrices import HubNet, RoadNet

FAMILIES = {"roadnet": lambda: RoadNet(n=4000, w=2, m=256, k=4),
            "hubnet": lambda: HubNet(n=4000, w=2, h=4, m=192, k=4)}
DTYPES = {"float64": torch.float64, "complex128": torch.complex128}

#: (comm, schedule, overlap, pipeline): full, split-phase and
#: round-pipelined modes over both exchanges
ENGINES = (("a2a", "cyclic", False, True), ("a2a", "cyclic", True, True),
           ("compressed", "matching", False, True),
           ("compressed", "cyclic", True, False),
           ("compressed", "cyclic", True, True))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the blocks here are small, so more threads
    only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _turn(vals: torch.Tensor, seed: int) -> None:
    """Turn each entry of a complex ``vals`` by a seeded phase, in place
    (the zero pattern is kept)."""
    if vals.is_complex():
        theta = np.random.default_rng(seed).uniform(0, 2 * np.pi, vals.shape)
        vals.mul_(torch.as_tensor(np.exp(1j * theta), dtype=vals.dtype))


def _randn(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype)


def _ell(fam: str, P: int, dtype: str, **kw):
    ell = build_dist_ell(FAMILIES[fam](), P, dtype=dtype, device="cpu", **kw)
    _turn(ell.vals, P)
    return ell


def _per_shard(blk, x, y0, epilogue):
    """``ref.ell_spmv_acc_ref`` (and its epilogue) shard by shard."""
    out = []
    for p in range(blk.cols.shape[0]):
        acc = (y0[p] if y0 is not None else torch.zeros(
            (blk.cols.shape[1], x.shape[2]), dtype=x.dtype))
        y = ref.ell_spmv_acc_ref(acc, blk.cols[p], blk.vals[p], x[p])
        if epilogue is not None:
            w1, w2, a, b = epilogue
            y = ref.cheb_epilogue(y, w1[p], w2[p], a, b)
        out.append(y)
    return torch.stack(out)


@pytest.fixture
def checked(monkeypatch):
    """Every phase the engines contract, its grouped plain version and
    its per-shard one held bit-equal to the engines' result on the same
    views; yields the list of ``(x view, y0, epilogue?)`` seen."""
    seen = []
    plain = spmv_mod._contract_plain

    def contract(blk, x, y0, epilogue, as_kernel=False):
        got = plain(blk, x, y0, epilogue, as_kernel)
        cp = plan.compact_ell_grouped(blk.cols, blk.vals)
        grouped = ref.ell_grouped_ref(cp, x, y0, epilogue)
        assert torch.equal(grouped, got)
        assert torch.equal(_per_shard(blk, x, y0, epilogue), got)
        seen.append((x, y0, epilogue is not None))
        return got

    monkeypatch.setattr(spmv_mod, "_contract_plain", contract)
    yield seen


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_stacked_form_is_the_shards_forms_joined(fam, P, dtype):
    ell = _ell(fam, P, dtype)
    blocks = [(ell.cols, ell.vals)]
    if P > 1:
        cl, vl, ch, vh = ell.split()
        blocks += [(cl, vl), (ch, vh)]
    for cols, vals in blocks:
        cp = plan.compact_ell_grouped(cols, vals)
        per = [plan.compact_ell(cols[p], vals[p]) for p in range(P)]
        R = cols.shape[1]
        assert (cp.P, cp.R) == (P, R)
        base = 0
        rowptr = [torch.zeros(1, dtype=torch.int32)]
        for c in per:
            rowptr.append(c.rowptr[1:] + base)
            base += c.cols.numel()
        assert torch.equal(cp.rowptr, torch.cat(rowptr))
        assert torch.equal(cp.cols, torch.cat([c.cols for c in per]))
        assert torch.equal(cp.vals, torch.cat([c.vals for c in per]))
        assert cp.max_row == max(c.max_row for c in per)
        assert cp.x_rows == max(c.x_rows for c in per)
        # the tiles lie inside the shards
        assert cp.tile_max == max(c.tile_max for c in per)
        assert cp.tile_max <= plan.ELL_TILE_ROWS * cp.max_row


def test_tile_max_stays_inside_the_shards():
    """Shard 0's last rows and shard 1's first rows hold the entries: a
    tile across the shards' seam would count both, the kernel's tiles
    count one side."""
    R, W = 300, 4
    cols = torch.zeros((2, R, W), dtype=torch.int32)
    vals = torch.zeros((2, R, W), dtype=torch.float64)
    vals[0, 256:, :] = 1.0  # 44 rows × 4 at the end of shard 0's 2nd tile
    vals[1, :40, :] = 1.0   # 40 rows × 4 at the start of shard 1
    cp = plan.compact_ell_grouped(cols, vals)
    assert cp.tile_max == 44 * W
    # the same rows stacked as one block of 600 rows put both in one tile
    one = plan.compact_ell(cols.reshape(2 * R, W), vals.reshape(2 * R, W))
    assert one.tile_max == (44 + 40) * W


@pytest.mark.parametrize("nb", [1, 8, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_grouped_plain_version_on_the_engines_views(checked, fam, P, dtype,
                                                    nb):
    """The s = 1 engines' SpMV and fused step, kernels on: every phase's
    grouped plain version equals the engines' own and the per-shard one;
    the round-pipelined engine passes the prefix of its halo buffer, a
    strided view."""
    ell = _ell(fam, P, dtype, split_halo=True)
    rng = np.random.default_rng(nb)
    tdt = DTYPES[dtype]
    x, w2 = (_randn(rng, (ell.D_pad, nb), tdt) for _ in range(2))
    for comm, sched, ov, pipe in ENGINES:
        kw = dict(use_kernel=True, overlap=ov, comm=comm, schedule=sched,
                  pipeline=pipe)
        make_spmv(ell, group=ShardGroup(P, "cpu"), **kw)(x)
        make_fused_cheb_step(ell, group=ShardGroup(P, "cpu"), **kw)(
            x, w2, 0.21, -0.33)
    assert any(epi for _, _, epi in checked)
    if P > 1:  # a second phase threads the first one's accumulator
        assert any(y0 is not None for _, y0, _ in checked)
        assert any(not xv.is_contiguous() for xv, _, _ in checked)


@pytest.mark.parametrize("nb", [1, 8, 37])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_grouped_plain_version_on_the_sstep_views(checked, fam, P, dtype,
                                                  nb):
    """The s = 2 filter, kernels on, step 0 whole and split (its local
    prefix on the owned rows of the extended block ``w1e[:, :R]``, then
    the rest on the whole block, threaded through ``y``), over two
    groups: every phase's grouped plain version equals the engines' own
    and the per-shard one."""
    sell = build_sstep_ell(FAMILIES[fam](), P, 2, dtype=dtype,
                           split_halo=True, device="cpu")
    for i, (_, vals) in enumerate(sell.steps):
        _turn(vals, P + i)
    rng = np.random.default_rng(nb)
    V = _randn(rng, (sell.P * sell.R, nb), DTYPES[dtype])
    mu = np.linspace(1.0, 0.5, 5)  # degree 4: two groups of two steps
    for ov in (False, True):
        make_sstep_cheb(sell, group=ShardGroup(P, "cpu"), use_kernel=True,
                        overlap=ov, comm="compressed")(V, mu, 0.07, -0.2)
    assert any(epi for _, _, epi in checked)
    if P > 1:
        assert any(not xv.is_contiguous() for xv, _, _ in checked)


@pytest.mark.parametrize("P", [1, 4])
def test_one_phase_is_one_launch_in_the_census(P):
    """With the kernels on, each phase is one launch for all P shards:
    the split-phase fused step counts one ``ell_gather`` (the local
    block) and one ``ell_gather_cheb`` (the halo block with the epilogue,
    from the local block's accumulator), each with the stacked form's
    bound bytes; one shard has no halo block, and its local block carries
    the epilogue, whose w1 is that block's x, read once."""
    ell = _ell("roadnet", P, "float64", split_halo=True)
    rng = np.random.default_rng(0)
    w1, w2 = (_randn(rng, (ell.D_pad, 8), torch.float64) for _ in range(2))
    step = make_fused_cheb_step(ell, group=ShardGroup(P, "cpu"),
                                use_kernel=True, overlap=True, comm="a2a")
    assert step.kind == "a2a-overlap"
    _, c = count_ops(step, w1, w2, 0.3, -0.1, groups=(step.group,))
    cl, vl, ch, vh = ell.split()
    H = ell.P * ell.L
    # (block, its x rows, the epilogue, a y0, w1 is x): the halo block
    # threads the local block's accumulator
    blocks = {"ell_gather": (cl, vl, ell.R, False, False, False),
              "ell_gather_cheb": (ch, vh, H, True, True, False)}
    if P == 1:
        assert H == 0
        blocks = {"ell_gather_cheb": (cl, vl, ell.R, True, False, True)}
    assert set(c.kernels) == set(blocks)
    for name, (cols, vals, x_rows, epi, y0, same) in blocks.items():
        cp = plan.compact_ell_grouped(cols, vals)
        want = ops.ell_cost(cols, vals, x_rows, 8, epi, cp, y0, same)
        assert want[0] == name
        assert c.kernels[name]["calls"] == 1
        assert c.kernels[name]["bytes"] == want[1]
        epi_blocks = (1 if same else 2) if epi else 0
        assert want[1] == (plan.ell_bytes_per_row(cp) * P * ell.R
                           + (P * x_rows + (1 + epi_blocks + y0) * P * ell.R)
                           * 8 * 8)


@pytest.mark.parametrize("w1_of", ["x's leading rows", "a copy",
                                   "x a row on", "x's start, packed"])
def test_w1_that_is_x_is_counted_once(w1_of):
    """The census counts the epilogue's w1 once with x when it is x's
    leading rows (the s-step filter's step reads ``w1e`` for both), and on
    its own otherwise: a copy, a view that starts elsewhere, or one that
    starts with x but has another shard stride."""
    P, R, Rx, W, nb = 4, 40, 52, 3, 8
    rng = np.random.default_rng(1)
    cols = torch.as_tensor(rng.integers(0, Rx, (P, R, W)), dtype=torch.int32)
    vals = _randn(rng, (P, R, W), torch.float64)
    x = _randn(rng, (P, Rx, nb), torch.float64)
    w2 = _randn(rng, (P, R, nb), torch.float64)
    w1 = {"x's leading rows": x[:, :R], "a copy": x[:, :R].clone(),
          "x a row on": x[:, 1:R + 1],
          "x's start, packed": x.view(-1)[:P * R * nb].view(P, R, nb)}[w1_of]
    blk = spmv_mod._Block(cols, vals, None)
    _, c = count_ops(lambda: spmv_mod._contract_plain(
        blk, x, None, (w1, w2, 0.3, -0.1), as_kernel=True))
    same = w1_of == "x's leading rows"
    assert ops.leads(w1, x) == same
    k = c.kernels["ell_gather_cheb"]
    cp = plan.compact_ell_grouped(cols, vals)
    assert k["calls"] == 1
    assert k["bytes"] == (plan.ell_bytes_per_row(cp) * P * R
                          + (P * Rx + (2 if same else 3) * P * R) * nb * 8)
