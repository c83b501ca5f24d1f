"""The vertical layer's layouts and the stack↔panel redistribution on the
CPU: ``to_panel``/``to_stack`` for every split of 8 shards and both
implementations, their byte count against Eqs. 17–18 (the reference's
formula), the filter of every bundle of a panel or pillar block against
the same filter at full width, and the layouts on a grid.
"""
import numpy as np
import pytest
import torch

from repro.core.redistribute import redistribution_volume as jredistribution_volume

from repro_torch.configs import get_smoke_config
from repro_torch.core import (FDConfig, FilterDiag, Layout, ShardGroup,
                              build_dist_ell, build_filter, chebyshev_filter,
                              layout_on_grid, make_fused_cheb_step,
                              make_redistribute, make_spmv, plan_rowmap,
                              redistribution_volume, scale_params)
from repro_torch.matrices import get_family

SPLITS_OF_8 = [(8, 1), (4, 2), (2, 4), (1, 8)]
IMPLS = ["explicit", "gspmd"]
N_S = 16


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


@pytest.fixture(scope="module")
def roadnet_map():
    """RoadNet(4000)'s commvol map at 8 shards: D_pad 6,000, the pads at
    each block's end."""
    fam, params = _smoke("roadnet48k")
    rm = plan_rowmap(get_family(fam, **params), 8, balance="commvol")
    assert not rm.identity and rm.D_pad > rm.D
    return rm


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("split", SPLITS_OF_8, ids=lambda s: f"{s[0]}x{s[1]}")
def test_redistribution_round_trip(roadnet_map, split, impl):
    """A block in the position space of a row map: ``to_panel`` gives
    ``[n_col, D_pad, n_c]`` with bundle j the columns ``[j·n_c,
    (j+1)·n_c)``, each bundle contiguous; ``to_stack`` brings it back bit
    for bit, and the rows back out of the map bit for bit; each move
    counts the port's ``redistribution_volume``, the reference's."""
    n_row, n_col = split
    rm = roadnet_map
    rng = np.random.default_rng(n_col)
    X = rng.standard_normal((rm.D, N_S)) + 1j * rng.standard_normal(
        (rm.D, N_S))
    V = torch.from_numpy(rm.embed(X))
    g = ShardGroup(n_row * n_col, "cpu")
    to_panel, to_stack = make_redistribute(g, n_col, impl)
    Vp = to_panel(V)
    n_c = N_S // n_col
    assert Vp.shape == (n_col, rm.D_pad, n_c)
    for j in range(n_col):
        assert Vp[j].is_contiguous()
        assert torch.equal(Vp[j], V[:, j * n_c:(j + 1) * n_c])
    if n_col == 1:  # the one bundle is a view of the block
        assert Vp[0].data_ptr() == V.data_ptr()
    back = to_stack(Vp)
    assert torch.equal(back, V) and back.is_contiguous()
    assert np.array_equal(rm.extract(back.numpy()), X)
    want = redistribution_volume(rm.D_pad, N_S, 8, n_col, 16)["bytes_total"]
    assert want == jredistribution_volume(rm.D_pad, N_S, 8, n_col,
                                          16)["bytes_total"]
    assert g.bytes["redistribute"] == 2 * want
    assert g.calls["redistribute"] == (2 if n_col > 1 else 0)


@pytest.mark.parametrize("split", SPLITS_OF_8, ids=lambda s: f"{s[0]}x{s[1]}")
def test_redistribution_byte_convention(split):
    """The byte convention of the redistribution counter: the reference's
    Eqs. 17–18, ``N_s·D·(1 − 1/N_col)·S`` in all (``bytes_total``) and
    ``N_s·D·(N_col − 1)/P·S`` a process row, taken at D_pad, which is
    what the reference's tiled ``all_to_all`` sends off-device (the
    "moved subset" of ``tests/test_distributed.py``). On the card the
    copy reads and writes all ``N_s·D_pad·S`` bytes of the block, tiles
    that stay on their device included; the counter records only the
    off-device subset, the same for both implementations."""
    n_row, n_col = split
    P, D_pad, N_s, S = 8, 8 * 37, 24, 8
    mine = redistribution_volume(D_pad, N_s, P, n_col, S)
    assert mine == jredistribution_volume(D_pad, N_s, P, n_col, S)
    assert mine["bytes_total"] == N_s * D_pad * S * (n_col - 1) / n_col
    assert mine["bytes_per_process_row"] * n_row == mine["bytes_total"]
    V = torch.arange(D_pad * N_s, dtype=torch.float64).reshape(D_pad, N_s)
    counted = []
    for impl in IMPLS:
        g = ShardGroup(P, "cpu")
        to_panel, _ = make_redistribute(g, n_col, impl)
        to_panel(V)
        counted.append(g.bytes["redistribute"])
    assert counted[0] == counted[1] == mine["bytes_total"]
    assert counted[0] < V.numel() * S  # never the whole block


def test_redistribution_checks_its_shapes():
    g = ShardGroup(4, "cpu")
    with pytest.raises(ValueError, match="unknown redistribution"):
        make_redistribute(g, 2, "nccl")
    with pytest.raises(ValueError, match="do not divide"):
        make_redistribute(g, 3)
    to_panel, to_stack = make_redistribute(g, 2)
    with pytest.raises(ValueError, match="does not split"):
        to_panel(torch.zeros(10, 4))
    with pytest.raises(ValueError, match="bundles"):
        to_stack(torch.zeros(4, 8, 2))


#: (matrix, n_row, n_col, engine): the panel and pillar filters held to
#: the full-width filter through the same N_row-shard engine
FILTER_CASES = {
    "roadnet-panel-4x2": ("roadnet48k", 4, 2, dict(
        comm="compressed", schedule="matching", overlap=True,
        pipeline=False)),
    "roadnet-panel-2x4": ("roadnet48k", 2, 4, dict(comm="a2a")),
    "roadnet-pillar-1x8": ("roadnet48k", 1, 8, dict(comm="a2a")),
    "exciton-pillar-1x4": (("Exciton", dict(L=2)), 1, 4, dict(comm="a2a")),
    "spin-panel-2x2": (("SpinChainXXZ", dict(n_sites=10, n_up=5)), 2, 2,
                       dict(comm="compressed", schedule="cyclic")),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_panel_and_pillar_filter_equals_the_full_width_filter(case):
    """A degree-8 Chebyshev filter run bundle by bundle on the panel
    block, kernels on (their plain versions here; at N_row = 1 the fused
    step takes the DIA route), reassembled by ``to_stack``, equals the
    same filter over the whole block through the N_row-shard engine bit
    for bit: every operation of the filter treats each column on its
    own."""
    src, n_row, n_col, engine = FILTER_CASES[case]
    fam, params = _smoke(src) if isinstance(src, str) else src
    m = get_family(fam, **params)
    P = n_row * n_col
    ell = build_dist_ell(m, n_row, d_pad=-(-m.D // P) * P, device="cpu")
    lam = m.spectral_bounds_hint() or (-10.0, 30.0)
    alpha, beta = scale_params(*lam)
    poly = build_filter((lam[0], lam[0] + 0.2 * (lam[1] - lam[0])), lam,
                        degree=8)
    rng = np.random.default_rng(P)
    V = rng.standard_normal((ell.D_pad, N_S))
    V[m.D:] = 0
    V = torch.from_numpy(V).to(ell.vals.dtype)

    def filt(group, x):
        kw = dict(group=group, use_kernel=True, **engine)
        return chebyshev_filter(make_spmv(ell, **kw), poly.mu, alpha, beta,
                                x, fused_step=make_fused_cheb_step(ell, **kw))

    want = filt(ShardGroup(n_row, "cpu"), V)
    grid = layout_on_grid("pillar" if n_row == 1 else "panel", n_row,
                          n_col).shards("cpu")
    to_panel, to_stack = make_redistribute(grid.stack, n_col)
    Vp = to_panel(V)
    for j in range(n_col):
        Vp[j] = filt(grid.panel, Vp[j])
    got = to_stack(Vp)
    assert torch.equal(got, want)
    assert not got[m.D:].any()


def test_layouts_on_a_grid():
    """``layout_on_grid`` puts a layout on ``n_row × n_col`` shards as the
    reference's ``layout_on_mesh`` does; the grid's panel group is the
    stack group when ``n_col = 1``."""
    assert layout_on_grid("stack", 4, 2).describe() == "stack(8x1)"
    assert layout_on_grid("panel", 4, 2).describe() == "panel(4x2)"
    assert layout_on_grid("pillar", 4, 2).describe() == "pillar(1x8)"
    grid = layout_on_grid("panel", 4, 2).shards("cpu")
    assert (grid.stack.P, grid.panel.P, grid.P) == (8, 4, 8)
    one = layout_on_grid("panel", 4, 1).shards("cpu")
    assert one.panel is one.stack
    for bad in (("stack", 2, 2), ("pillar", 2, 1), ("panel", 0, 2)):
        with pytest.raises(ValueError):
            Layout(*bad)
    with pytest.raises(ValueError, match="unknown layout"):
        layout_on_grid("ring", 2, 2)


def test_step_filter_redistributes_twice_and_keeps_the_levels_apart():
    """One outer iteration in the panel layout 2 × 2: two
    redistributions, each counted on the stack group under its own kind
    with Eqs. 17–18's bytes, the panel engine's halo bytes on the panel
    group, and the layout and both levels in ``exchange_summary``."""
    fam, params = _smoke("roadnet48k")
    m = get_family(fam, **params)
    cfg = FDConfig(n_target=4, n_search=N_S, target=12.94, layout="panel",
                   spmv_comm="compressed")
    fd = FilterDiag(m, cfg, device="cpu", n_row=2, n_col=2)
    assert (fd.P, fd.N_row, fd.N_col) == (4, 2, 2)
    assert fd.ell.P == 4 and fd.ell_panel.P == 2 and fd.ell_panel.L > 0
    state = fd.init_state()
    state = fd.step(state)
    assert state.redistributions == 2 and state.redist_time > 0
    ex = fd.exchange_summary()
    want = redistribution_volume(fd.D_pad, N_S, 4, 2, 8)["bytes_total"]
    assert ex["layout"] == "panel(2x2)"
    assert ex["bytes"]["redistribute"] == 2 * want
    assert ex["calls"]["redistribute"] == 2
    assert ex["panel"]["P"] == 2 and ex["panel"]["bytes"]["ppermute"] > 0
    assert ex["panel"]["bytes"]["redistribute"] == 0
