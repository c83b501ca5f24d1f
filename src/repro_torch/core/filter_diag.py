"""Filter diagonalization driver — paper Algorithm 1, on one device.

The two orthogonal layers of parallelism over an ``n_row × n_col`` grid
of shards on one device (``core/shards.py::ShardGrid``; the reference's
``row × col`` mesh, ``repro/core/filter_diag.py``):

* the stack layout over ``P = n_row·n_col`` row shards: orthogonalization
  (TSQR over the shards, or SVQB), Ritz extraction, the adaptive
  intervals and Lanczos, on one ``[D_pad, N_s]`` block whose pad rows
  stay exactly zero;
* the filter layout, ``cfg.layout`` on the grid (``layouts.py::
  layout_on_grid``): ``stack`` (``P × 1``), ``panel`` (``n_row × n_col``)
  or ``pillar`` (``1 × P``). With ``N_col > 1`` each filter pass moves the
  block to ``[N_col, D_pad, N_s/N_col]`` and back (Alg. 1 steps 7 and 9,
  ``core/redistribute.py``), and runs the whole Chebyshev filter of each
  column bundle in bundle order over the panel-level operator's
  ``N_row`` row shards (the bundles are independent, as the reference's
  process columns are). A panel with ``N_col = 1`` is the stack layout.

The shards' collectives are device copies between the row blocks
(``ShardGroup``), and each SpMV takes the halo engine that
``spmv_overlap``, ``spmv_comm`` and ``spmv_schedule`` name
(``core/spmv.py``; the compressed split-phase engine without the round
pipeline), at both levels. With ``spmv_kernel`` every block of every
SpMV (Lanczos, the Ritz ``A·V``, the filter's T1) runs the CUDA ELL
kernel, and every fused filter step the DIA kernel where the panel-level
operator needs no halo (``N_row = 1``, or L = 0) and ``ops.plan_dia``
accepts it, else the ELL kernel with its fused epilogue.

A planned row map (``spmv_balance="commvol"``, ``spmv_reorder="rcm"``;
``core/partition.py``) is planned once at ``P`` and shared by both
operator levels; the search block lives in its position space, Lanczos
masks its pad positions and :meth:`FilterDiag.gather_global` un-permutes
the eigenvectors. Only ``plan_mode="exact"`` is ported (``"auto"`` is
exact below the planner's gate and raises above it).

A complex operator (Exciton, TopIns) solves in complex128 when
``cfg.dtype`` is ``"float64"`` and in complex64 when it is ``"float32"``;
``"complex128"`` and ``"complex64"`` are taken as given, a real operator
included. The start block and the Lanczos vector are drawn real and cast,
as the reference draws them (``repro/core/filter_diag.py:337``,
``repro/core/lanczos.py:31``).

``layout="auto"`` (the χ planner), ``plan_mode="sampled"`` and the s-step
filter are not ported yet: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import filters
from .chebyshev import chebyshev_filter, scale_params
from .lanczos import lanczos_interval
from .layouts import LAYOUTS, layout_on_grid
from .orthogonalize import make_gram, make_svqb, make_tsqr
from .partition import PLAN_MODES, SPMV_BALANCES, SPMV_REORDERS, plan_rowmap
from .redistribute import REDIST_IMPLS, make_redistribute
from .spmv import (_validate_engine, build_dist_ell, make_fused_cheb_step,
                   make_spmv)

__all__ = ["FDConfig", "FDResult", "FDState", "FilterDiag"]


@dataclasses.dataclass
class FDConfig:
    n_target: int = 10          # N_t requested eigenpairs
    n_search: int = 40          # N_s search vectors (N_s >> N_t)
    target: float = 0.0         # τ
    tol: float = 1e-10          # residual convergence threshold (paper)
    max_iters: int = 50
    lanczos_steps: int = 30
    search_expand: float = 1.5  # search-interval growth factor
    degree_cap: int = 200_000
    sharpness: float = 6.0
    ortho: str = "tsqr"         # or "svqb"
    redist_impl: str = "explicit"  # or "gspmd"
    layout: str = "panel"       # filter layout: stack | panel | pillar | auto
    spmv_overlap: bool = False  # split-phase SpMV: hide halo exchange
    spmv_comm: str = "a2a"      # halo exchange: a2a | compressed (ppermute)
    spmv_schedule: str = "cyclic"  # compressed rounds: cyclic | matching
    spmv_balance: str = "rows"  # row partition: rows | commvol (planned cuts)
    spmv_reorder: str = "none"  # row order: none | rcm (bandwidth-reducing)
    spmv_kernel: bool = False   # CUDA kernels for the SpMV and the fused step
    spmv_sstep: int = 1         # s-step filter: depth-s ghosts, ceil(n/s) exchanges
    plan_mode: str = "auto"     # pattern passes: exact | sampled | auto (gate)
    dtype: str = "float64"
    seed: int = 7


@dataclasses.dataclass
class FDResult:
    eigenvalues: np.ndarray
    residuals: np.ndarray
    n_converged: int
    iterations: int
    total_spmvs: int
    redistributions: int
    wall_time: float
    redist_time: float
    history: list
    #: Ritz vectors [D, k] of the returned eigenvalues (host copy, pad
    #: rows stripped)
    eigenvectors: np.ndarray | None = None
    #: what the shards' collectives moved over the solve: the SpMV engine,
    #: the layout, P, L, bytes and calls per collective kind of the stack
    #: group (the redistributions under "redistribute") and of the panel
    #: group (``FilterDiag.exchange_summary``)
    exchange: dict | None = None


@dataclasses.dataclass
class FDState:
    """Explicit iteration state of one FD solve (Algorithm 1 unrolled).

    ``pending`` is transient within one iteration only: ``step_analyze``
    stashes the filter coefficients it chose and ``step_filter`` consumes
    them.
    """

    V: torch.Tensor | None         # search block [D_pad, N_s], stack layout
    lam: tuple                     # Lanczos inclusion interval (λ_l, λ_r)
    iteration: int = 0
    total_spmvs: int = 0
    redistributions: int = 0
    redist_time: float = 0.0
    wall_time: float = 0.0
    history: list = dataclasses.field(default_factory=list)
    pending: tuple | None = None   # (mu [deg+1], degree) awaiting step_filter
    done: bool = False
    result: FDResult | None = None


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet, see ROADMAP")


def _check_config(cfg: FDConfig) -> None:
    if cfg.layout == "auto":
        raise _not_ported("layout='auto' (the χ-driven planner, "
                          "repro/core/planner.py)")
    if cfg.layout not in LAYOUTS:
        raise ValueError(f"unknown FDConfig.layout {cfg.layout!r} (expected "
                         "stack | panel | pillar | auto)")
    _validate_engine(cfg.spmv_comm, cfg.spmv_schedule)
    if cfg.spmv_sstep != 1:
        raise _not_ported(f"spmv_sstep={cfg.spmv_sstep}")
    for name, value, allowed in (
            ("redist_impl", cfg.redist_impl, REDIST_IMPLS),
            ("spmv_balance", cfg.spmv_balance, SPMV_BALANCES),
            ("spmv_reorder", cfg.spmv_reorder, SPMV_REORDERS),
            ("plan_mode", cfg.plan_mode, PLAN_MODES),
            ("ortho", cfg.ortho, ("tsqr", "svqb"))):
        if value not in allowed:
            raise ValueError(f"unknown {name} {value!r} (expected one of "
                             f"{allowed})")


class FilterDiag:
    """Filter diagonalization of ``matrix`` (a MatrixFamily or a CSR) on
    an ``n_row × n_col`` grid of shards on one device, the filter in the
    layout ``cfg.layout`` names on it.

    ``device`` defaults to ``"cuda"``; with no card it raises unless the
    caller passes ``"cpu"``. TSQR needs ``n_row·n_col`` to be a power of
    two. ``rowmap`` (a planned :class:`~repro_torch.core.partition.RowMap`
    at ``P = n_row·n_col``) is used as given; without it one is planned
    here from ``spmv_balance``/``spmv_reorder`` (rows/none: the identity
    map, ``RowMap.rows``).

    The stack level is ``ell``, ``spmv`` and ``group`` (``P`` row shards),
    the filter's level ``ell_panel``, ``spmv_panel`` and ``fused_step``
    (``N_row`` row shards; the same objects when ``N_col = 1``).
    """

    def __init__(self, matrix, cfg: FDConfig, device=None, n_row: int = 1,
                 n_col: int = 1, rowmap=None):
        _check_config(cfg)
        self.cfg = cfg
        self.layout = layout_on_grid(cfg.layout, n_row, n_col)
        self.grid = self.layout.shards(device)
        self.group = self.grid.stack
        self.device = self.grid.device
        self.P = self.grid.P
        self.N_row, self.N_col = self.layout.n_row, self.layout.n_col
        if cfg.n_search % self.N_col:
            raise ValueError(f"n_search={cfg.n_search} is not divisible by "
                             f"N_col={self.N_col}")
        self.D = matrix.shape[0] if hasattr(matrix, "shape") else matrix.D
        # the row map, planned once at P so that both operator levels
        # share it (``filter_diag.py:176-188`` of the reference); the
        # equal-rows partition is its identity map (``RowMap.rows``)
        if rowmap is None:
            rowmap = plan_rowmap(matrix, self.P, balance=cfg.spmv_balance,
                                 reorder=cfg.spmv_reorder,
                                 sstep=cfg.spmv_sstep,
                                 plan_mode=cfg.plan_mode)
        self.rowmap = rowmap
        self.D_pad = rowmap.D_pad
        # the working dtype: cfg.dtype, promoted to complex for a complex
        # operator (spmv.value_dtype)
        build = dict(dtype=cfg.dtype, d_pad=self.D_pad,
                     split_halo=cfg.spmv_overlap, rowmap=rowmap,
                     device=self.device)
        self.ell = build_dist_ell(matrix, self.P, **build)
        self.ell_panel = (self.ell if self.N_col == 1
                          else build_dist_ell(matrix, self.N_row, **build))
        self.dtype = self.ell.vals.dtype
        # the compressed split-phase engine contracts the halo block once
        # every round has landed (pipeline=False): with the shards on one
        # card the exchange is a device copy, and each pipelined round's
        # block is one more launch and pass over every row of a shard, the
        # slowest engine on every case measured (PERF.md, engines table)
        engine = dict(use_kernel=cfg.spmv_kernel, overlap=cfg.spmv_overlap,
                      comm=cfg.spmv_comm, schedule=cfg.spmv_schedule,
                      pipeline=False)
        self.spmv = make_spmv(self.ell, group=self.grid.stack, **engine)
        self.engine = self.spmv.kind  # the halo engine, e.g. "a2a-overlap"
        self.spmv_panel = (self.spmv if self.N_col == 1 else
                           make_spmv(self.ell_panel, group=self.grid.panel,
                                     **engine))
        # kernelized recurrence step of the filter, at the panel level:
        # the fused 2a·A·w1 + 2b·w1 - w2 body (the DIA kernel when the
        # operator has a DIA form and no halo, else the ELL kernel with
        # its epilogue)
        self.fused_step = (
            make_fused_cheb_step(self.ell_panel, group=self.grid.panel,
                                 **{**engine, "use_kernel": True})
            if cfg.spmv_kernel else None)
        if cfg.ortho == "tsqr":
            tsqr = make_tsqr(self.group)  # Q comes back row-major
            self.orthogonalize = lambda V: tsqr(V)[0]
        else:
            self.orthogonalize = make_svqb(self.group)
        self.gram = make_gram(self.group)
        self.to_panel, self.to_stack = make_redistribute(
            self.group, self.N_col, cfg.redist_impl)
        # the map's positions of the rows, and which positions hold one
        self._pos = torch.as_tensor(rowmap.pos, device=self.device)
        self._mask = torch.as_tensor(rowmap.valid_mask(), device=self.device)

    def _place(self, V, row_order: bool) -> torch.Tensor:
        """``V`` ([D, ...] or [D_pad, ...], numpy or tensor) as a row-major
        [D_pad, ...] tensor of the solver's dtype and device in position
        space, the pad positions zero (a new tensor: the caller's is not
        touched). A [D, ...] block is in row order and is placed at the
        map's positions; a [D_pad, ...] block is in position space already
        and its pads are zeroed. When D equals D_pad, ``row_order`` says
        which it is."""
        V = torch.as_tensor(np.array(V) if not isinstance(V, torch.Tensor)
                            else V).to(device=self.device, dtype=self.dtype)
        n = V.shape[0]
        if n not in (self.D, self.D_pad):
            raise ValueError(f"block has {n} rows, expected {self.D} or "
                             f"{self.D_pad}")
        if n == self.D and (row_order or n != self.D_pad):
            out = V.new_zeros((self.D_pad,) + tuple(V.shape[1:]))
            out[self._pos] = V
            return out
        mask = self._mask.view((-1,) + (1,) * (V.dim() - 1))
        return torch.where(mask, V, torch.zeros_like(V))

    def _sync(self) -> None:
        """Wait for the device (the reference's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def exchange_summary(self) -> dict:
        """What the shards' collectives moved so far, each level apart:
        the stack engine's (``bytes``/``calls`` of the stack group, where
        ``"redistribute"`` holds the stack↔panel redistributions) and,
        when ``N_col > 1``, the panel engine's (``panel``)."""
        st, pn = self.grid.stack, self.grid.panel
        return dict(engine=self.engine, layout=self.layout.describe(),
                    P=self.P, L=self.ell.L, bytes=dict(st.bytes),
                    calls=dict(st.calls),
                    panel=None if pn is st else dict(
                        P=pn.P, L=self.ell_panel.L, bytes=dict(pn.bytes),
                        calls=dict(pn.calls)))

    def gather_global(self, V) -> np.ndarray:
        """The rows of a padded [D_pad, ...] block in the original row
        order, [D, ...], on the host: the pads stripped and the rows
        un-permuted (bit-exact)."""
        return V.index_select(0, self._pos).cpu().numpy()

    # ------------------------------------------------------------------
    def ritz(self, V):
        AV = self.spmv(V)
        H = self.gram(V, AV)  # [Ns, Ns], one all-reduce over the shards
        H = 0.5 * (H + H.conj().T)
        theta, Y = torch.linalg.eigh(H)
        # residual norms: || AV y - θ V y ||
        AVY = AV @ Y.to(AV.dtype)
        del AV
        VY = V @ Y.to(V.dtype)
        Rm = AVY - VY * theta[None, :].to(VY.dtype)
        res = torch.sqrt(torch.sum(torch.abs(Rm) ** 2, dim=0))
        return theta, Y, res, VY

    def _intervals(self, theta, res, lam, cfg: FDConfig | None = None):
        """Adaptive target & search intervals from the current Ritz data.

        Intervals are bounding boxes of the closest Ritz values rather than
        symmetric windows around τ: for extremal targets (τ outside the
        spectrum) a τ-centered window would keep covering ≫ N_s eigenvalues
        and FD would stall — the paper's Fig. 2 (right column) failure.
        """
        cfg = cfg if cfg is not None else self.cfg
        d = np.abs(theta - cfg.target)
        order = np.argsort(d)
        spec_w = lam[1] - lam[0]
        sel_t = theta[order[: min(cfg.n_target, len(order))]]
        # anchor on τ (clipped into the spectrum): with random start vectors
        # the Ritz values cluster in the spectral bulk, and a pure bounding
        # box would lock the filter onto the wrong region
        tau_c = float(np.clip(cfg.target, lam[0], lam[1]))
        lo = min(float(sel_t.min()), tau_c)
        hi = max(float(sel_t.max()), tau_c)
        pad_t = max(1e-8 * spec_w, 0.05 * (hi - lo))
        target = (lo - pad_t, hi + pad_t)
        n_s = min(int(0.75 * cfg.n_search), len(order))
        sel_s = theta[order[:n_s]]
        s_lo = min(float(sel_s.min()), target[0])
        s_hi = max(float(sel_s.max()), target[1])
        mid = 0.5 * (s_lo + s_hi)
        half = max(0.5 * (s_hi - s_lo),
                   cfg.search_expand * 0.5 * (target[1] - target[0]))
        # pad outward so wanted states sit on the filter plateau, not on the
        # Jackson transition slope (slope width ~ pi/n of the mapped axis)
        pad_s = 0.15 * half
        lo_s = max(mid - half - pad_s, lam[0])
        hi_s = min(mid + half + pad_s, lam[1])
        # extremal targets: widen the outward side by ~the transition width
        # (0.75 of the inner span) so edge states sit on the filter plateau
        # instead of the Jackson slope — without collapsing the degree the
        # way fully opening the window to the inclusion bound would
        if cfg.target <= float(theta.min()):
            lo_s = max(lam[0], target[0] - 0.75 * (hi_s - target[0]))
        if cfg.target >= float(theta.max()):
            hi_s = min(lam[1], target[1] + 0.75 * (target[1] - lo_s))
        search = (lo_s, hi_s)
        return target, search

    # ------------------------------------------------------------------
    def init_state(self, V0=None, v0=None,
                   generator: torch.Generator | None = None) -> FDState:
        """Fresh :class:`FDState`: Lanczos inclusion interval + search block.

        ``v0`` (Lanczos start vector) and ``V0`` (search block [·, N_s])
        may be given as numpy arrays or tensors: the tests pass the
        reference's ``jax.random`` draws. As the reference draws them, a
        ``V0`` of D rows is in row order and ``v0`` of D_pad entries in
        position space (its pad positions masked); either may also come
        in the other form (:meth:`_place`). What is not given is drawn
        from ``generator`` (default: seeded with ``cfg.seed`` on the
        solver's device), the Lanczos vector first, both in row order
        ([D, ·]) and then placed, so that a solve starts from the same
        vectors whatever its layout, shard count or row map.
        """
        cfg = self.cfg
        if generator is None and (V0 is None or v0 is None):
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        def draw(n_cols):
            return torch.randn((self.D, n_cols), generator=generator,
                               dtype=torch.float64, device=self.device)

        t0 = time.perf_counter()
        v = self._place(draw(1) if v0 is None else v0,
                        row_order=v0 is None).reshape(-1, 1)
        lam = lanczos_interval(self.spmv, self.D, self.dtype, self.device,
                               v0=v, steps=cfg.lanczos_steps, D_pad=self.D_pad,
                               mask=self._mask)
        V = self._place(draw(cfg.n_search) if V0 is None else V0,
                        row_order=True)
        return FDState(V=V, lam=lam, total_spmvs=cfg.lanczos_steps,
                       wall_time=time.perf_counter() - t0)

    def step_analyze(self, state: FDState, cfg: FDConfig | None = None,
                     verbose: bool = False) -> FDState:
        """First half of one outer iteration: orthogonalize, Ritz extract,
        adapt the intervals, and either finish the solve (``state.done``)
        or stash the chosen filter in ``state.pending``."""
        cfg = cfg if cfg is not None else self.cfg
        t_begin = time.perf_counter()
        it = state.iteration
        if it >= cfg.max_iters:
            # not converged within max_iters — report best effort
            theta, Y, res, VY = self.ritz(self.orthogonalize(state.V))
            theta_h, res_h = theta.cpu().numpy(), res.cpu().numpy()
            order = np.argsort(np.abs(theta_h - cfg.target))[: cfg.n_target]
            state.wall_time += time.perf_counter() - t_begin
            state.done = True
            state.result = FDResult(
                eigenvalues=theta_h[order], residuals=res_h[order],
                n_converged=int((res_h[order] <= cfg.tol).sum()),
                iterations=cfg.max_iters, total_spmvs=state.total_spmvs,
                redistributions=state.redistributions,
                wall_time=state.wall_time,
                redist_time=state.redist_time, history=state.history,
                eigenvectors=self.gather_global(
                    VY[:, torch.as_tensor(order, device=VY.device)]),
                exchange=self.exchange_summary(),
            )
            return state
        V = self.orthogonalize(state.V)
        state.V = None  # the unorthogonalized block is not needed again
        theta, Y, res, VY = self.ritz(V)
        del V
        state.total_spmvs += cfg.n_search
        theta_h = theta.cpu().numpy()
        res_h = res.cpu().numpy()
        target, search = self._intervals(theta_h, res_h, state.lam, cfg=cfg)
        in_t = (theta_h >= target[0]) & (theta_h <= target[1])
        conv = in_t & (res_h <= cfg.tol)
        state.history.append(
            dict(iter=it, n_conv=int(conv.sum()), search=search,
                 best_res=float(res_h[in_t].min()) if in_t.any() else float("nan"))
        )
        if verbose:
            print(f"[fd] it={it:3d} conv={int(conv.sum()):4d}/{cfg.n_target} "
                  f"search=({search[0]:+.4e},{search[1]:+.4e}) "
                  f"best_res={state.history[-1]['best_res']:.2e}")
        if conv.sum() >= cfg.n_target:
            # the window's pairs still above tol at the stop: the returned
            # set steps over them (n_conv counts converged pairs anywhere
            # in the window, as the reference's rule does)
            late = in_t & ~conv
            state.history[-1]["unconverged"] = [
                (float(t), float(r)) for t, r in zip(theta_h[late],
                                                     res_h[late])]
            order = np.argsort(np.abs(theta_h - cfg.target))
            sel = order[conv[order]][: max(cfg.n_target, int(conv.sum()))]
            state.wall_time += time.perf_counter() - t_begin
            state.done = True
            state.V = VY
            state.result = FDResult(
                eigenvalues=theta_h[sel], residuals=res_h[sel],
                n_converged=int(conv.sum()), iterations=it,
                total_spmvs=state.total_spmvs,
                redistributions=state.redistributions,
                wall_time=state.wall_time,
                redist_time=state.redist_time, history=state.history,
                eigenvectors=self.gather_global(
                    VY[:, torch.as_tensor(sel, device=VY.device)]),
                exchange=self.exchange_summary(),
            )
            return state
        poly = filters.build_filter(
            search, state.lam, sharpness=cfg.sharpness,
            n_max=cfg.degree_cap,
        )
        # start the filter from the Ritz basis (better conditioning)
        state.V = VY
        state.pending = (np.asarray(poly.mu), poly.degree)
        state.wall_time += time.perf_counter() - t_begin
        return state

    def step_filter(self, state: FDState,
                    cfg: FDConfig | None = None) -> FDState:
        """Second half of one outer iteration: apply the pending Chebyshev
        filter in the filter layout (with ``N_col > 1``: redistribute to
        the panel block, filter each bundle, redistribute back) and
        advance the iteration counter."""
        cfg = cfg if cfg is not None else self.cfg
        t_begin = time.perf_counter()
        mu, degree = state.pending
        alpha, beta = scale_params(*state.lam)
        V, state.V = state.V, None
        Vp = self._redistribute(state, self.to_panel, V)
        del V
        # each bundle's filter output becomes the bundle
        bundles = [chebyshev_filter(self.spmv_panel, mu, alpha, beta, Vj,
                                    fused_step=self.fused_step) for Vj in Vp]
        del Vp
        V = self._redistribute(state, self.to_stack, bundles)
        del bundles
        state.V = V
        state.total_spmvs += degree * cfg.n_search
        state.history[-1]["degree"] = degree
        state.pending = None
        state.iteration += 1
        state.wall_time += time.perf_counter() - t_begin
        return state

    def _redistribute(self, state: FDState, move, X):
        """``move(X)`` (``to_panel`` or ``to_stack``); with ``N_col > 1``
        one redistribution, counted and timed with the device idle at the
        clock's start, so that ``redist_time`` holds the moves alone, not
        the filter queued before them."""
        if self.N_col == 1:
            return move(X)
        self._sync()
        t0 = time.perf_counter()
        out = move(X)
        self._sync()
        state.redistributions += 1
        state.redist_time += time.perf_counter() - t0
        return out

    def step(self, state: FDState, verbose: bool = False) -> FDState:
        """One full outer iteration (analyze + filter)."""
        state = self.step_analyze(state, verbose=verbose)
        if not state.done:
            state = self.step_filter(state)
        return state

    def solve(self, V0=None, v0=None, generator=None,
              verbose: bool = False) -> FDResult:
        state = self.init_state(V0=V0, v0=v0, generator=generator)
        while not state.done:
            state = self.step(state, verbose=verbose)
        return state.result
