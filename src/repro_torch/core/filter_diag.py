"""Filter diagonalization driver — paper Algorithm 1, one device.

The stack layout on one device: orthogonalization (TSQR's local QR, or
SVQB), Ritz extraction, the adaptive intervals and the Chebyshev filter all
run on the same [D, N_s] block. With ``spmv_kernel`` every single SpMV
(Lanczos, the Ritz ``A·V``, the filter's T1) runs the CUDA ELL kernel and
every fused filter step runs the DIA kernel where ``ops.plan_dia`` accepts
the operator.

A complex operator (Exciton, TopIns) solves in complex128 when
``cfg.dtype`` is ``"float64"`` and in complex64 when it is ``"float32"``;
``"complex128"`` and ``"complex64"`` are taken as given, a real operator
included. The start block and the Lanczos vector are drawn real and cast,
as the reference draws them (``repro/core/filter_diag.py:337``,
``repro/core/lanczos.py:31``).

The other layouts, the split-phase and compressed halo engines, the s-step
filter and planned row partitions belong to the horizontal and vertical
layers, which are not ported yet: asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import filters
from .chebyshev import chebyshev_filter, scale_params
from .lanczos import lanczos_interval
from .orthogonalize import gram, qr_fixed, svqb
from .spmv import build_dist_ell, make_fused_cheb_step, make_spmv
from ..device import resolve_device

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
    #: Ritz vectors [D, k] of the returned eigenvalues (host copy)
    eigenvectors: np.ndarray | None = None


@dataclasses.dataclass
class FDState:
    """Explicit iteration state of one FD solve (Algorithm 1 unrolled).

    ``pending`` is transient within one iteration only: ``step_analyze``
    stashes the filter coefficients it chose and ``step_filter`` consumes
    them.
    """

    V: torch.Tensor | None         # search block [D, N_s]
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
    if cfg.layout != "stack":
        raise _not_ported(f"layout={cfg.layout!r} (only 'stack' on one device)")
    if cfg.spmv_overlap:
        raise _not_ported("spmv_overlap")
    if cfg.spmv_comm != "a2a" or cfg.spmv_schedule != "cyclic":
        raise _not_ported(f"spmv_comm={cfg.spmv_comm!r}/"
                          f"spmv_schedule={cfg.spmv_schedule!r}")
    if cfg.spmv_sstep != 1:
        raise _not_ported(f"spmv_sstep={cfg.spmv_sstep}")
    if (cfg.spmv_balance, cfg.spmv_reorder) != ("rows", "none"):
        raise _not_ported("a planned (non-identity) row partition")
    if cfg.ortho not in ("tsqr", "svqb"):
        raise ValueError(f"unknown ortho {cfg.ortho!r} (expected tsqr | svqb)")


class FilterDiag:
    """Filter diagonalization of ``matrix`` (a MatrixFamily or a CSR) on
    one device, in the stack layout.

    ``device`` defaults to ``"cuda"``; with no card it raises unless the
    caller passes ``"cpu"``.
    """

    def __init__(self, matrix, cfg: FDConfig, device=None):
        _check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.D = matrix.shape[0] if hasattr(matrix, "shape") else matrix.D
        # the working dtype: cfg.dtype, promoted to complex for a complex
        # operator (spmv.value_dtype)
        self.ell = build_dist_ell(matrix, 1, dtype=cfg.dtype,
                                  device=self.device)
        self.dtype = self.ell.vals.dtype
        self.spmv = make_spmv(self.ell, use_kernel=cfg.spmv_kernel)
        # kernelized recurrence step: the fused 2a·A·w1 + 2b·w1 - w2 body
        # (the DIA kernel when the operator has a DIA form) of the filter
        self.fused_step = (make_fused_cheb_step(self.ell, use_kernel=True)
                           if cfg.spmv_kernel else None)
        if cfg.ortho == "tsqr":  # TSQR on one shard is its local QR
            # the QR routines return Q column-major; the kernels take
            # row-major blocks
            self.orthogonalize = lambda V: qr_fixed(V)[0].contiguous()
        else:
            self.orthogonalize = svqb

    # ------------------------------------------------------------------
    def ritz(self, V):
        AV = self.spmv(V)
        H = gram(V, AV)  # [Ns, Ns]
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

        ``v0`` (Lanczos start vector, D entries) and ``V0`` (search block
        [D, N_s]) may be given as numpy arrays or tensors — the tests pass
        the reference's ``jax.random`` draws. What is not given is drawn
        from ``generator`` (default: seeded with ``cfg.seed`` on the
        solver's device), the Lanczos vector first.
        """
        cfg = self.cfg
        if generator is None and (V0 is None or v0 is None):
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        t0 = time.perf_counter()
        lam = lanczos_interval(self.spmv, self.D, self.dtype, self.device,
                               v0=v0, generator=generator,
                               steps=cfg.lanczos_steps)
        if V0 is None:
            V = torch.randn((self.D, cfg.n_search), generator=generator,
                            dtype=torch.float64, device=self.device).to(self.dtype)
        else:
            V = torch.as_tensor(np.array(V0) if not isinstance(V0, torch.Tensor)
                                else V0).to(device=self.device, dtype=self.dtype)
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
                eigenvectors=VY[:, torch.as_tensor(order, device=VY.device)]
                .cpu().numpy(),
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
                eigenvectors=VY[:, torch.as_tensor(sel, device=VY.device)]
                .cpu().numpy(),
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
        filter and advance the iteration counter."""
        cfg = cfg if cfg is not None else self.cfg
        t_begin = time.perf_counter()
        mu, degree = state.pending
        alpha, beta = scale_params(*state.lam)
        V, state.V = state.V, None
        state.V = chebyshev_filter(self.spmv, mu, alpha, beta, V,
                                   fused_step=self.fused_step)
        del V
        state.total_spmvs += degree * cfg.n_search
        state.history[-1]["degree"] = degree
        state.pending = None
        state.iteration += 1
        state.wall_time += time.perf_counter() - t_begin
        return state

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
