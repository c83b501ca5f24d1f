"""Analytic performance model — paper Eqs. (7), (11)–(23): the port's
copy of ``repro/core/perf_model.py`` (numpy only; held equal to the
original over a grid of inputs by ``tests/test_torch_perf_model.py``).

All quantities are per *process*; bandwidths in bytes/s. The model is
hardware-agnostic: the iteration-time models take a :class:`MachineModel`
whose constants come from a fit on the machine under the workload.

Beyond the paper: ``cheb_iter_time_overlap`` models the split-phase SpMV
engine (``spmv.py`` ``overlap=True``), replacing Eq. 12's additive χ term
with ``T = max(T_comm, T_local) + T_halo`` — communication hides behind
local work until χ·S_d/b_c exceeds the local memory time.

The χ argument of both iteration-time models is the *effective* χ of a
concrete comm engine — the vector entries it actually moves per shard,
normalized like Eq. 8 (:func:`engine_chi`). The padded all_to_all engine
moves ``P·L`` entries (χ₃-scaled: every pair pays the global max pair
volume); the compressed neighbor-permute engine moves ``H = Σ_r L_r``,
the round-sum of its schedule's per-round pads (cyclic-shift or
greedy-matching rounds, ``spmv.neighbor_schedule``) — equivalently the
round-sum cost ``T_comm = Σ_r L_r·S_d/b_c`` of
:func:`schedule_comm_time`. Feeding each engine's exact wire volume
through the same Eq. 12 / overlap form is how the planner ranks the
{a2a, compressed-cyclic, compressed-matching} × {additive, overlap}
grid.

``MachineModel.fit`` calibrates b_c, κ and α from measured iteration
times (``python -m repro_torch.launch.dryrun --fit-machine PATH``).
The port's one builtin model, :data:`H100_1CARD`, is such a fit on one
H100: its "processes" are the row shards of one card, so ``b_c`` is the
rate of the device copies between shard blocks
(``launch/dryrun.py::fit_machine``). Its ``alpha`` is the fit's third
coefficient, not a measured launch cost: it absorbs what Eq. 12 leaves
of the full-width samples, and is far larger than the whole step of the
tiny-width samples it should price (``PERF.md``, the machine model).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

__all__ = ["MachineModel", "H100_1CARD", "BUILTIN_MACHINES",
           "engine_chi",
           "FUSED_KERNEL_KAPPA", "fused_kernel_machine",
           "schedule_comm_time",
           "cheb_iter_time", "cheb_iter_time_overlap", "overlap_speedup",
           "panel_speedup", "redistribution_factor", "amortized_speedup",
           "break_even_degree", "pillar_condition", "parallel_efficiency_bound",
           "save_machine", "load_machine", "resolve_machine"]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    b_m: float  # memory bandwidth per process [B/s]
    b_c: float  # effective inter-process communication bandwidth [B/s]
    kappa: float  # vector traffic factor (>=5 for the fused kernel)
    #: per-collective-round launch latency [s] — the α of the s-step cost
    #: model α·⌈n/s⌉ + β·bytes(s). Zero (the default) reproduces the
    #: pure-bandwidth Eq. 12 exactly; only a latency-bound model can make
    #: the planner prefer spmv_sstep > 1.
    alpha: float = 0.0

    @property
    def bc_over_bm(self) -> float:
        return self.b_c / self.b_m

    @classmethod
    def fit(cls, samples, *, b_m: float, name: str = "fitted",
            S_i: int = 4) -> "MachineModel":
        """Least-squares fit of (κ, b_c, α) to measured iteration times.

        Each sample is a dict with keys ``t`` (measured seconds of one
        fused Chebyshev iteration) plus the Eq. 12 inputs ``D, N_p, n_b,
        chi, n_nzr, S_d`` and optionally ``rounds`` (collective rounds
        launched during the measured iteration). Eq. 12 + the round
        latency term is linear in κ, 1/b_c and α once b_m is fixed (the
        paper fits the bandwidth part the same way, b_m from STREAM):

            t = scale·(S_d+S_i)·n_nzr/n_b / b_m  +  κ·scale·S_d/b_m
                +  (1/b_c)·scale·χ·S_d           +  α·rounds

        with ``scale = n_b·D/N_p``. At least one sample must have χ > 0
        to identify b_c; with only χ = 0 samples the fit is deliberately
        comm-free (κ-only calibration, e.g. single-device runs) and b_c
        stays +inf. When χ > 0 samples ARE present but the fitted comm
        coefficient comes out non-positive (noisy timings, e.g. fake CPU
        devices where communication is a memcpy), b_c is also left at
        +inf and a ``RuntimeWarning`` flags that the model prices
        communication as free — a ranking built on it would favor max-χ
        layouts.

        α is identifiable only when the ``rounds`` column is not
        collinear with the χ·bytes column — i.e. the samples include
        *small-message* cells whose round count varies while their wire
        bytes stay tiny (``dryrun --fit-machine`` emits such tiny-halo
        cells for exactly this purpose). Without any ``rounds`` data the
        latency column is dropped and α stays 0.
        """
        import warnings

        samples = list(samples)
        if not samples:
            raise ValueError("MachineModel.fit needs at least one sample")
        rows, rhs = [], []
        for s in samples:
            scale = s["n_b"] * s["D"] / s["N_p"]
            mat_term = scale * (s["S_d"] + S_i) * s["n_nzr"] / s["n_b"] / b_m
            rows.append([scale * s["S_d"] / b_m, scale * s["chi"] * s["S_d"],
                         float(s.get("rounds", 0.0))])
            rhs.append(s["t"] - mat_term)
        A = np.asarray(rows, dtype=np.float64)
        y = np.asarray(rhs, dtype=np.float64)
        has_comm = bool((A[:, 1] > 0).any())
        has_rounds = bool((A[:, 2] > 0).any())
        keep = [0] + ([1] if has_comm else []) + ([2] if has_rounds else [])
        sol_k, *_ = np.linalg.lstsq(A[:, keep], y, rcond=None)
        sol = np.zeros(3)
        sol[keep] = sol_k
        kappa = float(max(sol[0], 0.0))
        inv_bc = float(max(sol[1], 0.0)) if has_comm else 0.0
        alpha = float(max(sol[2], 0.0)) if has_rounds else 0.0
        b_c = (1.0 / inv_bc) if inv_bc > 0 else float("inf")
        if has_comm and inv_bc == 0.0:
            warnings.warn(
                "MachineModel.fit: chi > 0 samples present but the fitted "
                "comm coefficient is non-positive (timings do not scale "
                "with chi on this host); b_c left at +inf — the model "
                "treats communication as FREE and is unsuitable for "
                "comm-sensitive planning", RuntimeWarning, stacklevel=2)
        return cls(name=name, b_m=b_m, b_c=b_c, kappa=kappa, alpha=alpha)


#: Vector-traffic factor of the fused Chebyshev kernel (paper §3.2): the
#: fused SpMV+axpy step reads W1 once and streams W2/V, so κ = 5 instead
#: of the unfused engine's measured 6–7.3.
FUSED_KERNEL_KAPPA = 5.0


def fused_kernel_machine(m: MachineModel) -> MachineModel:
    """Machine model as seen by the fused kernel engines
    (``make_spmv(use_kernel=True)`` + ``make_fused_cheb_step``): the κ
    vector-traffic factor clamps to :data:`FUSED_KERNEL_KAPPA` — the
    planner scores kernel candidates with this model so the κ=5 fused
    term enters the ranking only where the kernel actually runs."""
    if m.kappa <= FUSED_KERNEL_KAPPA:
        return m
    return dataclasses.replace(m, name=m.name + "+krn",
                               kappa=FUSED_KERNEL_KAPPA)


#: One H100 as the port runs it: the shards of the horizontal layer are
#: row blocks of one card, so ``b_c`` is the rate of the device copies
#: between them. ``alpha`` is what the least-squares fit puts on the
#: rounds column: it absorbs the residual of the full-width samples and
#: does not measure a launch (the tiny-width steps take less than it in
#: all). Fitted by
#: ``python -m repro_torch.launch.dryrun --fit-machine PATH --family
#: Hubbard --params n_sites=12,n_fermions=6,U=25,ranpot=1 --n-devices 4
#: --n-search 512`` (fp64, splits 4x1 / 2x2 / 1x4, the a2a step, kernels
#: on; ``b_m`` from a 1 GiB copy) on an NVIDIA H100 80GB HBM3 with a
#: power limit of 700.00 W (nvidia-smi name, power.limit).
H100_1CARD = MachineModel("h100-1card", b_m=2.985987855725738e12,
                          b_c=1.5136638370035884e12,
                          kappa=7.753733732309542,
                          alpha=2.131299879138236e-4)


def save_machine(m: MachineModel, path: str) -> None:
    """Persist a (fitted) machine model as JSON (``dryrun --fit-machine``;
    an infinite ``b_c`` is written as JSON's ``Infinity``)."""
    with open(path, "w") as f:
        json.dump({"name": m.name, "b_m": m.b_m, "b_c": m.b_c,
                   "kappa": m.kappa, "alpha": m.alpha}, f)


def load_machine(path: str) -> MachineModel:
    """Load a machine model saved by :func:`save_machine`."""
    with open(path) as f:
        d = json.load(f)
    return MachineModel(name=d["name"], b_m=float(d["b_m"]),
                        b_c=float(d["b_c"]), kappa=float(d["kappa"]),
                        alpha=float(d.get("alpha", 0.0)))


#: Built-in machine models addressable by name on the CLIs.
BUILTIN_MACHINES = {H100_1CARD.name: H100_1CARD}


def resolve_machine(name_or_path: str) -> MachineModel:
    """CLI ``--machine`` resolution shared by solve and dryrun: a builtin
    name (:data:`BUILTIN_MACHINES`) or a JSON path written by
    ``dryrun --fit-machine`` / :func:`save_machine`."""
    m = BUILTIN_MACHINES.get(name_or_path)
    if m is not None:
        return m
    try:
        return load_machine(name_or_path)
    except FileNotFoundError:
        raise ValueError(
            f"--machine {name_or_path!r} is neither a builtin model "
            f"({sorted(BUILTIN_MACHINES)}) nor a readable JSON path "
            f"(save one with `python -m repro_torch.launch.dryrun "
            f"--fit-machine PATH`)") from None


def engine_chi(moved_entries_per_device: float, D: int, N_p: int) -> float:
    """Effective χ of a comm engine: the vector entries it physically moves
    per device and vector column, over the local block size D/N_p (the
    normalization of Eq. 8). The padded all_to_all moves ``P·L`` entries
    (χ₃-scaled); the compressed neighbor schedule moves ``H = Σ_k L_k``
    (χ₂-scaled). Feed the result to the ``chi`` argument of
    :func:`cheb_iter_time` / :func:`cheb_iter_time_overlap`."""
    if N_p <= 1:
        return 0.0
    return moved_entries_per_device * N_p / D


def schedule_comm_time(m: MachineModel, round_L, *, n_b: int,
                       S_d: int) -> float:
    """Round-sum communication cost of a neighbor-permute schedule:

        T_comm = Σ_r L_r · n_b · S_d / b_c

    where ``round_L[r]`` is round r's pad (the max scheduled pair volume,
    ``spmv.neighbor_schedule``) — each round's permute moves exactly
    ``L_r · n_b · S_d`` operand bytes per device. This is *identical* to
    the Eq. 12 comm term evaluated at the engine's effective χ:
    ``engine_chi(H, D, N_p) · S_d / b_c · (n_b · D / N_p)`` with
    ``H = Σ_r L_r`` — the planner's χ-based ranking and the round-sum
    view of the schedule cannot disagree (asserted in
    tests/test_spmv_schedule.py).
    """
    return float(sum(round_L)) * n_b * S_d / m.b_c


def cheb_iter_time(m: MachineModel, *, D: int, N_p: int, n_b: int, chi: float,
                   n_nzr: float, S_d: int, S_i: int = 4,
                   rounds: float = 0.0, work_factor: float = 1.0) -> float:
    """Eq. (12): execution time of one fused Chebyshev-filter iteration.

    ``rounds`` is the number of collective rounds launched per iteration
    (1 for the a2a engine, the schedule's round count for the compressed
    engine, ``⌈n/s⌉·rounds_per_exchange / n`` for the s-step engine) —
    each costs the machine's ``alpha`` launch latency on top of the
    bandwidth terms. ``work_factor`` scales the matrix-traffic term for
    engines that contract redundant rows (the s-step ghost-zone rows:
    ``1 + Σ_{d<s} ghosts(d) / (s·R)``). The defaults reproduce the
    pure Eq. 12 value bit-for-bit.
    """
    per_entry = ((S_d + S_i) * n_nzr * work_factor / n_b
                 + m.kappa * S_d) / m.b_m + chi * S_d / m.b_c
    return per_entry * n_b * D / N_p + m.alpha * rounds


def cheb_iter_time_overlap(m: MachineModel, *, D: int, N_p: int, n_b: int,
                           chi: float, n_nzr: float, S_d: int, S_i: int = 4,
                           halo_frac: float | None = None,
                           rounds: float = 0.0) -> float:
    """Overlap-aware variant of Eq. (12): ``T = max(T_comm, T_local) + T_halo``.

    The split-phase engine (``make_spmv(..., overlap=True)``) issues the
    halo all_to_all before the local contraction, so the additive χ term of
    Eq. 12 is replaced by a max: communication is free whenever
    ``T_comm <= T_local``. The halo contraction (``halo_frac`` of the
    nonzeros, reading the received buffer) cannot be hidden and stays
    additive.

    ``halo_frac`` defaults to ``min(1, chi / n_nzr)`` — every communicated
    vector entry feeds at least one halo nonzero (exact value available
    from ``DistEll.halo_nnz_fraction``). ``rounds`` adds the machine's
    per-round ``alpha`` launch latency (the collective must be *issued*
    before local work can hide its bytes, so the latency term stays
    additive).
    """
    if N_p <= 1 or chi <= 0:
        return cheb_iter_time(m, D=D, N_p=N_p, n_b=n_b, chi=0.0,
                              n_nzr=n_nzr, S_d=S_d, S_i=S_i)
    if halo_frac is None:
        halo_frac = min(1.0, chi / max(n_nzr, 1e-12))
    nnz_halo = halo_frac * n_nzr
    nnz_loc = n_nzr - nnz_halo
    scale = n_b * D / N_p
    t_comm = chi * S_d / m.b_c * scale
    # the kappa vector-traffic term belongs to the local phase (W1/W2/V
    # streaming happens while bytes are in flight)
    t_local = ((S_d + S_i) * nnz_loc / n_b + m.kappa * S_d) / m.b_m * scale
    t_halo = (S_d + S_i) * nnz_halo / n_b / m.b_m * scale
    return max(t_comm, t_local) + t_halo + m.alpha * rounds


def overlap_speedup(m: MachineModel, *, D: int, N_p: int, n_b: int, chi: float,
                    n_nzr: float, S_d: int, S_i: int = 4,
                    halo_frac: float | None = None) -> float:
    """Predicted additive/overlap time ratio (>1 when hiding the halo
    exchange behind local work pays; ->1 when χ ≈ 0 or comm dominates)."""
    t_add = cheb_iter_time(m, D=D, N_p=N_p, n_b=n_b, chi=chi, n_nzr=n_nzr,
                           S_d=S_d, S_i=S_i)
    t_ov = cheb_iter_time_overlap(m, D=D, N_p=N_p, n_b=n_b, chi=chi,
                                  n_nzr=n_nzr, S_d=S_d, S_i=S_i,
                                  halo_frac=halo_frac)
    return t_add / t_ov


def parallel_efficiency_bound(m: MachineModel, chi3: float) -> float:
    """Eq. (11): Π ≲ min{1, χ₃⁻¹ b_c/b_m}."""
    if chi3 <= 0:
        return 1.0
    return min(1.0, m.bc_over_bm / chi3)


def panel_speedup(m: MachineModel, chi_P: float, chi_panel: float) -> float:
    """Eq. (15): s = (κ b_c/b_m + χ[P]) / (κ b_c/b_m + χ[P/N_col])."""
    k = m.kappa * m.bc_over_bm
    return (k + chi_P) / (k + chi_panel)


def layout_speedup_full(m: MachineModel, *, chi_P: float, chi_panel: float,
                        n_nzr: float, S_d: int, n_b_stack: int, n_col: int,
                        S_i: int = 4) -> float:
    """Panel speedup from the *full* Eq. 12 (keeps the matrix-traffic term
    that Eq. 15 drops). At pillar layouts the per-column block shrinks to
    n_b/N_col, so the matrix term re-enters — this reproduces the paper's
    *measured* Table 3 values (e.g. Hubbard14 pillar s≈5, not the Eq.-15
    asymptote ≈9)."""

    def per_entry(n_b, chi):
        return ((S_d + S_i) * n_nzr / max(n_b, 1) + m.kappa * S_d) / m.b_m \
            + chi * S_d / m.b_c

    return per_entry(n_b_stack, chi_P) / per_entry(n_b_stack / n_col, chi_panel)


def redistribution_factor(m: MachineModel, N_col: int, chi_panel: float) -> float:
    """Eq. (21): r = (1 - 1/N_col) / (κ b_c/b_m + χ[P/N_col]).

    One redistribution costs r Chebyshev iterations in the panel layout.
    """
    return (1.0 - 1.0 / N_col) / (m.kappa * m.bc_over_bm + chi_panel)


def amortized_speedup(s: float, r: float, n: int) -> float:
    """Eq. (19): S = s·n / (n + 2r), filter degree n."""
    return s * n / (n + 2.0 * r)


def break_even_degree(s: float, r: float) -> float:
    """Eq. (20): n* = 2r / (s - 1); panel pays off for n > n*."""
    if s <= 1.0:
        return float("inf")
    return 2.0 * r / (s - 1.0)


def pillar_condition(chi_P: float) -> float:
    """Eq. (23): pillar pays off for n >= 2/χ[P]; always if χ[P] >= 2."""
    if chi_P <= 0:
        return float("inf")
    return 2.0 / chi_P
