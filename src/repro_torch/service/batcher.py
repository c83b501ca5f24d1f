"""Request queue and batcher: the vertical layer as a batching dimension
(the port's counterpart of ``repro/service/batcher.py``).

Every SpMV and filter operation of the grid acts on each column on its
own: ``spmv(V)[:, j]`` depends only on ``V[:, j]``, the Chebyshev
recurrence is elementwise over columns, and the stack↔panel
redistribution only moves values. So the search blocks of different
filter-diagonalization requests can share one panel: the batcher
concatenates the pending blocks of compatible requests into one
``[D_pad, Σ n_b]`` block, runs one redistribution, Chebyshev sweep and
redistribution back (``FilterDiag.filter_block``), and hands each request
its own columns back, with the bits of serving it alone through the
service.

Compatible means the same ``pattern_hash`` (the same operator), the same
planned engine cell (every axis of the winning
:class:`~repro_torch.core.planner.Candidate`), the same ``n_search`` and
dtype. Requests differ in target, tolerance, n_target and seed. Each
request's orthogonalization and Ritz extraction run on its own block (the
operations a solo solve runs; no Gram matrix mixes the requests), and its
filter polynomial rides the shared sweep as its columns of a per-column
``μ`` (``chebyshev_filter``), zero-padded to the longest degree: ``Y +
0·T_k`` is ``Y``, so a request batched with a higher-degree neighbour
computes its own filter. The launches of the shared sweep are those of
the longest filter, not the sum of the requests'.

The Lanczos interval belongs to the operator, not to a request, so the
group computes it once, from the service seed; this also makes a
request's result independent of its neighbours. Each request's search
block is drawn from its own seed, the draw a solo ``FilterDiag.
init_state`` with that seed makes. s-step cells (``spmv_sstep > 1``)
filter each request on its own (the s-step filter takes a 1-D ``μ``);
the analyze steps still share the solver.

:class:`BatchedJob` wraps a group in the resumable-job protocol, so a
batch checkpoints and resumes through ``runtime/supervisor.py`` as a solo
job does. :class:`EigenService` is the front end: submit requests,
``drain()`` plans each distinct pattern once (through the persistent
plan cache) over ``n_shards`` row shards on the service's device, groups
compatible requests, and returns each request's
:class:`~repro_torch.core.filter_diag.FDResult`.

With ``ranks`` the service is one rank of a launch of ``n_shards``
ranks (``core/ranks.py``): every rank takes the same requests in the
same order, rank 0 alone plans each pattern and reads and writes the
plan cache (the plan goes to every rank), each group runs on the rank
grid of its planned split, its checkpoints written by rank 0 behind a
barrier, and every rank gets every result.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from ..core import perf_model as pm
from ..core.filter_diag import FDConfig, FDResult, FDState, FilterDiag
from ..core.planner import Candidate, config_for
from ..matrices import get_family
from ..runtime import StragglerWatchdog, Supervisor, SupervisorConfig
from .jobs import pack_state, stack_spec, state_template, unpack_state
from .plan_cache import PlanCache, cached_plan_layout, pattern_hash

__all__ = ["SolveRequest", "request_compat_key", "BatchedJob",
           "EigenService"]


@dataclasses.dataclass
class SolveRequest:
    """One tenant's eigenproblem: which operator, which eigenpairs.

    ``family``/``params`` name the matrix (``matrices.get_family``); a
    built matrix or CSR can be passed as ``matrix`` instead. The engine
    is not part of a request: the service plans it (or takes the cached
    plan) per pattern.
    """

    req_id: str
    family: str | None = None
    params: dict = dataclasses.field(default_factory=dict)
    n_target: int = 4
    n_search: int = 16
    target: float = 0.0
    tol: float = 1e-9
    max_iters: int = 40
    seed: int = 7
    matrix: Any = None

    def resolve_matrix(self):
        if self.matrix is not None:
            return self.matrix
        if self.family is None:
            raise ValueError(f"request {self.req_id}: neither family nor "
                             f"matrix given")
        return get_family(self.family, **self.params)


def request_compat_key(phash: str, best: Candidate, n_search: int,
                       dtype: str) -> tuple:
    """Requests sharing this key may share one panel: the same operator
    pattern, the same engine cell (every planned axis), the same block
    width and dtype."""
    return (phash, best.layout, best.n_row, best.n_col, best.overlap,
            best.comm, best.schedule, best.balance, best.reorder,
            best.kernel, best.sstep, n_search, dtype)


@dataclasses.dataclass
class _Entry:
    """One request's slot in a batch group."""

    req: SolveRequest
    cfg: FDConfig
    state: FDState | None = None


class BatchedJob:
    """A group of compatible requests as one resumable job.

    The state is the dict of the requests' :class:`FDState`; one job
    ``step`` advances every active request by one outer iteration: each
    request's analyze on its own block, then one shared filter sweep over
    the pending blocks. It is the protocol ``Supervisor.run_job`` drives
    (template / init / step / done / step_index / pack / unpack, with the
    solver's ``device`` and ``grid``), so fault injection and resume work
    as for a solo job.

    ``v0`` (the Lanczos start, ``[D_pad]`` in position space) and ``V0``
    (``{req_id: [D or D_pad, n_search]}``) replace the draws from the
    service seed and the request seeds (the tests pass the reference's,
    ``convert.batch_draws_from_arrays``).
    """

    def __init__(self, fd: FilterDiag, requests: list[SolveRequest],
                 service_seed: int = 0, verbose: bool = False,
                 v0=None, V0: dict | None = None):
        n = fd.cfg.n_search
        for r in requests:
            if r.n_search != n:
                raise ValueError(f"request {r.req_id}: n_search "
                                 f"{r.n_search} != the group's {n}")
        self.fd = fd
        self.verbose = verbose
        self.service_seed = service_seed
        self.v0, self.V0 = v0, dict(V0 or {})
        self.entries = [
            _Entry(req=r, cfg=dataclasses.replace(
                fd.cfg, n_target=r.n_target, target=r.target, tol=r.tol,
                max_iters=r.max_iters, seed=r.seed))
            for r in requests]
        self.device = fd.device
        self.grid = (fd.N_row, fd.N_col)
        self.link = fd.group.link
        self.specs = {e.req.req_id: {"V": stack_spec(), "eigenvectors": None}
                      for e in self.entries}

    def agree(self, *values) -> None:
        """Raise unless every rank holds the same ``values`` (nothing in
        one process)."""
        self.fd.group.check_agreed(*values)

    # ---------------------------------------------------- job protocol --
    def template(self) -> dict:
        return {e.req.req_id: state_template(self.fd) for e in self.entries}

    def init(self) -> dict:
        """The group's Lanczos interval (an operator property, from the
        service seed, so the results do not depend on the batch) and each
        request's search block from its own seed: the draw a solo
        ``FilterDiag.init_state`` makes, its generator first advanced past
        the Lanczos vector, as the reference's key split is."""
        fd = self.fd
        t0 = time.perf_counter()
        v = (fd.lanczos_start(fd.generator(self.service_seed))
             if self.v0 is None
             else fd._place(self.v0, row_order=False).reshape(-1, 1))
        lam = fd.lanczos(v)
        dt = time.perf_counter() - t0
        for e in self.entries:
            rid = e.req.req_id
            if rid in self.V0:
                V = fd._place(self.V0[rid], row_order=True)
            else:
                gen = fd.generator(e.cfg.seed)
                fd.lanczos_start(gen)
                V = fd.random_search_vectors(gen)
            e.state = FDState(V=V, lam=lam, total_spmvs=fd.cfg.lanczos_steps,
                              wall_time=dt)
        return {e.req.req_id: e.state for e in self.entries}

    def step(self, states: dict) -> dict:
        fd = self.fd
        for e in self.entries:
            e.state = states[e.req.req_id]
        active = [e for e in self.entries if not e.state.done]
        # each request's analyze on its own block: the operations (TSQR,
        # Ritz, the host logic) a solo solve runs on it
        for e in active:
            e.state = fd.step_analyze(e.state, cfg=e.cfg,
                                      verbose=self.verbose)
        pend = [e for e in active if not e.state.done]
        if pend:
            if fd.cheb_sstep is not None:
                # the s-step filter takes a 1-D mu: one request at a time
                for e in pend:
                    e.state = fd.step_filter(e.state, cfg=e.cfg)
            else:
                self._filter_batched(pend)
        return {e.req.req_id: e.state for e in self.entries}

    def _filter_batched(self, pend: list[_Entry]) -> None:
        """One shared Chebyshev sweep over the pending blocks, side by
        side, each request's μ in its columns, zero-padded to the longest
        degree; each request gets its own columns back as a contiguous
        block (the shape a solo filter returns)."""
        fd = self.fd
        t0 = time.perf_counter()
        lam = pend[0].state.lam
        widths = [e.cfg.n_search for e in pend]
        degrees = [e.state.pending[1] for e in pend]
        n_max = max(degrees)
        Mu = np.zeros((n_max + 1, sum(widths)))
        col = 0
        for e, w in zip(pend, widths):
            mu, deg = e.state.pending
            Mu[: deg + 1, col: col + w] = np.asarray(mu)[:, None]
            col += w
        blocks = [e.state.V for e in pend]
        for e in pend:
            e.state.V = None
        tally = FDState(V=None, lam=lam)
        V = fd.filter_block(torch.cat(blocks, dim=1), Mu, n_max, lam, tally)
        del blocks
        dt = time.perf_counter() - t0
        col = 0
        for e, w, deg in zip(pend, widths, degrees):
            st = e.state
            st.V = V[:, col: col + w].contiguous()
            col += w
            st.pending = None
            st.iteration += 1
            # solo accounting: the request's own degree and width
            st.total_spmvs += deg * w
            st.history[-1]["degree"] = deg
            st.history[-1]["exchanges"] = fd.exchanges_per_filter(deg)
            st.redistributions += tally.redistributions
            st.redist_time += tally.redist_time
            st.wall_time += dt

    def done(self, states: dict) -> bool:
        return all(s.done for s in states.values())

    def step_index(self, states: dict) -> int:
        return max(s.iteration for s in states.values())

    def pack(self, states: dict) -> tuple[dict, dict]:
        trees, extras = {}, {}
        for rid, s in states.items():
            trees[rid], extras[rid] = pack_state(s, self.fd)
        return trees, {"requests": extras}

    def unpack(self, trees: dict, extra: dict) -> dict:
        out = {}
        for e in self.entries:
            rid = e.req.req_id
            e.state = unpack_state(trees[rid], extra["requests"][rid],
                                   self.fd)
            out[rid] = e.state
        return out

    def results(self, states: dict) -> dict[str, FDResult]:
        return {rid: s.result for rid, s in states.items()}


class EigenService:
    """Multi-tenant front end: submit requests, drain to results.

    ``drain()`` resolves each distinct sparsity pattern once, plans it
    over ``n_shards`` row shards through the persistent plan cache (a
    repeat pattern skips the planner; ``machine`` defaults to the
    builtin ``h100-1card``), groups the requests by
    :func:`request_compat_key`, and runs each group as one
    :class:`BatchedJob` on ``device`` (the card unless ``"cpu"``):
    supervised with checkpoint/resume when ``ckpt_root`` is given, a
    plain loop otherwise. ``spmv_kernel`` is the planner's kernel axis
    (with it a group runs the CUDA kernels), as the CLI's ``--layout
    auto`` takes it. The groups solve in float64, as the reference's do.

    After a drain, ``groups`` describes each group run (its planned cell,
    requests, block and bundle widths, restarts and wall time) and
    ``restarts`` counts the failures recovered from.

    With ``ranks`` this is one rank of a launch of ``n_shards`` ranks
    (module docstring); ``device`` is the rank's own.
    """

    def __init__(self, *, n_shards: int = 1, device=None,
                 spmv_kernel: bool = False,
                 plan_cache: PlanCache | None = None,
                 machine: pm.MachineModel | None = None,
                 ckpt_root: str | None = None, service_seed: int = 0,
                 supervisor_cfg: SupervisorConfig | None = None,
                 verbose: bool = False, ranks: bool = False):
        self.n_shards = int(n_shards)
        self.ranks = bool(ranks)
        self.device = device
        self.spmv_kernel = bool(spmv_kernel)
        self.plan_cache = plan_cache
        self.machine = machine if machine is not None else pm.H100_1CARD
        self.ckpt_root = ckpt_root
        self.service_seed = service_seed
        self.supervisor_cfg = supervisor_cfg or SupervisorConfig(
            checkpoint_interval=1, keep_checkpoints=3)
        self.verbose = verbose
        self.queue: list[SolveRequest] = []
        self.plans: dict[tuple, Any] = {}  # (pattern hash, n_search) -> Plan
        self.cache_hits = 0
        self.groups: list[dict] = []
        self.restarts = 0

    def submit(self, req: SolveRequest) -> str:
        if any(r.req_id == req.req_id for r in self.queue):
            raise ValueError(f"duplicate request id {req.req_id!r}")
        self.queue.append(req)
        return req.req_id

    # ------------------------------------------------------------------
    def _plan(self, matrix, n_search: int):
        phash = pattern_hash(matrix)
        pkey = (phash, n_search)  # the chosen n_col must divide n_search
        if pkey not in self.plans:
            P = self.n_shards
            D = matrix.shape[0] if hasattr(matrix, "shape") else matrix.D
            plan, hit = cached_plan_layout(
                matrix, P, n_search=n_search, cache=self.plan_cache,
                machine=self.machine, d_pad=-(-D // P) * P,
                kernel=(self.spmv_kernel,), ranks=self.ranks,
                device=self.device)
            self.plans[pkey] = plan
            self.cache_hits += int(hit)
        return phash, self.plans[pkey]

    def drain(self, fault_hook=None) -> dict[str, FDResult]:
        """Solve every queued request; returns ``{req_id: FDResult}``."""
        groups: dict[tuple, list] = {}
        mats: dict[tuple, Any] = {}
        plans: dict[tuple, Candidate] = {}
        for req in self.queue:
            mat = req.resolve_matrix()
            phash, plan = self._plan(mat, req.n_search)
            best = plan.best
            ckey = request_compat_key(phash, best, req.n_search, "float64")
            groups.setdefault(ckey, []).append(req)
            mats.setdefault(ckey, mat)
            plans.setdefault(ckey, best)
        self.queue = []
        self.groups = []
        results: dict[str, FDResult] = {}
        for i, (ckey, reqs) in enumerate(groups.items()):
            results.update(self._run_group(
                mats[ckey], plans[ckey], reqs, group_idx=i,
                fault_hook=fault_hook))
        return results

    def _run_group(self, mat, best: Candidate, reqs: list[SolveRequest],
                   group_idx: int, fault_hook=None) -> dict[str, FDResult]:
        # the candidate's split of the shards realizes its layout, its row
        # map is used as planned (the CLI's --layout auto convention)
        cfg = config_for(FDConfig(n_search=reqs[0].n_search,
                                  seed=self.service_seed), best)
        t0 = time.perf_counter()
        fd = FilterDiag(mat, cfg, device=self.device, n_row=best.n_row,
                        n_col=best.n_col, rowmap=best.rowmap,
                        ranks=self.ranks)
        job = BatchedJob(fd, reqs, service_seed=self.service_seed,
                         verbose=self.verbose)
        restarts = 0
        if self.ckpt_root is not None:
            sup = Supervisor(os.path.join(self.ckpt_root,
                                          f"group_{group_idx:03d}"),
                             self.supervisor_cfg, link=job.link)
            states = sup.run_job(job, fault_hook=fault_hook,
                                 watchdog=StragglerWatchdog())
            restarts = sup.restarts
        else:
            states = job.init()
            while not job.done(states):
                states = job.step(states)
        fd._sync()
        width = sum(r.n_search for r in reqs)
        self.restarts += restarts
        self.groups.append(dict(
            cell=best.describe(), requests=[r.req_id for r in reqs],
            width=width, bundle_width=width // fd.N_col, restarts=restarts,
            wall_s=time.perf_counter() - t0))
        return job.results(states)
