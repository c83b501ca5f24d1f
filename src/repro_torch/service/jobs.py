"""Resumable FilterDiag jobs: the FDState ↔ checkpoint bridge and the job
driver (the port's counterpart of ``repro/service/jobs.py``).

``FilterDiag.step`` advances an explicit :class:`~repro_torch.core.
filter_diag.FDState` one outer iteration at a time; this module makes
that state durable. A state at an iteration boundary is split into

* **tensor leaves**, saved by ``checkpoint.save``: the search block ``V``
  and the finished result's ``eigenvectors`` (``[D, 0]`` until the solve
  is done);
* a **JSON extra**: the Lanczos interval, the iteration counter, the
  SpMV and redistribution tallies, the history, the finished result (its
  ``exchange`` summary too), the solver's running counters
  (``FilterDiag.counters``: the shard groups' bytes and calls and the
  filter's halo exchanges) and the row map's fingerprint. Floats survive
  the JSON round trip exactly (repr), so a restored solve continues on
  bit-identical host data, and its ``FDResult.exchange`` equals the
  uninterrupted solve's. The restarts themselves are counted apart, in
  ``Supervisor.restarts``.

The row map a planned partition solved on is not saved: the job is
rebuilt from its config (matrix and plan), and ``plan_rowmap`` is
deterministic. The extra records the map's fingerprint and
:func:`unpack_state` refuses to resume onto another.

On ranks (a solver with ``ranks``) :func:`pack_state` gathers the whole
``V`` to every rank (``ShardGroup.gather_rows``, collective) and the
counters summed over the ranks (``FilterDiag.counters``), so the leaves
and the extra are the one process's: a checkpoint does not depend on how
many processes wrote it (rank 0 alone writes it, ``checkpoint/``), and
:func:`unpack_state` keeps each rank's rows of the restored block and its
share of the counters (``FilterDiag.set_counters``). A rank launch
resumes a one-process checkpoint of the same grid and row map, and the
other way round.

:class:`FilterDiagJob` is the protocol ``Supervisor.run_job`` drives:
template / init / step / done / step_index / pack / unpack, with the
solver's ``device`` (restored leaves go there) and ``grid``.
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from ..core.filter_diag import FDResult, FDState, FilterDiag

__all__ = ["rowmap_fingerprint", "pack_state", "unpack_state",
           "state_template", "stack_spec", "FilterDiagJob"]


def rowmap_fingerprint(rowmap) -> str | None:
    """Stable fingerprint of a planned row decomposition (the reference's
    hash of ``D/P/R/sstep``, the permutation and the boundaries); None for
    the equal-rows identity partition (``balance="rows"``,
    ``reorder="none"``), which the reference's solver holds as no map."""
    if rowmap is None or (rowmap.balance, rowmap.reorder) == ("rows", "none"):
        return None
    h = hashlib.sha256()
    h.update(f"{rowmap.D}/{rowmap.P}/{rowmap.R}/{rowmap.sstep}".encode())
    h.update(np.ascontiguousarray(rowmap.perm, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(rowmap.boundaries,
                                  dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def stack_spec() -> list:
    """The stack block's spec in the manifest, as the reference writes
    ``P(("row", "col"), None)``: rows over every shard, columns whole."""
    return [["row", "col"], None]


def _result_to_json(r: FDResult | None):
    if r is None:
        return None
    return {
        "eigenvalues": [float(x) for x in np.asarray(r.eigenvalues)],
        "residuals": [float(x) for x in np.asarray(r.residuals)],
        "n_converged": int(r.n_converged), "iterations": int(r.iterations),
        "total_spmvs": int(r.total_spmvs),
        "redistributions": int(r.redistributions),
        "wall_time": float(r.wall_time), "redist_time": float(r.redist_time),
        "history": r.history, "exchange": r.exchange,
    }


def _result_from_json(j, eigenvectors) -> FDResult | None:
    if j is None:
        return None
    return FDResult(
        eigenvalues=np.asarray(j["eigenvalues"]),
        residuals=np.asarray(j["residuals"]),
        n_converged=int(j["n_converged"]), iterations=int(j["iterations"]),
        total_spmvs=int(j["total_spmvs"]),
        redistributions=int(j["redistributions"]),
        wall_time=float(j["wall_time"]), redist_time=float(j["redist_time"]),
        history=_history_from_json(j["history"]),
        eigenvectors=eigenvectors.cpu().numpy(), exchange=j["exchange"])


def _history_from_json(hist) -> list:
    """JSON turns tuples into lists: restore the search interval and each
    ``(theta, residual)`` of the window's unconverged pairs at the stop."""
    out = []
    for h in hist:
        h = dict(h, search=tuple(h["search"]))
        if "unconverged" in h:
            h["unconverged"] = [tuple(p) for p in h["unconverged"]]
        out.append(h)
    return out


def pack_state(state: FDState, fd: FilterDiag) -> tuple[dict, dict]:
    """(tensor leaves, extra) of a state at an iteration boundary (on
    ranks every rank calls it and gets the whole block)."""
    if state.pending is not None:
        raise ValueError("a state is checkpointed only at an iteration "
                         "boundary (a filter is pending)")
    r = state.result
    X = (torch.as_tensor(r.eigenvectors) if r is not None
         else torch.zeros((fd.D, 0), dtype=fd.dtype))
    extra = {
        "lam": [float(state.lam[0]), float(state.lam[1])],
        "iteration": int(state.iteration),
        "total_spmvs": int(state.total_spmvs),
        "redistributions": int(state.redistributions),
        "redist_time": float(state.redist_time),
        "wall_time": float(state.wall_time),
        "history": state.history,
        "done": bool(state.done),
        "result": _result_to_json(r),
        "counters": fd.counters(),
        "rowmap": rowmap_fingerprint(fd.rowmap),
    }
    return {"V": fd.group.gather_rows(state.V), "eigenvectors": X}, extra


def unpack_state(tree: dict, extra: dict, fd: FilterDiag) -> FDState:
    """Rebuild an FDState from a restored (leaves, extra) pair and set the
    solver's running counters to the saved ones, after checking that the
    solver's row decomposition is the one checkpointed."""
    saved = extra.get("rowmap")
    here = rowmap_fingerprint(fd.rowmap)
    if saved != here:
        raise ValueError(f"checkpointed rowmap {saved!r} does not match the "
                         f"solver's {here!r} — a solve must resume on the "
                         f"row decomposition it was planned with")
    fd.set_counters(extra["counters"])
    V = tree["V"].to(device=fd.device, dtype=fd.dtype)
    if fd.ranks:  # this rank's rows of the whole block
        V = V[fd._rows].contiguous()
    return FDState(
        V=V, lam=tuple(extra["lam"]),
        iteration=int(extra["iteration"]),
        total_spmvs=int(extra["total_spmvs"]),
        redistributions=int(extra["redistributions"]),
        redist_time=float(extra["redist_time"]),
        wall_time=float(extra["wall_time"]),
        history=_history_from_json(extra["history"]),
        done=bool(extra["done"]),
        result=_result_from_json(extra.get("result"), tree["eigenvectors"]),
    )


def state_template(fd: FilterDiag) -> dict:
    """Zero leaves with the checkpointed structure on the solver's device
    — what ``checkpoint.restore`` needs to rebuild a state without the
    Lanczos init. (A finished result's eigenvectors restore at their
    saved width.)"""
    return {"V": torch.zeros((fd.D_pad, fd.cfg.n_search), dtype=fd.dtype,
                             device=fd.device),
            "eigenvectors": torch.zeros((fd.D, 0), dtype=fd.dtype)}


class FilterDiagJob:
    """One resumable solve: the protocol ``Supervisor.run_job`` drives.

    ``init`` runs Lanczos and draws the search block (``FilterDiag.
    init_state``, from ``V0``/``v0`` when given), ``step``
    is one outer FD iteration, ``pack``/``unpack`` bridge to
    ``checkpoint/``. Restored leaves land on the solver's device; the
    manifest records the solver's grid. On ranks ``link`` is the
    launch's transport, for the ``Supervisor`` that drives the job, and
    ``agree`` checks that every rank holds the same values."""

    def __init__(self, fd: FilterDiag, V0=None, v0=None,
                 verbose: bool = False):
        self.fd = fd
        self.V0, self.v0 = V0, v0
        self.verbose = verbose
        self.device = fd.device
        self.grid = (fd.N_row, fd.N_col)
        self.link = fd.group.link
        self.specs = {"V": stack_spec(), "eigenvectors": None}

    def agree(self, *values) -> None:
        self.fd.group.check_agreed(*values)

    def template(self) -> dict:
        return state_template(self.fd)

    def init(self) -> FDState:
        return self.fd.init_state(V0=self.V0, v0=self.v0)

    def step(self, state: FDState) -> FDState:
        return self.fd.step(state, verbose=self.verbose)

    def done(self, state: FDState) -> bool:
        return state.done

    def step_index(self, state: FDState) -> int:
        return state.iteration

    def pack(self, state: FDState) -> tuple[dict, dict]:
        return pack_state(state, self.fd)

    def unpack(self, tree: dict, extra: dict) -> FDState:
        return unpack_state(tree, extra, self.fd)

    def result(self, state: FDState) -> Any:
        return state.result
