"""Carry the reference's host objects into the port.

The JAX package's operator and solver state, handed over as numpy arrays
(``np.asarray`` of its device arrays), become the port's tensors, real or
complex, so both packages can compute on the same operator and from the
same state:

* a one-shard ``DistEll``'s ``cols/vals`` ([1, R, W] or [R, W]);
* a ``DiaPlan``'s ``offsets/dvals`` ([1, n_diag, R] or [n_diag, R]);
* an ``FDState``'s search block ``V`` and interval ``lam``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.filter_diag import FDState
from .core.spmv import DistEll
from .kernels.ops import DiaPlan
from .kernels.plan import span_of_ell


def _one_shard(a: np.ndarray, ndim: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == ndim + 1:
        if a.shape[0] != 1:
            raise NotImplementedError(f"{what}: {a.shape[0]} shards; only one "
                                      "is ported yet, see ROADMAP")
        a = a[0]
    if a.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {a.shape}")
    return a


def dist_ell_from_arrays(cols, vals, D: int | None = None,
                         device="cpu") -> DistEll:
    """The port's operator from a P = 1 ``DistEll``'s ``cols/vals``."""
    cols = _one_shard(cols, 2, "cols").astype(np.int32)
    vals = _one_shard(vals, 2, "vals")
    R = cols.shape[0]
    cols_t = torch.tensor(cols, device=device)
    vals_t = torch.tensor(vals, device=device)
    return DistEll(cols=cols_t, vals=vals_t, R=R, D=R if D is None else int(D),
                   span=span_of_ell(cols_t, vals_t))


def dia_plan_from_arrays(offsets, dvals, device="cpu") -> DiaPlan:
    """The port's DIA plan from a ``DiaPlan``'s ``offsets/dvals``."""
    dvals = _one_shard(dvals, 2, "dvals")
    return DiaPlan(offsets=tuple(int(o) for o in offsets),
                   dvals=torch.tensor(dvals, device=device))


def fd_state_from_arrays(V, lam, *, iteration: int = 0, total_spmvs: int = 0,
                         device="cpu") -> FDState:
    """An :class:`FDState` at an iteration boundary from ``V [D, N_s]`` and
    the Lanczos interval ``lam``."""
    V = np.asarray(V)
    return FDState(V=torch.tensor(V, device=device),
                   lam=(float(lam[0]), float(lam[1])),
                   iteration=iteration, total_spmvs=total_spmvs)
