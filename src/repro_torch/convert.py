"""Carry the reference's host objects into the port.

The JAX package's operator and solver state, handed over as numpy arrays
(``np.asarray`` of its device arrays), become the port's tensors, real or
complex, so both packages can compute on the same operator and from the
same state:

* a ``DistEll`` of P row shards: ``cols/vals [P, R, W]`` (``[R, W]`` is
  taken as one shard), and where given its ``send_idx [P, P, L]``,
  ``pair_counts``, ``n_vc``, its split-phase blocks, its neighbour
  plans' arrays and its row map;
* a planned ``RowMap`` (``perm``, ``boundaries``, ``R``, ``P``,
  ``balance``, ``reorder``, ``sstep``);
* a ``DiaPlan``'s ``offsets/dvals`` (``[1, n_diag, R]`` or
  ``[n_diag, R]``);
* an ``FDState``'s search block ``V`` and interval ``lam``.

Each function puts its tensors on ``device``: the card unless ``"cpu"``
is given.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.filter_diag import FDState
from .core.partition import RowMap
from .core.spmv import DistEll, NeighborPlan
from .device import resolve_device
from .kernels.ops import DiaPlan
from .kernels.plan import span_of


def _one_shard(a: np.ndarray, ndim: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == ndim + 1:
        if a.shape[0] != 1:
            raise ValueError(f"{what}: {a.shape[0]} shards where one is "
                             "expected")
        a = a[0]
    if a.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {a.shape}")
    return a


def _span(cols: np.ndarray, vals: np.ndarray, send_idx: np.ndarray,
          R: int) -> int:
    """``max |col − row|`` over the stored entries in position numbering
    (the global one without a row map): a local column c of shard p is
    ``p·R + c``, a halo column ``R + q·L + s`` is row
    ``send_idx[q, p, s]`` of shard q."""
    P = cols.shape[0]
    L = send_idx.shape[2]
    c = cols.astype(np.int64)
    p = np.broadcast_to(np.arange(P, dtype=np.int64)[:, None, None], c.shape)
    glob = p * R + c
    halo = c >= R
    if halo.any():
        q, s = (c[halo] - R) // L, (c[halo] - R) % L
        glob[halo] = q * R + send_idx[q, p[halo], s]
    rows = np.broadcast_to(np.arange(P * R, dtype=np.int64).reshape(P, R, 1),
                           c.shape)
    stored = vals != 0
    return span_of(rows[stored], glob[stored])


def rowmap_from_arrays(D: int, P: int, perm, boundaries, R: int, *,
                       balance: str, reorder: str, sstep: int = 1) -> RowMap:
    """The port's :class:`RowMap` from a reference ``RowMap``'s fields
    (its host arrays ``perm`` and ``boundaries``, the rest scalars)."""
    return RowMap(D=int(D), P=int(P), balance=str(balance),
                  reorder=str(reorder),
                  perm=np.asarray(perm, dtype=np.int64).copy(),
                  boundaries=np.asarray(boundaries, dtype=np.int64).copy(),
                  R=int(R), sstep=int(sstep))


def dist_ell_from_arrays(cols, vals, D: int | None = None, *, send_idx=None,
                         pair_counts=None, n_vc=None, split=None, nbr=None,
                         rowmap: RowMap | None = None,
                         device=None) -> DistEll:
    """The port's operator from a reference ``DistEll``'s arrays.

    ``cols/vals`` ``[P, R, W]`` (or ``[R, W]``: one shard); ``send_idx``
    ``[P, P, L]`` (required when P > 1; ``L`` is its last extent);
    ``pair_counts``, ``n_vc`` host arrays; ``split`` the four
    arrays of ``DistEll.split()``; ``nbr`` maps a schedule name to a
    reference ``NeighborPlan`` or to a dict of its ``perms``,
    ``round_L``, ``send_nbr``, ``cols_nbr`` (and, when built,
    ``cols_halo_nbr`` and ``halo_rounds``); ``rowmap`` the map a mapped
    operator was built on (:func:`rowmap_from_arrays`), at either level
    (its ``D_pad`` is ``P·R``; the equal-rows ``RowMap.rows(D, P, P·R)``
    when none is given). The span is taken in position space, as
    ``build_dist_ell`` takes it."""
    dev = resolve_device(device)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if cols.ndim == 2:
        cols, vals = cols[None], vals[None]
    if cols.ndim != 3 or vals.shape != cols.shape:
        raise ValueError(f"cols {cols.shape} / vals {vals.shape}: expected "
                         "[P, R, W]")
    P, R, _ = cols.shape
    if send_idx is None:
        if P > 1:
            raise ValueError(f"{P} shards need their send_idx")
        send_idx = np.zeros((1, 1, 0), dtype=np.int32)
    send_idx = np.asarray(send_idx).astype(np.int32)
    L = int(send_idx.shape[2])
    if rowmap is None:
        rowmap = RowMap.rows(P * R if D is None else int(D), P, P * R)
    D = rowmap.D if D is None else int(D)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    ell = DistEll(cols=t(cols.astype(np.int32)), vals=t(vals),
                  send_idx=t(send_idx), R=R, L=L, P=P, D=D,
                  n_vc=None if n_vc is None else np.asarray(n_vc),
                  pair_counts=(None if pair_counts is None
                               else np.asarray(pair_counts)),
                  span=_span(cols, vals, send_idx, R), rowmap=rowmap)
    if rowmap.D_pad != P * R:
        raise ValueError(f"the row map's D_pad={rowmap.D_pad} is not the "
                         f"operator's {P}·{R}")
    if split is not None:
        ell.cols_loc, ell.vals_loc, ell.cols_halo, ell.vals_halo = (
            t(a) for a in split)
    if nbr:
        ell.nbr = {}
        for name, plan in nbr.items():
            get = (plan.get if isinstance(plan, dict)
                   else lambda k, d=None, p=plan: getattr(p, k, d))
            rounds = get("halo_rounds")
            halo = get("cols_halo_nbr")
            ell.nbr[name] = NeighborPlan(
                perms=tuple(tuple((int(s), int(d)) for s, d in perm)
                            for perm in get("perms")),
                round_L=tuple(int(x) for x in get("round_L")),
                send_nbr=t(np.asarray(get("send_nbr")).astype(np.int32)),
                cols_nbr=t(np.asarray(get("cols_nbr")).astype(np.int32)),
                cols_halo_nbr=None if halo is None else t(halo),
                halo_rounds=None if rounds is None else tuple(
                    (t(c), t(v)) for c, v in rounds))
    return ell


def dia_plan_from_arrays(offsets, dvals, device=None) -> DiaPlan:
    """The port's DIA plan from a ``DiaPlan``'s ``offsets/dvals``."""
    dvals = _one_shard(dvals, 2, "dvals")
    return DiaPlan(offsets=tuple(int(o) for o in offsets),
                   dvals=torch.tensor(dvals, device=resolve_device(device)))


def fd_state_from_arrays(V, lam, *, iteration: int = 0, total_spmvs: int = 0,
                         device=None) -> FDState:
    """An :class:`FDState` at an iteration boundary from ``V [D_pad, N_s]``
    and the Lanczos interval ``lam``."""
    V = np.asarray(V)
    return FDState(V=torch.tensor(V, device=resolve_device(device)),
                   lam=(float(lam[0]), float(lam[1])),
                   iteration=iteration, total_spmvs=total_spmvs)
