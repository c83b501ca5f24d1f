"""Redistribution of the search block between the stack and panel layouts
(paper §3.4, Alg. 1 steps 7 and 9; the port's counterpart of
``repro/core/redistribute.py:53-102``).

The filter runs in a panel or pillar layout (the vertical layer active),
orthogonalization and the Ritz step in the stack layout; each filter pass
moves the block there and back. On one card both blocks are tensors of
the same device and the move is a device copy:

* stack: ``V [D_pad, N_s]`` over ``P = N_row·N_col`` row shards, shard
  ``b = i·N_col + k`` the rows ``[b·R_s, (b+1)·R_s)``;
* panel: ``Vp [N_col, D_pad, n_c]``, ``n_c = N_s / N_col``, bundle j the
  columns ``[j·n_c, (j+1)·n_c)`` of V, each a contiguous row-major block
  over the ``N_row`` panel-level row shards. ``to_stack`` takes the
  bundles back as such a tensor or as a sequence of N_col blocks (the
  filter's outputs, one a bundle).

Two implementations, bit-identical:

* ``explicit`` copies tile by tile, as the reference's tiled
  ``all_to_all`` along ``col`` sends them: the tile (stack shard (i, k),
  bundle j) goes to panel (i, j), at the same rows. Tiles with ``j == k``
  stay on their device in the reference; the others cross it.
* ``gspmd`` makes one strided copy and leaves the schedule to torch, as
  the reference leaves it to XLA (``with_sharding_constraint``).

Each move counts, on the stack group under ``"redistribute"``, what the
reference's collective sends off-device: ``N_s·D_pad·(1 − 1/N_col)·S``
bytes (Eqs. 17–18, :func:`redistribution_volume`). The copy on the card
reads and writes all ``N_s·D_pad·S`` bytes. At ``N_col = 1`` both
implementations are the identity (the block as one bundle, a view) and
count nothing.
"""
from __future__ import annotations

import torch

from .shards import ShardGroup

__all__ = ["REDIST_IMPLS", "make_redistribute", "redistribution_volume"]

#: Implementations of the redistribution (``FDConfig.redist_impl``).
REDIST_IMPLS = ("explicit", "gspmd")


def redistribution_volume(D: int, N_s: int, P_total: int, N_col: int,
                          S_d: int) -> dict:
    """Exact communication volumes of one redistribution (Eqs. 17–18),
    the reference's formula."""
    per_row = N_s * D * (N_col - 1) / P_total * S_d
    total = N_s * D * (1 - 1.0 / N_col) * S_d
    return {"bytes_per_process_row": per_row, "bytes_total": total}


def make_redistribute(group: ShardGroup, n_col: int, impl: str = "explicit"):
    """Return ``(to_panel, to_stack)`` for the stack ``group`` (its
    ``P = N_row·N_col`` row shards) and ``n_col`` column bundles:
    ``to_panel(V [D_pad, N_s]) -> [n_col, D_pad, N_s/n_col]`` and
    ``to_stack`` its inverse (from that tensor or a sequence of n_col
    ``[D_pad, N_s/n_col]`` bundles), each a new tensor, bit for bit the
    same values, counted on ``group`` under ``"redistribute"``; at
    ``n_col = 1`` views of the block, counting nothing."""
    if impl not in REDIST_IMPLS:
        raise ValueError(f"unknown redistribution impl {impl!r} "
                         f"(expected one of {REDIST_IMPLS})")
    P, n_col = group.P, int(n_col)
    if n_col < 1 or P % n_col:
        raise ValueError(f"{n_col} column bundles do not divide {P} shards")
    if n_col == 1:  # the layouts coincide: the block is the one bundle
        return (lambda V: V.unsqueeze(0)), (lambda bundles: bundles[0])

    def shape(D_pad: int, N_s: int) -> tuple[int, int]:
        if D_pad % P or N_s % n_col:
            raise ValueError(f"a [{D_pad}, {N_s}] block does not split into "
                             f"{P} row shards and {n_col} bundles")
        return D_pad // P, N_s // n_col

    def tiles(D_pad: int, n_c: int):
        """``(rows, j, columns, leaves)`` of every tile: stack shard
        ``b = i·N_col + k``'s part of bundle j, which leaves its device
        unless ``j == k``."""
        R_s = D_pad // P
        for b in range(P):
            rows = slice(b * R_s, (b + 1) * R_s)
            for j in range(n_col):
                yield rows, j, slice(j * n_c, (j + 1) * n_c), j != b % n_col

    def explicit(dst, src, D_pad: int, n_c: int, forward: bool) -> None:
        """Tile by tile; counts the tiles that leave their device."""
        moved = 0
        for rows, j, cols, leaves in tiles(D_pad, n_c):
            if forward:
                dst[j, rows] = src[rows, cols]
            else:
                dst[rows, cols] = src[j][rows]
            moved += leaves * (rows.stop - rows.start) * n_c
        group._record("redistribute", moved * dst.element_size())

    def gspmd(D_pad: int, n_c: int, S: int) -> None:
        group._record("redistribute", (n_col - 1) * D_pad * n_c * S)

    def to_panel(V: torch.Tensor) -> torch.Tensor:
        D_pad, N_s = V.shape
        _, n_c = shape(D_pad, N_s)
        if impl == "gspmd":
            out = V.reshape(D_pad, n_col, n_c).permute(1, 0, 2).contiguous()
            gspmd(D_pad, n_c, V.element_size())
        else:
            out = V.new_empty((n_col, D_pad, n_c))
            explicit(out, V, D_pad, n_c, True)
        return out

    def to_stack(bundles) -> torch.Tensor:
        if len(bundles) != n_col:
            raise ValueError(f"a panel block of {len(bundles)} bundles, "
                             f"expected {n_col}")
        D_pad, n_c = bundles[0].shape
        shape(D_pad, n_col * n_c)
        if impl == "gspmd":
            out = torch.cat(tuple(bundles), dim=1)
            gspmd(D_pad, n_c, out.element_size())
        else:
            out = bundles[0].new_empty((D_pad, n_col * n_c))
            explicit(out, bundles, D_pad, n_c, False)
        return out

    return to_panel, to_stack
