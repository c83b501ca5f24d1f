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

On ranks (one process per shard, ``core/ranks.py``) rank ``(i, k)``
holds stack shard ``b = i·N_col + k``, ``[R_s, N_s]``, and bundle k of
panel row-block i, ``[1, N_col·R_s, n_c]``. A move is one
``all_to_all_single`` within the panel row ``{i·N_col + k'}``
(``row_link``): ``to_panel`` sends the tile of bundle j to rank
``(i, j)``, which receives the tiles sender by sender, that is in row
order; ``to_stack`` sends each rank of the row its rows of the bundle and
puts the tiles it receives side by side. ``explicit`` packs the send
buffer tile by tile, ``gspmd`` in one strided copy; both send the same
bytes, so they stay bit-identical. Each rank counts its tiles that leave
it, ``(N_col − 1)·R_s·n_c·S``; summed over the ranks that is the one
process's count.
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


def make_redistribute(group: ShardGroup, n_col: int, impl: str = "explicit",
                      row_link=None):
    """Return ``(to_panel, to_stack)`` for the stack ``group`` (its
    ``P = N_row·N_col`` row shards) and ``n_col`` column bundles:
    ``to_panel(V [D_pad, N_s]) -> [n_col, D_pad, N_s/n_col]`` and
    ``to_stack`` its inverse (from that tensor or a sequence of n_col
    ``[D_pad, N_s/n_col]`` bundles), each a new tensor, bit for bit the
    same values, counted on ``group`` under ``"redistribute"``; at
    ``n_col = 1`` views of the block, counting nothing. On ranks
    (``group.link`` set) the blocks are the rank's (module docstring) and
    ``row_link`` is the transport of its panel row
    (``ShardGrid.row_link``)."""
    if impl not in REDIST_IMPLS:
        raise ValueError(f"unknown redistribution impl {impl!r} "
                         f"(expected one of {REDIST_IMPLS})")
    P, n_col = group.P, int(n_col)
    if n_col < 1 or P % n_col:
        raise ValueError(f"{n_col} column bundles do not divide {P} shards")
    if n_col == 1:  # the layouts coincide: the block is the one bundle
        return (lambda V: V.unsqueeze(0)), (lambda bundles: bundles[0])
    if group.link is not None:
        return _on_ranks(group, n_col, impl, row_link)

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

    def record(n_bytes: int, D_pad: int, n_c: int, forward: bool, src,
               dst) -> None:
        """Count one move; its trace entry reads ``src`` (a tensor or the
        bundles) and writes ``dst``, a shard's operand its full slice."""
        S = dst.element_size()
        traced = group.trace is not None
        group._record("redistribute", n_bytes,
                      label=("redistribute[to_panel]" if forward
                             else "redistribute[to_stack]"),
                      operand_bytes=D_pad // P * n_col * n_c * S,
                      reads=() if not traced else (src,) if forward
                      else tuple(src),
                      writes=(dst,))

    def explicit(dst, src, D_pad: int, n_c: int, forward: bool) -> None:
        """Tile by tile; counts the tiles that leave their device."""
        moved = 0
        for rows, j, cols, leaves in tiles(D_pad, n_c):
            if forward:
                dst[j, rows] = src[rows, cols]
            else:
                dst[rows, cols] = src[j][rows]
            moved += leaves * (rows.stop - rows.start) * n_c
        record(moved * dst.element_size(), D_pad, n_c, forward, src, dst)

    def gspmd(dst, src, D_pad: int, n_c: int, forward: bool) -> None:
        record((n_col - 1) * D_pad * n_c * dst.element_size(), D_pad, n_c,
               forward, src, dst)

    def to_panel(V: torch.Tensor) -> torch.Tensor:
        D_pad, N_s = V.shape
        _, n_c = shape(D_pad, N_s)
        if impl == "gspmd":
            out = V.reshape(D_pad, n_col, n_c).permute(1, 0, 2).contiguous()
            gspmd(out, V, D_pad, n_c, True)
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
            gspmd(out, bundles, D_pad, n_c, False)
        else:
            out = bundles[0].new_empty((D_pad, n_col * n_c))
            explicit(out, bundles, D_pad, n_c, False)
        return out

    return to_panel, to_stack


def _on_ranks(group: ShardGroup, n_col: int, impl: str, row_link):
    """``(to_panel, to_stack)`` of one rank (module docstring): its stack
    shard ``V [R_s, N_s]`` to its bundle ``[1, n_col·R_s, n_c]`` and back
    (from that tensor or a sequence of one ``[n_col·R_s, n_c]`` bundle)."""
    if row_link is None or row_link.size != n_col:
        raise ValueError(f"a rank's redistribution needs the transport of "
                         f"its panel row of {n_col} ranks, got {row_link}")

    def record(moved: int, operand: int, forward: bool, src, dst) -> None:
        traced = group.trace is not None
        group._record("redistribute", moved,
                      label=("redistribute[to_panel]" if forward
                             else "redistribute[to_stack]"),
                      operand_bytes=operand,
                      reads=() if not traced else (src,) if forward
                      else tuple(src),
                      writes=(dst,))

    def to_panel(V: torch.Tensor) -> torch.Tensor:
        R_s, N_s = V.shape
        if N_s % n_col:
            raise ValueError(f"{N_s} columns do not split into {n_col} "
                             "bundles")
        n_c = N_s // n_col
        if impl == "gspmd":
            send = V.reshape(R_s, n_col, n_c).permute(1, 0, 2).contiguous()
        else:
            send = V.new_empty((n_col, R_s, n_c))
            for j in range(n_col):
                send[j] = V[:, j * n_c:(j + 1) * n_c]
        out = V.new_empty((n_col, R_s, n_c))
        row_link.all_to_all(out, send).wait()
        S = V.element_size()
        record((n_col - 1) * R_s * n_c * S, R_s * N_s * S, True, V, out)
        return out.view(1, n_col * R_s, n_c)

    def to_stack(bundles) -> torch.Tensor:
        if len(bundles) != 1:
            raise ValueError(f"a rank holds one bundle, got {len(bundles)}")
        B = bundles[0]
        R_p, n_c = B.shape
        if R_p % n_col:
            raise ValueError(f"{R_p} bundle rows do not split into {n_col} "
                             "stack shards")
        R_s = R_p // n_col
        recv = B.new_empty((n_col, R_s, n_c))
        row_link.all_to_all(recv, B.reshape(n_col, R_s, n_c)).wait()
        if impl == "gspmd":
            out = recv.permute(1, 0, 2).reshape(R_s, n_col * n_c)
        else:
            out = B.new_empty((R_s, n_col * n_c))
            for j in range(n_col):
                out[:, j * n_c:(j + 1) * n_c] = recv[j]
        S = B.element_size()
        record((n_col - 1) * R_s * n_c * S, R_s * n_col * n_c * S, False,
               bundles, out)
        return out

    return to_panel, to_stack
