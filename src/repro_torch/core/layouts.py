"""Distributed vector layouts of the D × N_s search block (the port's
counterpart of ``repro/core/layouts.py:54-110``).

The horizontal layer slices the D axis over ``n_row`` row shards (the
SpMV's halo exchange runs along it), the vertical layer the N_s axis over
``n_col`` column bundles (no SpMV communication crosses it). ``stack`` is
``n_col = 1``, ``pillar`` ``n_row = 1``, ``panel`` anything between; a
panel with ``n_col = 1`` is the stack layout, as in the reference.

The port realises a layout over a :class:`~repro_torch.core.shards.
ShardGrid` on one device (:meth:`Layout.shards`): in the stack layout the
block is one ``[D_pad, N_s]`` tensor over ``n_row·n_col`` row shards; in a
panel or pillar layout it is ``[n_col, D_pad, N_s/n_col]``, each bundle a
contiguous ``[D_pad, n_c]`` tensor over ``n_row`` row shards
(``core/redistribute.py`` moves a block between the two). On ranks
(``Layout.shards(ranks=True)``, one process per shard) each rank holds
its stack shard's rows and its own bundle's rows of its panel row-block.
"""
from __future__ import annotations

import dataclasses

from .shards import ShardGrid

__all__ = ["Layout", "stack", "panel", "pillar", "layout_on_grid",
           "LAYOUTS"]

LAYOUTS = ("stack", "panel", "pillar")


@dataclasses.dataclass(frozen=True)
class Layout:
    """A layout of the D × N_s block over ``n_row × n_col`` shards."""

    name: str
    n_row: int
    n_col: int = 1

    def __post_init__(self):
        if self.name not in LAYOUTS:
            raise ValueError(f"unknown layout {self.name!r} "
                             f"(expected one of {LAYOUTS})")
        if self.n_row < 1 or self.n_col < 1:
            raise ValueError(f"layout {self.name!r} needs n_row, n_col >= 1,"
                             f" got {self.n_row}x{self.n_col}")
        if (self.name == "stack" and self.n_col != 1) or (
                self.name == "pillar" and self.n_row != 1):
            raise ValueError(f"a {self.name} layout cannot be "
                             f"{self.n_row}x{self.n_col}")

    @property
    def P(self) -> int:
        """All shards, ``n_row·n_col``."""
        return self.n_row * self.n_col

    def shards(self, device=None, ranks: bool = False,
               members=None) -> ShardGrid:
        """The grid of this layout's shards on ``device``; with ``ranks``
        this rank's part of it, one rank a shard (``ShardGrid``; over
        ``members`` of the world when given)."""
        return ShardGrid(self.n_row, self.n_col, device, ranks=ranks,
                         members=members)

    def describe(self) -> str:
        return f"{self.name}({self.n_row}x{self.n_col})"


def stack(n_row: int) -> Layout:
    """N_col = 1: D sharded over every shard."""
    return Layout("stack", n_row, 1)


def pillar(n_col: int) -> Layout:
    """N_row = 1: N_s sharded over every shard (a comm-free SpMV)."""
    return Layout("pillar", 1, n_col)


def panel(n_row: int, n_col: int) -> Layout:
    """An N_row × N_col panel."""
    return Layout("panel", n_row, n_col)


def layout_on_grid(name: str, n_row: int, n_col: int) -> Layout:
    """The layout ``name`` on an ``n_row × n_col`` grid, as the reference's
    ``planner.layout_on_mesh`` (``repro/core/planner.py:1004-1024``) puts
    it on a mesh: ``stack`` is ``P × 1``, ``panel`` ``n_row × n_col`` and
    ``pillar`` ``1 × P``, with ``P = n_row·n_col``."""
    P = int(n_row) * int(n_col)
    if name == "stack":
        return stack(P)
    if name == "pillar":
        return pillar(P)
    if name == "panel":
        return panel(int(n_row), int(n_col))
    raise ValueError(f"unknown layout {name!r} (expected one of {LAYOUTS})")
