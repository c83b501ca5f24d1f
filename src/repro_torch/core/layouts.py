"""Distributed vector layouts of the D × N_s search block (the port's
counterpart of ``repro/core/layouts.py:54-110``).

The horizontal layer slices the D axis over ``n_row`` row shards (the
SpMV's halo exchange runs along it), the vertical layer the N_s axis over
``n_col`` column bundles (no SpMV communication crosses it). ``stack`` is
``n_col = 1``, ``pillar`` ``n_row = 1``, ``panel`` anything between.

The port realises ``stack`` over a :class:`~repro_torch.core.shards.
ShardGroup` on one device (:meth:`Layout.shards`): P row shards of one
``[D_pad, n_b]`` tensor. ``panel`` and ``pillar`` keep their names and
raise until the vertical layer is ported.
"""
from __future__ import annotations

import dataclasses

from .shards import ShardGroup

__all__ = ["Layout", "stack", "panel", "pillar", "LAYOUTS"]

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
        if self.name != "stack" or self.n_col != 1:
            raise NotImplementedError(
                f"layout {self.name!r} ({self.n_row}x{self.n_col}): only the "
                "stack layout (n_col = 1) is ported yet; the vertical layer "
                "is not, see ROADMAP")
        if self.n_row < 1:
            raise ValueError(f"n_row must be >= 1, got {self.n_row}")

    def shards(self, device=None) -> ShardGroup:
        """The row shards of this layout on ``device``."""
        return ShardGroup(self.n_row, device)

    def describe(self) -> str:
        return f"{self.name}({self.n_row}x{self.n_col})"


def stack(n_row: int) -> Layout:
    """N_col = 1: D sharded over every shard."""
    return Layout("stack", n_row, 1)


def pillar(n_col: int) -> Layout:
    """N_row = 1: N_s sharded over every shard (not ported yet)."""
    return Layout("pillar", 1, n_col)


def panel(n_row: int, n_col: int) -> Layout:
    """An N_row × N_col panel (not ported yet)."""
    return Layout("panel", n_row, n_col)
