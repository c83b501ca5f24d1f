"""The shards of one solve on one device: the horizontal layer's shard
group (P row shards) and the grid of ``N_row × N_col`` shards that the
vertical layer adds (:class:`ShardGrid`).

The port's counterpart of the mesh's horizontal (``row``) axis and of the
collectives that ``shard_map`` bodies run over it. A stack-layout block
is one contiguous ``[D_pad, n_b]`` tensor, and shard p is its row view
``[p·R, (p+1)·R)``. One process drives every shard, as one JAX controller
drives every device of a ``shard_map`` mesh. A collective is carried out
as device copies between those row blocks:

* :meth:`ShardGroup.all_to_all` — the reference's ``jnp.take`` of the
  send slots and ``lax.all_to_all(tiled=False)`` (``repro/core/
  spmv.py:817-819``), done as one gather per receiver from x;
* :meth:`ShardGroup.ppermute` — ``lax.ppermute``: zeros for receivers
  outside the permutation; :meth:`ShardGroup.gather_ppermute` is the
  compressed engine's ``jnp.take`` + ``ppermute`` round in one gather;
* :meth:`ShardGroup.psum` — the all-reduce, summed in shard order.

Each collective adds its payload to :attr:`ShardGroup.bytes` under its
kind: the bytes every shard hands to the exchange, summed over shards
(an ``all_to_all`` of ``[P, L, n_b]`` send buffers moves
``P·P·L·n_b·S``, a ``ppermute`` round padded to ``L_r`` moves
``P·L_r·n_b·S``), so they can be held to the reference planner's
per-device predictions times P. On one card the exchange is a device
copy, not a network transfer.

The stack↔panel redistribution (``core/redistribute.py``) counts under
its own kind, ``"redistribute"``, on the stack group: the bytes that the
reference's tiled ``all_to_all`` along ``col`` sends off-device.

Split-phase engines run an exchange on a side CUDA stream
(:meth:`ShardGroup.start`) while the local block contracts on the current
stream, and wait on its event (:meth:`ShardGroup.wait`) before the halo
contraction. The buffers an exchange writes are allocated on the current
stream before it starts, and the engines wait on every exchange they
start before they return, so no block is freed or reused while the side
stream still touches it. On the CPU the same code runs in order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device

__all__ = ["ShardGroup", "ShardGrid", "Pending", "COLLECTIVES"]

#: The collective kinds whose bytes a group counts.
COLLECTIVES = ("all_to_all", "ppermute", "psum", "redistribute")


@dataclasses.dataclass
class Pending:
    """An exchange started by :meth:`ShardGroup.start`: its result and,
    on the card, the event recorded on the side stream after it."""

    result: object
    event: torch.cuda.Event | None = None


class ShardGroup:
    """``P`` row shards of the stack layout on ``device`` (the card unless
    ``"cpu"`` is given)."""

    def __init__(self, P: int, device=None):
        if int(P) < 1:
            raise ValueError(f"a shard group needs P >= 1, got {P}")
        self.P = int(P)
        self.device = resolve_device(device)
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self._side: torch.cuda.Stream | None = None
        self._index: dict = {}

    def __repr__(self) -> str:
        return f"ShardGroup(P={self.P}, device={self.device})"

    # ------------------------------------------------------------ blocks --

    def rows(self, x: torch.Tensor) -> int:
        """Rows R of one shard of the stacked block ``x [P·R, ...]``."""
        if x.shape[0] % self.P:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{self.P} shards")
        return x.shape[0] // self.P

    def shard(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Shard p's row view of ``x``."""
        R = self.rows(x)
        return x[p * R:(p + 1) * R]

    def reset_counts(self) -> None:
        for k in COLLECTIVES:
            self.bytes[k] = 0
            self.calls[k] = 0

    def _record(self, kind: str, n_bytes: int) -> None:
        self.bytes[kind] += int(n_bytes)
        self.calls[kind] += 1

    def _cached(self, key, build):
        """A gather index built once per plan array (``key[1]`` is the
        array, held here so its ``id`` stays its own)."""
        k = (key[0], id(key[1])) + tuple(key[2:])
        hit = self._index.get(k)
        if hit is None:
            hit = (key[1], build())
            self._index[k] = hit
        return hit[1]

    # ------------------------------------------------------- collectives --

    def all_to_all(self, x: torch.Tensor, send_idx: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
        """The halo ``all_to_all``: ``recv [P, P·L, n_b]`` in which
        receiver p's buffer holds, sender by sender, the rows
        ``send_idx[q, p]`` of shard q (``send_idx [P, P, L]``, local row
        indices). ``out`` (``[P, P·L, n_b]``, each receiver's block
        contiguous; it may be a column range of a larger buffer) receives
        it. One gather per receiver; the payload counted is the
        collective's, ``P·P·L·n_b·S``."""
        P, R, nb = self.P, self.rows(x), x.shape[1]
        L = int(send_idx.shape[2])
        if out is None:
            out = x.new_empty((P, P * L, nb))
        if L:
            def build():
                # idx[q, p, s] = q·R + send_idx[q, p, s]; receiver p reads
                # its column, sender-major
                base = torch.arange(P, device=send_idx.device,
                                    dtype=torch.int64) * R
                idx = send_idx.to(torch.int64) + base[:, None, None]
                return [idx[:, p].reshape(-1).contiguous() for p in range(P)]

            for p, idx in enumerate(self._cached(("a2a", send_idx, R), build)):
                torch.index_select(x, 0, idx, out=out[p])
        self._record("all_to_all", P * P * L * nb * x.element_size())
        return out

    def gather_ppermute(self, x: torch.Tensor, send_rows: torch.Tensor,
                        perm, out: torch.Tensor | None = None,
                        key=None) -> torch.Tensor:
        """One compressed round: ``jnp.take(x_q, send_rows[q])`` on every
        sender q, then ``ppermute`` by ``perm`` (``(src, dst)`` pairs).
        ``send_rows [P, L_r]`` local row indices; the result
        ``[P, L_r, n_b]`` (into ``out``, each receiver's block contiguous)
        holds zeros for a receiver outside ``perm``. ``key`` names the
        round for the index cache."""
        P, R, nb = self.P, self.rows(x), x.shape[1]
        Lr = int(send_rows.shape[1])
        if out is None:
            out = x.new_empty((P, Lr, nb))
        src_of = {int(d): int(s) for s, d in perm}

        def build():
            rows = send_rows.to(torch.int64)
            return {d: (rows[s] + s * R).contiguous()
                    for d, s in src_of.items()}

        idx = self._cached(("perm", send_rows, R, key), build)
        for d in range(P):
            if d in idx:
                torch.index_select(x, 0, idx[d], out=out[d])
            else:
                out[d].zero_()
        self._record("ppermute", P * Lr * nb * x.element_size())
        return out

    def ppermute(self, seg: torch.Tensor, perm) -> torch.Tensor:
        """``lax.ppermute`` of ``seg [P, ...]``: ``out[dst] = seg[src]`` for
        each pair of ``perm``, zeros for the other receivers."""
        out = torch.zeros_like(seg)
        for s, d in perm:
            out[int(d)] = seg[int(s)]
        self._record("ppermute", seg.numel() * seg.element_size())
        return out

    def psum(self, parts) -> torch.Tensor:
        """The all-reduce of one part per shard, summed in shard order."""
        parts = list(parts)
        if len(parts) != self.P:
            raise ValueError(f"psum needs {self.P} parts, got {len(parts)}")
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        self._record("psum", sum(p.numel() * p.element_size() for p in parts))
        return acc

    # ------------------------------------------------------ split phase --

    def start(self, fn) -> Pending:
        """Run ``fn()`` (an exchange) on the side stream after the work
        already queued on the current one; on the CPU, run it now."""
        if self.device.type != "cuda":
            return Pending(fn())
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            result = fn()
            event = torch.cuda.Event()
            event.record(self._side)
        return Pending(result, event)

    def wait(self, pending: Pending):
        """Order the current stream after ``pending``; its result."""
        if pending.event is not None:
            torch.cuda.current_stream(self.device).wait_event(pending.event)
        return pending.result


class ShardGrid:
    """``n_row × n_col`` shards of one solve on ``device`` (the port's
    counterpart of the reference's ``row × col`` solver mesh).

    ``stack`` is the group of ``P = n_row·n_col`` row shards of the stack
    layout (TSQR, Gram, Ritz, Lanczos; stack shard ``b = i·n_col + k``
    lies inside panel row-block i, the reference's "matching" layouts);
    ``panel`` the group of ``n_row`` row shards that each column bundle's
    filter runs over (``stack`` itself when ``n_col = 1``). The
    redistribution between the two layouts counts on ``stack`` under
    ``"redistribute"``."""

    def __init__(self, n_row: int, n_col: int = 1, device=None):
        self.n_row, self.n_col = int(n_row), int(n_col)
        if self.n_row < 1 or self.n_col < 1:
            raise ValueError(f"a grid needs n_row, n_col >= 1, got "
                             f"{n_row}x{n_col}")
        self.stack = ShardGroup(self.n_row * self.n_col, device)
        self.device = self.stack.device
        self.panel = (self.stack if self.n_col == 1
                      else ShardGroup(self.n_row, self.device))

    @property
    def P(self) -> int:
        """All shards, ``n_row·n_col``."""
        return self.stack.P

    def __repr__(self) -> str:
        return f"ShardGrid({self.n_row}x{self.n_col}, device={self.device})"
