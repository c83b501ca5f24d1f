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

A :class:`CommTrace` attached to a group (:meth:`CommTrace.attach`, the
one way in) keeps the order of what the group issues,
one :class:`CommEntry` each: every collective, every ``start`` and
``wait``, and the contractions and copies the engines note
(:meth:`ShardGroup.contraction`, :meth:`ShardGroup.copy`), with the byte
ranges of the storages each reads and writes and its logical stream
(``side`` inside :meth:`ShardGroup.start`, ``main`` otherwise; on the
card also whether that was the real side stream). ``repro_torch.
analysis`` holds the census and the dependence proofs over the record.
With no trace attached (the default) a group makes no entry and does
what it did without one: no extra device work, no sync, and the same
``bytes`` and ``calls`` either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ShardGroup", "ShardGrid", "Pending", "COLLECTIVES",
           "CommTrace", "CommEntry", "byte_ranges"]

#: The collective kinds whose bytes a group counts.
COLLECTIVES = ("all_to_all", "ppermute", "psum", "redistribute")

#: Strided views with more contiguous runs than this are recorded as the
#: one range from their first to their last byte (a superset: it can add
#: a dependence, never hide one).
MAX_RUNS = 4096


def byte_ranges(t: torch.Tensor) -> tuple:
    """The bytes ``t`` covers: ``(storage, start, stop)`` triples, sorted
    and merged, ``storage`` the device and address of its storage.
    ``x[:, :R]`` and ``x[:, R:]`` of one ``[P, R + H, n]`` block give
    disjoint ranges."""
    if t.numel() == 0:
        return ()
    es = t.element_size()
    key = (str(t.device), t.untyped_storage().data_ptr())
    base = t.storage_offset()
    dims = sorted(((st, sz) for sz, st in zip(t.shape, t.stride()) if sz > 1),
                  reverse=True)
    run = 1
    while dims and dims[-1][0] == run:  # fold the contiguous inner dims
        run *= dims.pop()[1]
    n_runs = int(np.prod([sz for _, sz in dims])) if dims else 1
    if n_runs > MAX_RUNS:
        stop = base + sum((sz - 1) * st for st, sz in dims) + run
        return ((key, base * es, stop * es),)
    starts = np.zeros(1, dtype=np.int64)
    for st, sz in dims:
        starts = (starts[:, None] + st * np.arange(sz)).reshape(-1)
    starts = np.sort(starts) + base
    out, lo, hi = [], int(starts[0]), int(starts[0]) + run
    for a in starts[1:].tolist():
        if a <= hi:
            hi = max(hi, a + run)
        else:
            out.append((key, lo * es, hi * es))
            lo, hi = a, a + run
    out.append((key, lo * es, hi * es))
    return tuple(out)


def _ranges(tensors) -> tuple:
    out = []
    for t in tensors:
        if t is not None:
            out.extend(byte_ranges(t))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CommEntry:
    """One entry of a :class:`CommTrace`, in issue order.

    ``kind`` is a collective of :data:`COLLECTIVES`, ``"start"``,
    ``"wait"``, ``"contract"`` or ``"copy"``; ``label`` names the call
    site (``halo``, ``halo-round[k]``, ``sstep-exchange[g]``,
    ``tsqr[level]``, ``gram``, ``redistribute[to_panel]``, a contraction's
    phase ``full``, ``local``, ``halo``, ``round[k]``, ``step[j]`` ...).
    ``n_bytes`` is what the group counted under ``kind``,
    ``operand_bytes`` one shard's operand; ``pending`` the id of a
    ``start``/``wait`` pair, and of the exchange a ``side`` entry belongs
    to; ``reads``/``writes`` the :func:`byte_ranges` of the storages;
    ``launches`` the kernel launches of a contraction; ``real_side``
    whether a ``side`` entry ran on a real CUDA side stream."""

    index: int
    group: str
    P: int
    kind: str
    label: str
    stream: str = "main"
    n_bytes: int = 0
    operand_bytes: int = 0
    pending: int | None = None
    reads: tuple = ()
    writes: tuple = ()
    launches: int = 0
    real_side: bool = False

    @property
    def collective(self) -> bool:
        return self.kind in COLLECTIVES


class CommTrace:
    """The ordered record of the collectives, exchanges and contractions
    of the groups it is attached to (module docstring)."""

    def __init__(self):
        self.entries: list[CommEntry] = []
        self._pendings = 0

    def attach(self, target) -> "CommTrace":
        """Record ``target``'s issue: a :class:`ShardGroup`, or both groups
        of a :class:`ShardGrid` (or of a ``FilterDiag``'s ``grid``)."""
        for g in _groups(target):
            g.trace = self
        return self

    @staticmethod
    def detach(target) -> None:
        for g in _groups(target):
            g.trace = None

    def clear(self) -> None:
        self.entries.clear()

    def new_pending(self) -> int:
        self._pendings += 1
        return self._pendings

    def append(self, group: "ShardGroup", kind: str, label: str,
               **fields) -> CommEntry:
        e = CommEntry(index=len(self.entries), group=group.name, P=group.P,
                      kind=kind, label=label, **fields)
        self.entries.append(e)
        return e


def _groups(target) -> list:
    if isinstance(target, ShardGroup):
        return [target]
    grid = getattr(target, "grid", target)
    return list({id(g): g for g in (grid.stack, grid.panel)}.values())


@dataclasses.dataclass
class Pending:
    """An exchange started by :meth:`ShardGroup.start`: its result and,
    on the card, the event recorded on the side stream after it; ``id``
    pairs it with its ``wait`` in a :class:`CommTrace`."""

    result: object
    event: torch.cuda.Event | None = None
    id: int | None = None


class ShardGroup:
    """``P`` row shards of the stack layout on ``device`` (the card unless
    ``"cpu"`` is given). ``name`` labels its entries in ``trace`` (a
    :class:`CommTrace` set by :meth:`CommTrace.attach`; None, no record,
    until then)."""

    def __init__(self, P: int, device=None, name: str = "stack"):
        if int(P) < 1:
            raise ValueError(f"a shard group needs P >= 1, got {P}")
        self.P = int(P)
        self.device = resolve_device(device)
        self.name = name
        self.trace: CommTrace | None = None
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self._side: torch.cuda.Stream | None = None
        self._index: dict = {}
        self._pending: int | None = None  # the exchange running on the side

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

    def _record(self, kind: str, n_bytes: int, *, label: str | None = None,
                operand_bytes: int = 0, reads=(), writes=()) -> None:
        self.bytes[kind] += int(n_bytes)
        self.calls[kind] += 1
        if self.trace is not None:
            self._note(kind, label or kind, n_bytes=int(n_bytes),
                       operand_bytes=int(operand_bytes), reads=_ranges(reads),
                       writes=_ranges(writes))

    def _note(self, kind: str, label: str, **fields) -> None:
        """One entry in the trace, on the stream it is issued to."""
        if self._pending is not None:
            fields.update(stream="side", pending=self._pending,
                          real_side=bool(
                              self._side is not None
                              and torch.cuda.current_stream(self.device)
                              == self._side))
        self.trace.append(self, kind, label, **fields)

    def contraction(self, label: str, reads=(), writes=(),
                    launches: int = 0) -> None:
        """Note in the trace a contraction phase of an engine (every
        shard's part of one block, ``launches`` kernel launches). Callers
        test ``trace is not None`` first, so that no argument is built
        without one."""
        self._note("contract", label, reads=_ranges(reads),
                   writes=_ranges(writes), launches=int(launches))

    def copy(self, label: str, reads=(), writes=()) -> None:
        """Note in the trace a copy that carries an exchange's data (ghost
        rows into the extended blocks, a payload); guarded as
        :meth:`contraction` is."""
        self._note("copy", label, reads=_ranges(reads),
                   writes=_ranges(writes))

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
                   out: torch.Tensor | None = None,
                   label: str = "halo") -> torch.Tensor:
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
        S = x.element_size()
        self._record("all_to_all", P * P * L * nb * S, label=label,
                     operand_bytes=P * L * nb * S, reads=(x,), writes=(out,))
        return out

    def gather_ppermute(self, x: torch.Tensor, send_rows: torch.Tensor,
                        perm, out: torch.Tensor | None = None,
                        key=None, label: str | None = None) -> torch.Tensor:
        """One compressed round: ``jnp.take(x_q, send_rows[q])`` on every
        sender q, then ``ppermute`` by ``perm`` (``(src, dst)`` pairs).
        ``send_rows [P, L_r]`` local row indices; the result
        ``[P, L_r, n_b]`` (into ``out``, each receiver's block contiguous)
        holds zeros for a receiver outside ``perm``. ``key`` names the
        round for the index cache (and the trace's label,
        ``halo-round[key]``, unless ``label`` is given)."""
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
        S = x.element_size()
        self._record("ppermute", P * Lr * nb * S,
                     label=label or f"halo-round[{key}]",
                     operand_bytes=Lr * nb * S, reads=(x,), writes=(out,))
        return out

    def ppermute(self, seg: torch.Tensor, perm,
                 label: str = "ppermute") -> torch.Tensor:
        """``lax.ppermute`` of ``seg [P, ...]``: ``out[dst] = seg[src]`` for
        each pair of ``perm``, zeros for the other receivers."""
        out = torch.zeros_like(seg)
        for s, d in perm:
            out[int(d)] = seg[int(s)]
        n = seg.numel() * seg.element_size()
        self._record("ppermute", n, label=label, operand_bytes=n // self.P,
                     reads=(seg,), writes=(out,))
        return out

    def psum(self, parts, label: str = "psum") -> torch.Tensor:
        """The all-reduce of one part per shard, summed in shard order."""
        parts = list(parts)
        if len(parts) != self.P:
            raise ValueError(f"psum needs {self.P} parts, got {len(parts)}")
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        self._record("psum", sum(p.numel() * p.element_size() for p in parts),
                     label=label,
                     operand_bytes=parts[0].numel() * parts[0].element_size(),
                     reads=parts, writes=(acc,))
        return acc

    # ------------------------------------------------------ split phase --

    def _run_side(self, fn, pid):
        if pid is None:
            return fn()
        self._pending = pid
        try:
            return fn()
        finally:
            self._pending = None

    def start(self, fn, label: str = "exchange") -> Pending:
        """Run ``fn()`` (an exchange) on the side stream after the work
        already queued on the current one; on the CPU, run it now."""
        pid = None
        if self.trace is not None:
            pid = self.trace.new_pending()
            self._note("start", label, pending=pid)
        if self.device.type != "cuda":
            return Pending(self._run_side(fn, pid), id=pid)
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            result = self._run_side(fn, pid)
            event = torch.cuda.Event()
            event.record(self._side)
        return Pending(result, event, pid)

    def wait(self, pending: Pending):
        """Order the current stream after ``pending``; its result."""
        if pending.event is not None:
            torch.cuda.current_stream(self.device).wait_event(pending.event)
        if self.trace is not None:
            self._note("wait", "wait", pending=pending.id)
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
        self.stack = ShardGroup(self.n_row * self.n_col, device, "stack")
        self.device = self.stack.device
        self.panel = (self.stack if self.n_col == 1
                      else ShardGroup(self.n_row, self.device, "panel"))

    @property
    def P(self) -> int:
        """All shards, ``n_row·n_col``."""
        return self.stack.P

    def __repr__(self) -> str:
        return f"ShardGrid({self.n_row}x{self.n_col}, device={self.device})"
