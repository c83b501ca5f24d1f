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

**One process per shard.** A group built with a
:class:`~repro_torch.core.ranks.RankLink` (``link``) is one rank's part
of a group whose shards live one a process: it holds the one shard
``link.index`` (:attr:`ShardGroup.held`, ``n_loc = 1``), where the
one-process group holds all P (``n_loc = P``). Everything above the
group (the engines, TSQR, Gram, Lanczos, the Ritz step, the
redistribution) works on "the shards held here", a block of ``n_loc·R``
rows viewed ``[n_loc, R, n_b]``, so the one process's code path and bits
stay as they are. On a rank each collective is a ``torch.distributed``
call through the link with the same layout of its result, and each rank
counts its own share of the bytes (summed over the ranks they are the
one process's) and the calls of its shard (the one process's).
:meth:`ShardGroup.start` issues the exchange asynchronously and keeps
its work in the :class:`Pending`; :meth:`ShardGroup.wait` waits on it.
The whole-vector reductions of Lanczos and the Ritz step
(:meth:`ShardGroup.allsum`, :meth:`ShardGroup.norm`) are the whole
block's own op in one process and a per-shard partial summed in shard
order on ranks; neither is counted.
"""
from __future__ import annotations

import contextlib
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
    whether a ``side`` entry ran on a real CUDA side stream; ``n_loc``
    the shards whose share ``n_bytes`` counts (all P in one process, one
    on a rank)."""

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
    n_loc: int | None = None

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
                      kind=kind, label=label, n_loc=group.n_loc, **fields)
        self.entries.append(e)
        return e


def _groups(target) -> list:
    if isinstance(target, ShardGroup):
        return [target]
    grid = getattr(target, "grid", target)
    return list({id(g): g for g in (grid.stack, grid.panel)}.values())


def _in_order(parts: list) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, in that order."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


@dataclasses.dataclass
class Pending:
    """An exchange started by :meth:`ShardGroup.start`: its result and,
    on the card, the event recorded on the side stream after it; on ranks
    the collectives in flight (``flights``); ``id`` pairs it with its
    ``wait`` in a :class:`CommTrace`."""

    result: object
    event: torch.cuda.Event | None = None
    id: int | None = None
    flights: list = dataclasses.field(default_factory=list)


class ShardGroup:
    """``P`` row shards of the stack layout on ``device`` (the card unless
    ``"cpu"`` is given). ``name`` labels its entries in ``trace`` (a
    :class:`CommTrace` set by :meth:`CommTrace.attach`; None, no record,
    until then). With ``link`` (a :class:`~repro_torch.core.ranks.
    RankLink` of P ranks) it is this rank's part of the group: it holds
    shard ``link.index`` only (module docstring)."""

    def __init__(self, P: int, device=None, name: str = "stack",
                 link=None):
        if int(P) < 1:
            raise ValueError(f"a shard group needs P >= 1, got {P}")
        self.P = int(P)
        self.device = resolve_device(device)
        self.name = name
        self.link = link
        if link is not None and link.size != self.P:
            raise ValueError(f"a group of {self.P} shards over {link}")
        #: the first shard held here, and how many (all P in one process)
        self.first = 0 if link is None else link.index
        self.n_loc = self.P if link is None else 1
        self.trace: CommTrace | None = None
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self._side: torch.cuda.Stream | None = None
        self._index: dict = {}
        self._pending: int | None = None  # the exchange running on the side
        self._flights: list | None = None  # on ranks, inside start()
        self._batch: tuple | None = None  # on ranks, inside coalesced()
        self._open: dict = {}  # on ranks, flights not yet waited

    def __repr__(self) -> str:
        where = "" if self.link is None else f", shard {self.first} here"
        return f"ShardGroup(P={self.P}, device={self.device}{where})"

    @property
    def held(self) -> range:
        """The shards held in this process, in order."""
        return range(self.first, self.first + self.n_loc)

    # ------------------------------------------------------------ blocks --

    def rows(self, x: torch.Tensor) -> int:
        """Rows R of one shard of the block ``x [n_loc·R, ...]`` of the
        shards held here."""
        if x.shape[0] % self.n_loc:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{self.n_loc} shards")
        return x.shape[0] // self.n_loc

    def shard(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Shard p's row view of ``x`` (p one of :attr:`held`)."""
        R, j = self.rows(x), p - self.first
        if not 0 <= j < self.n_loc:
            raise ValueError(f"shard {p} is not held here ({self})")
        return x[j * R:(j + 1) * R]

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

    def _issue(self, flight) -> None:
        """On ranks: wait on ``flight`` now, or keep it for the ``wait``
        of the exchange being started."""
        if self._flights is None:
            flight.wait()
        else:
            self._flights.append(flight)
            self._open[id(flight)] = flight

    def _p2p(self, sends: list, recvs: list) -> None:
        """On ranks: point-to-point sends and receives, now or, inside
        :meth:`coalesced`, with the others of its block."""
        if self._batch is None:
            self._issue(self.link.exchange(sends, recvs))
        else:
            self._batch[0].extend(sends)
            self._batch[1].extend(recvs)

    @contextlib.contextmanager
    def coalesced(self):
        """On ranks, the point-to-point collectives issued inside the
        block (the rounds of one compressed exchange) go out as one
        ``batch_isend_irecv`` when it ends, their sends staged in one
        copy; each is still counted and recorded as itself. Nothing
        changes in one process."""
        if self.link is None or self._batch is not None:
            yield
            return
        self._batch = ([], [])
        try:
            yield
        finally:
            sends, recvs = self._batch
            self._batch = None
        if sends or recvs:
            self._issue(self.link.exchange(sends, recvs))

    def settle(self) -> None:
        """On ranks: wait on every collective still in flight (one whose
        ``wait`` was dropped)."""
        for f in list(self._open.values()):
            f.wait()
        self._open.clear()

    def all_to_all(self, x: torch.Tensor, send_idx: torch.Tensor,
                   out: torch.Tensor | None = None,
                   label: str = "halo") -> torch.Tensor:
        """The halo ``all_to_all``: ``recv [n_loc, P·L, n_b]`` in which
        receiver p's buffer holds, sender by sender, the rows
        ``send_idx[q, p]`` of shard q (``send_idx [n_loc, P, L]``, the
        rows of the plan of the shards held here, local row indices).
        ``out`` (``[n_loc, P·L, n_b]``, each receiver's block contiguous;
        it may be a column range of a larger buffer) receives it. In one
        process one gather per receiver; on a rank one
        ``all_to_all_single`` of its send rows for every receiver. The
        payload counted is each shard's ``P·L·n_b·S``."""
        n, P, R, nb = self.n_loc, self.P, self.rows(x), x.shape[1]
        L = int(send_idx.shape[2])
        if out is None:
            out = x.new_empty((n, P * L, nb))
        if L and self.link is not None:
            idx = self._cached(("a2a", send_idx, R), lambda: send_idx[0].to(
                torch.int64).reshape(-1).contiguous())
            self._issue(self.link.all_to_all(out[0], x.index_select(0, idx)))
        elif L:
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
        self._record("all_to_all", n * P * L * nb * S, label=label,
                     operand_bytes=P * L * nb * S, reads=(x,), writes=(out,))
        return out

    def gather_ppermute(self, x: torch.Tensor, send_rows: torch.Tensor,
                        perm, out: torch.Tensor | None = None,
                        key=None, label: str | None = None) -> torch.Tensor:
        """One compressed round: ``jnp.take(x_q, send_rows[q])`` on every
        sender q, then ``ppermute`` by ``perm`` (``(src, dst)`` pairs).
        ``send_rows [n_loc, L_r]`` the local rows each shard held here
        ships; the result ``[n_loc, L_r, n_b]`` (into ``out``, each
        receiver's block contiguous) holds zeros for a receiver outside
        ``perm``. ``key`` names the round for the index cache (and the
        trace's label, ``halo-round[key]``, unless ``label`` is given)."""
        n, R, nb = self.n_loc, self.rows(x), x.shape[1]
        Lr = int(send_rows.shape[1])
        if out is None:
            out = x.new_empty((n, Lr, nb))
        src_of = {int(d): int(s) for s, d in perm}
        if self.link is not None:
            me = self.first
            dst_of = {s: d for d, s in src_of.items()}
            sends = []
            if me in dst_of:
                idx = self._cached(("perm", send_rows, R, key), lambda:
                                   send_rows[0].to(torch.int64).contiguous())
                sends.append((dst_of[me], x.index_select(0, idx)))
            recvs = [(src_of[me], out[0])] if me in src_of else []
            if not recvs:
                out[0].zero_()
            self._p2p(sends, recvs)
        else:
            def build():
                rows = send_rows.to(torch.int64)
                return {d: (rows[s] + s * R).contiguous()
                        for d, s in src_of.items()}

            idx = self._cached(("perm", send_rows, R, key), build)
            for d in range(n):
                if d in idx:
                    torch.index_select(x, 0, idx[d], out=out[d])
                else:
                    out[d].zero_()
        S = x.element_size()
        self._record("ppermute", n * Lr * nb * S,
                     label=label or f"halo-round[{key}]",
                     operand_bytes=Lr * nb * S, reads=(x,), writes=(out,))
        return out

    def ppermute(self, seg: torch.Tensor, perm,
                 label: str = "ppermute") -> torch.Tensor:
        """``lax.ppermute`` of ``seg [n_loc, ...]`` (a segment per shard
        held here): ``out[dst] = seg[src]`` for each pair of ``perm``,
        zeros for the other receivers."""
        out = torch.zeros_like(seg)
        if self.link is not None:
            me = self.first
            self._p2p([(int(d), seg[0]) for s, d in perm if int(s) == me],
                      [(int(s), out[0]) for s, d in perm if int(d) == me])
        else:
            for s, d in perm:
                out[int(d)] = seg[int(s)]
        n = seg.numel() * seg.element_size()
        self._record("ppermute", n, label=label, operand_bytes=n // self.n_loc,
                     reads=(seg,), writes=(out,))
        return out

    def _sum_in_order(self, part: torch.Tensor) -> torch.Tensor:
        """On ranks: every shard's ``part``, summed in shard order."""
        return _in_order(self.link.all_gather(part))

    def psum(self, parts, label: str = "psum") -> torch.Tensor:
        """The all-reduce of one part per shard (``n_loc`` parts, those of
        the shards held here), summed in shard order."""
        parts = list(parts)
        if len(parts) != self.n_loc:
            raise ValueError(f"psum needs {self.n_loc} parts, got "
                             f"{len(parts)}")
        acc = (self._sum_in_order(parts[0]) if self.link is not None
               else _in_order(parts))
        self._record("psum", sum(p.numel() * p.element_size() for p in parts),
                     label=label,
                     operand_bytes=parts[0].numel() * parts[0].element_size(),
                     reads=parts, writes=(acc,))
        return acc

    def allsum(self, t: torch.Tensor) -> torch.Tensor:
        """A reduction over the whole block's rows, from ``t``, the
        reduction of the rows held here: ``t`` itself in one process (the
        whole block's op), the shards' parts summed in shard order on
        ranks. Not counted."""
        return t if self.link is None else self._sum_in_order(t)

    def norm(self, w: torch.Tensor) -> torch.Tensor:
        """The 2-norm of the whole block ``w`` (its rows held here):
        ``torch.linalg.norm`` in one process, the root of the shards'
        squared sums, summed in shard order, on ranks. Not counted."""
        if self.link is None:
            return torch.linalg.norm(w)
        return torch.sqrt(self._sum_in_order(torch.sum(torch.abs(w) ** 2)))

    def check_agreed(self, *values) -> None:
        """On ranks: raise unless every rank holds the same ``values``
        (host arrays a decision is taken from), so that no rank takes a
        branch the others do not. Not counted; nothing in one process."""
        if self.link is None:
            return
        mine = torch.as_tensor(np.concatenate(
            [np.asarray(v, dtype=np.float64).ravel() for v in values]))
        for q, other in enumerate(self.link.all_gather(
                mine.to(self.device))):
            if not torch.equal(other.cpu(), mine):
                raise RuntimeError(f"shard {q} holds other values than shard "
                                   f"{self.first} where the ranks decide")

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole block ``[P·R, ...]`` from the rows held here: ``x``
        in one process, every rank's rows in shard order on ranks (on
        every rank). Not counted."""
        if self.link is None:
            return x
        return torch.cat(self.link.all_gather(x.contiguous()))

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
        already queued on the current one; on the CPU, run it now. On
        ranks ``fn``'s collectives are issued asynchronously and kept in
        the returned :class:`Pending`, not waited on."""
        pid = None
        if self.trace is not None:
            pid = self.trace.new_pending()
            self._note("start", label, pending=pid)
        if self.link is not None:
            self._flights = []
            try:
                result = self._run_side(fn, pid)
            finally:
                flights, self._flights = self._flights, None
            return Pending(result, id=pid, flights=flights)
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
        """Order the current stream after ``pending`` (on ranks, wait on
        its collectives and land what they received); its result."""
        for f in pending.flights:
            f.wait()
            self._open.pop(id(f), None)
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
    ``"redistribute"``. ``bundles`` are the column bundles filtered here.

    With ``ranks`` the grid is one rank's part of a launch of
    ``n_row·n_col`` ranks (``core/ranks.py``; the process group started,
    ``device`` this rank's): rank b holds stack shard b, and bundle k of
    panel shard i; ``panel`` is its column's group (a group of one at
    ``n_row = 1``) and ``row_link`` the transport of its panel row, over
    which the redistribution runs (None at ``n_col = 1``). ``members``
    (the global ranks of the shards, in shard order) puts the grid on a
    sub-grid of the world, as the degraded retry does; without it a world
    size other than ``n_row·n_col`` raises."""

    def __init__(self, n_row: int, n_col: int = 1, device=None,
                 ranks: bool = False, members=None):
        self.n_row, self.n_col = int(n_row), int(n_col)
        if self.n_row < 1 or self.n_col < 1:
            raise ValueError(f"a grid needs n_row, n_col >= 1, got "
                             f"{n_row}x{n_col}")
        self.ranks = bool(ranks)
        self.row_link = None
        self.bundles = range(self.n_col)
        if not self.ranks:
            self.stack = ShardGroup(self.n_row * self.n_col, device, "stack")
            self.device = self.stack.device
            self.panel = (self.stack if self.n_col == 1
                          else ShardGroup(self.n_row, self.device, "panel"))
            return
        from .ranks import grid_links

        self.device = resolve_device(device)
        links = grid_links(self.n_row, self.n_col, self.device, members)
        if links is None:
            raise ValueError(f"this rank is not one of {tuple(members)}")
        self.stack = ShardGroup(self.n_row * self.n_col, self.device,
                                "stack", link=links.stack)
        self.panel = (self.stack if self.n_col == 1
                      else ShardGroup(self.n_row, self.device, "panel",
                                      link=links.panel))
        self.row_link = links.row
        self.bundles = range(links.k, links.k + 1)

    @property
    def P(self) -> int:
        """All shards, ``n_row·n_col``."""
        return self.stack.P

    def links(self) -> list:
        """The rank transports of this grid (none in one process)."""
        out = [self.stack.link, self.panel.link, self.row_link]
        return [ln for i, ln in enumerate(out)
                if ln is not None and ln not in out[:i]]

    def __repr__(self) -> str:
        where = (f", rank {self.stack.first} of {self.P}" if self.ranks
                 else "")
        return (f"ShardGrid({self.n_row}x{self.n_col}, device={self.device}"
                f"{where})")
