"""One process per shard: the ``torch.distributed`` transport of a shard
group (the port's counterpart of the reference's ``shard_map`` over one
device per shard).

A :class:`RankLink` is the process group of the ranks that hold one
:class:`~repro_torch.core.shards.ShardGroup`'s shards, one shard a rank
(member m holds shard m of the group). The group carries out its
collectives through it, each the counterpart of the one-process copy
with the same layout of its result:

* :meth:`RankLink.all_to_all` — ``all_to_all_single``: block m of every
  member's send buffer goes to member m, the receive buffer sender-major;
* :meth:`RankLink.exchange` — point-to-point sends and receives in one
  ``batch_isend_irecv`` (the compressed rounds of one exchange, the TSQR
  butterfly);
* :meth:`RankLink.all_gather` — the parts of every member in member
  order (the group's ``psum`` sums them in shard order, so every rank
  holds the one-process sum's bits);
* :meth:`RankLink.all_reduce` — a sum of integer counters.

Every call is issued with ``async_op=True`` and comes back as a
:class:`Flight`: its work handles, and what lands the received data in
the caller's tensor once they are done. The group waits on a flight at
once, or, inside ``ShardGroup.start``, keeps it in the ``Pending`` that
``ShardGroup.wait`` waits on.

With the ``gloo`` backend a CUDA tensor is staged: each call's send
buffers are copied to one pinned host tensor before it (a copy that
waits for the card), its receive buffers received into pinned host
memory and copied to the card after it (queued on the current stream,
no wait), every call the same way, and :attr:`RankLink.staged` counts
those bytes. ``nccl`` takes the
card's tensors as they are and stages nothing. A complex tensor goes on
the wire as its real view.

:func:`init_ranks` starts the process group of a launch (``env://`` under
``python -m torch.distributed.run``; tests pass a ``file://`` store) and
:func:`grid_links` builds, on every rank in the same order, the groups of
an ``n_row × n_col`` grid: rank ``b = i·n_col + k`` holds stack shard b
and bundle k of panel row-block i; the panel group of column k is
``{i'·n_col + k}``, the redistribution's group the panel row
``{i·n_col + k'}``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import rank_device

__all__ = ["BACKENDS", "LATER", "Flight", "RankLink", "GridLinks",
           "init_ranks", "grid_links"]

#: The process-group backends a rank launch takes, named explicitly.
BACKENDS = ("gloo", "nccl")

#: What the refusals on ranks name: the options whose rank form is not
#: ported yet.
LATER = "a later slice of the port (ROADMAP, Open items 1)"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collective sends it: a complex tensor's real view."""
    return torch.view_as_real(t) if t.is_complex() else t


@dataclasses.dataclass
class Flight:
    """Collective work in flight: its handles (``works``), what lands the
    received data once they are done (``land``), and the buffers the
    transport reads or writes meanwhile (``keep``)."""

    works: list
    land: list
    keep: tuple = ()

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for f in self.land:
            f()
        self.works, self.land, self.keep = [], [], ()


class RankLink:
    """The transport of one group of ranks (module docstring).

    ``members`` are the global ranks of the group in shard order, ``pg``
    its process group (None: the default group), ``device`` where this
    rank's tensors live and ``backend`` the process group's backend."""

    def __init__(self, members, pg, device: torch.device, backend: str):
        self.members = tuple(int(m) for m in members)
        self.pg = pg
        self.index = self.members.index(dist.get_rank())
        self.device = device
        self.backend = backend
        self.stage = backend == "gloo" and device.type == "cuda"
        self.staged = 0

    @property
    def size(self) -> int:
        return len(self.members)

    def __repr__(self) -> str:
        return (f"RankLink(members={self.members}, index={self.index}, "
                f"{self.backend}{', staged' if self.stage else ''})")

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """A send buffer of ``t``'s values: pinned host memory when staged
        (counted), else ``t`` itself made contiguous."""
        t = t.contiguous()
        if not self.stage:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.staged += t.numel() * t.element_size()
        return h

    def _recv(self, out: torch.Tensor):
        """``(buffer, land)``: where the transport writes what ``out``
        receives, and what copies it there afterwards (None when it is
        ``out`` itself; from pinned memory the copy is queued on the
        current stream, and the host allocator keeps the buffer until it
        has run)."""
        if not self.stage and out.is_contiguous():
            return out, None
        buf = torch.empty(out.shape, dtype=out.dtype,
                          device="cpu" if self.stage else out.device,
                          pin_memory=self.stage)

        def land():
            out.copy_(buf, non_blocking=self.stage)
            if self.stage:
                self.staged += buf.numel() * buf.element_size()

        return buf, land

    def all_to_all(self, out: torch.Tensor, send: torch.Tensor) -> Flight:
        """``out [size·n, ...]`` receives, sender by sender, block m of
        member m's ``send [size·n, ...]``; block m of this member's
        ``send`` goes to member m."""
        s = self._send(send)
        r, land = self._recv(out)
        w = dist.all_to_all_single(_wire(r), _wire(s), group=self.pg,
                                   async_op=True)
        return Flight([w], [land] if land else [], (s, r))

    def exchange(self, sends: list, recvs: list) -> Flight:
        """Point-to-point: each ``(m, t)`` of ``sends`` goes to member m,
        each ``(m, out)`` of ``recvs`` receives member m's send (matched
        in issue order), all in one ``batch_isend_irecv``. The sends (of
        one dtype) cross to the host in one copy when staged."""
        ops, land, keep = [], [], []
        if sends:
            flat = self._send(torch.cat([t.reshape(-1) for _, t in sends]))
            keep.append(flat)
            at = 0
            for m, t in sends:
                s = flat[at:at + t.numel()]
                at += t.numel()
                ops.append(dist.P2POp(dist.isend, _wire(s), self.members[m],
                                      group=self.pg))
        for m, out in recvs:
            r, f = self._recv(out)
            keep.append(r)
            if f is not None:
                land.append(f)
            ops.append(dist.P2POp(dist.irecv, _wire(r), self.members[m],
                                  group=self.pg))
        works = dist.batch_isend_irecv(ops) if ops else []
        return Flight(list(works), land, tuple(keep))

    def all_gather(self, part: torch.Tensor) -> list:
        """Every member's ``part`` (one shape and dtype), in member order,
        as tensors on this rank's device."""
        s = self._send(part)
        bufs = [torch.empty_like(s) for _ in range(self.size)]
        dist.all_gather([_wire(b) for b in bufs], _wire(s), group=self.pg)
        if not self.stage:
            return bufs
        self.staged += sum(b.numel() * b.element_size() for b in bufs)
        return [b.to(self.device) for b in bufs]

    def all_reduce(self, counts) -> list:
        """The integer ``counts`` summed over the members."""
        t = torch.tensor([int(c) for c in counts], dtype=torch.int64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t, group=self.pg)
        return [int(v) for v in t.cpu().tolist()]


def init_ranks(backend: str, device="cuda", *, share_card: bool = False,
               init_method: str = "env://", rank: int | None = None,
               world_size: int | None = None) -> torch.device:
    """Start this process's rank of a launch and return its device.

    ``backend`` is ``"gloo"`` or ``"nccl"``, given explicitly. The device
    is ``device.rank_device`` of ``device`` (``"cpu"``, or ``"cuda"``: the
    card ``cuda:{LOCAL_RANK}``; with ``share_card`` several ranks may
    share one card, which only gloo allows: NCCL refuses two ranks on one
    device). ``init_method`` defaults to the environment that ``python -m
    torch.distributed.run`` sets (``rank`` and ``world_size`` from it
    too); tests pass a ``file://`` store and both numbers."""
    import os

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    kind = torch.device(device).type
    if backend == "nccl" and share_card:
        raise ValueError("--share-card needs the gloo backend: NCCL refuses "
                         "two ranks on one device")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo on "
                         "the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                               else 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     world_size if world_size is not None
                                     else 1))
    dev = rank_device(device, local, local_world, share_card)
    kw = {} if rank is None else dict(rank=int(rank))
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, **kw)
    return dev


@dataclasses.dataclass
class GridLinks:
    """The links of this rank on an ``n_row × n_col`` grid: ``stack`` over
    every rank, ``panel`` over its column (None when it is ``stack``,
    ``n_col = 1``, or holds this rank alone, ``n_row = 1``), ``row`` over
    its panel row (None at ``n_col = 1``); ``k`` its column, the bundle
    it filters."""

    stack: RankLink
    panel: RankLink | None
    row: RankLink | None
    k: int


def grid_links(n_row: int, n_col: int, device: torch.device) -> GridLinks:
    """Build the groups of the grid (module docstring) on every rank, in
    the same order (``dist.new_group`` is collective), once; raises when
    the world size is not ``n_row·n_col``."""
    if not dist.is_initialized():
        raise RuntimeError("a rank grid needs a started process group "
                           "(repro_torch.core.ranks.init_ranks)")
    P = n_row * n_col
    world = dist.get_world_size()
    if world != P:
        raise ValueError(f"the world has {world} ranks, the "
                         f"{n_row}x{n_col} grid {P} shards: one rank a "
                         "shard")
    backend = str(dist.get_backend())
    rank = dist.get_rank()
    i, k = divmod(rank, n_col)
    stack = RankLink(range(P), None, device, backend)
    panel = row = None
    cols = [[ii * n_col + kk for ii in range(n_row)] for kk in range(n_col)]
    rows = [[ii * n_col + kk for kk in range(n_col)] for ii in range(n_row)]
    if n_col > 1 and n_row > 1:
        for kk, members in enumerate(cols):
            pg = dist.new_group(members)
            if kk == k:
                panel = RankLink(members, pg, device, backend)
    if n_col > 1:
        for ii, members in enumerate(rows):
            pg = dist.new_group(members)
            if ii == i:
                row = RankLink(members, pg, device, backend)
    return GridLinks(stack, panel, row, k)
