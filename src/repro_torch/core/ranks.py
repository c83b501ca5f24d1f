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
* :meth:`RankLink.all_reduce` — a sum of integer counters;
* :meth:`RankLink.barrier` — every member waits for the others (after
  rank 0 has written a checkpoint).

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
an ``n_row × n_col`` grid over the world or over a sub-grid of its
members: member ``b = i·n_col + k`` holds stack shard b and bundle k of
panel row-block i; the panel group of column k is ``{i'·n_col + k}``,
the redistribution's group the panel row ``{i·n_col + k'}``. A process
group is made once per member set (``dist.new_group`` is collective: every
rank of the world calls it, in the same order) and kept for later grids,
each of which gets transports of its own. :func:`broadcast_object` sends
rank 0's host object to every rank of the world.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import rank_device

__all__ = ["BACKENDS", "Flight", "RankLink", "GridLinks", "init_ranks",
           "grid_links", "broadcast_object", "is_lead"]

#: The process-group backends a rank launch takes, named explicitly.
BACKENDS = ("gloo", "nccl")


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

    def barrier(self) -> None:
        """Wait until every member has reached this call."""
        dist.barrier(group=self.pg)


def is_lead() -> bool:
    """Whether this process prints and writes for the launch: rank 0 of a
    started process group, or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_object(obj, device=None):
    """Rank 0's ``obj`` (a picklable host object) on every rank of the
    world, in one ``broadcast_object_list``; ``obj`` itself in one
    process. ``device`` is where nccl stages the pickle (this rank's
    card)."""
    if not dist.is_initialized():
        return obj
    nccl = str(dist.get_backend()) == "nccl"
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0,
                               device=torch.device(device) if nccl else None)
    return box[0]


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
    the grid's members, ``panel`` over its column (None when it is ``stack``,
    ``n_col = 1``, or holds this rank alone, ``n_row = 1``), ``row`` over
    its panel row (None at ``n_col = 1``); ``k`` its column, the bundle
    it filters."""

    stack: RankLink
    panel: RankLink | None
    row: RankLink | None
    k: int


#: The process groups made so far, by member set, and the world they
#: were made in (a new process group starts the cache afresh).
_GROUPS: dict = {}


def _group_of(members: tuple):
    """The process group of ``members`` (None: the whole world), made on
    first use by every rank of the world and kept."""
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS["world"] = world
    if members == tuple(range(dist.get_world_size())):
        return None
    if members not in _GROUPS:
        _GROUPS[members] = dist.new_group(list(members))
    return _GROUPS[members]


def grid_links(n_row: int, n_col: int, device: torch.device,
               members=None) -> GridLinks | None:
    """Build the links of the grid (module docstring) on every rank of the
    world, in the same order, over ``members`` (the global ranks of the
    grid's shards in shard order; default every rank, and then the world
    size must be ``n_row·n_col``). Every rank of the world calls it; one
    outside ``members`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("a rank grid needs a started process group "
                           "(repro_torch.core.ranks.init_ranks)")
    P = n_row * n_col
    world = dist.get_world_size()
    if members is None:
        if world != P:
            raise ValueError(f"the world has {world} ranks, the "
                             f"{n_row}x{n_col} grid {P} shards: one rank "
                             "a shard")
        members = range(P)
    members = tuple(int(m) for m in members)
    if len(members) != P or len(set(members)) != P or not all(
            0 <= m < world for m in members):
        raise ValueError(f"the {n_row}x{n_col} grid needs {P} distinct "
                         f"ranks of the world's {world}, got {members}")
    backend = str(dist.get_backend())
    rank = dist.get_rank()
    cols = [tuple(members[ii * n_col + kk] for ii in range(n_row))
            for kk in range(n_col)]
    rows = [tuple(members[ii * n_col + kk] for kk in range(n_col))
            for ii in range(n_row)]
    # every rank makes the groups in this order, members or not
    stack_pg = _group_of(members)
    col_pgs = ([_group_of(c) for c in cols] if n_col > 1 and n_row > 1
               else [None] * n_col)
    row_pgs = [_group_of(r) for r in rows] if n_col > 1 else [None] * n_row
    if rank not in members:
        return None
    i, k = divmod(members.index(rank), n_col)
    stack = RankLink(members, stack_pg, device, backend)
    panel = (RankLink(cols[k], col_pgs[k], device, backend)
             if n_col > 1 and n_row > 1 else None)
    row = RankLink(rows[i], row_pgs[i], device, backend) if n_col > 1 else None
    return GridLinks(stack, panel, row, k)
