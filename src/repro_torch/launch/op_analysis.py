"""Op-level cost census of a step: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles a step and parses XLA's optimized HLO for its dot
flops, its bytes at fusion granularity and its collectives. Eager PyTorch
has no such text: it launches each aten op as a kernel that reads its
operands and writes its result. So an :class:`OpCensus` (a
``TorchDispatchMode``) counts the ops a step runs, and what it counts is
what eager execution moves:

* ``flops`` — the dot-like ops only, as the reference's ``_dot_flops``
  counts them: 2·|result|·|contraction| for ``mm``, ``bmm``, ``addmm``
  and ``baddbmm`` (a product or ``einsum`` reaches the census as one of
  them; the port runs no convolution and no fused attention);
* ``hbm_bytes`` — each op's tensor operands plus its results (an
  ``out=`` tensor as a result only); view, alias and allocation ops are
  skipped, as the reference's ``_SKIP_BYTES_OPS`` skips its
  bookkeeping ops;
* ``coll_bytes``, ``coll_breakdown``, ``per_collective`` — the bytes and
  calls the given :class:`~repro_torch.core.shards.ShardGroup`\\ s counted
  over the window, by kind (their bytes summed over the shards; on one
  card each is a device copy);
* the hand-written kernels run through ``ctypes``, which a dispatch mode
  never sees: each wrapper call reports itself as one op with the bytes
  and flops of its bound (``kernels/ops.py``), and the ops inside it are
  not counted, so a call counts the same on the CPU (its plain version)
  and on the card (``kernels``: per kernel name, calls, bytes and flops).

Tensors on the meta device carry shapes only, so a step counted there
costs no memory: ``launch/dryrun.py::run_cell`` counts a full-size
training or decode step that way.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import ops as kernel_ops

__all__ = ["OpCosts", "OpCensus", "count_ops"]

#: Allocation, scalar-read and view ops the schema does not mark as views:
#: no traffic worth a row of the roofline.
_SKIP_BYTES_OPS = {"empty", "empty_strided", "new_empty", "new_empty_strided",
                   "empty_like", "resize_", "set_", "lift_fresh", "detach",
                   "alias", "_local_scalar_dense", "record_stream",
                   "_unsafe_view", "_reshape_alias"}
#: In-place ops that write their first operand without reading it.
_WRITE_ONLY = {"copy_", "fill_", "zero_"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}


@dataclasses.dataclass
class OpCosts:
    """What an :class:`OpCensus` counted (the fields of the reference's
    ``HloCosts``, plus the op and kernel counts)."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    per_collective: list  # (kind, bytes per call, calls), heaviest first
    ops: int = 0          # aten ops counted, plus kernel calls
    kernels: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)


def _dot_flops(name: str, args, out) -> float:
    """2·|result|·|contraction| of a dot-like op (0 for any other)."""
    if name not in _MATMULS:
        return 0.0
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * int(a.shape[-1])


class OpCensus(TorchDispatchMode):
    """Count the ops run inside the ``with`` block (module docstring).
    ``groups`` are the shard groups whose collectives the window's
    ``coll_*`` fields read. Read the result with :meth:`costs`."""

    def __init__(self, groups=()):
        super().__init__()
        self.groups = list({id(g): g for g in groups}.values())
        self.flops = 0.0
        self.hbm_bytes = 0
        self.ops = 0
        self.kernels: dict = {}
        #: the op that raised inside the window, if one did
        self.failed_op: str | None = None
        self._quiet = 0
        self._start: list = []
        self._coll: dict | None = None

    # the window ---------------------------------------------------------

    def __enter__(self):
        self._start = [(dict(g.bytes), dict(g.calls)) for g in self.groups]
        kernel_ops.censuses.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernel_ops.censuses.remove(self)
            self._coll = {}
            for g, (b0, c0) in zip(self.groups, self._start):
                for k in g.bytes:
                    b, c = self._coll.get(k, (0, 0))
                    self._coll[k] = (b + g.bytes[k] - b0[k],
                                     c + g.calls[k] - c0[k])

    @contextlib.contextmanager
    def quiet(self):
        """Keep the ops inside the block out of the counts."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def kernel(self, name: str, n_bytes: float, flops: float) -> None:
        """One call of a hand-written kernel (``kernels/ops.py``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        k["flops"] += flops
        self.ops += 1
        self.hbm_bytes += n_bytes
        self.flops += flops

    # the ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except Exception:
            self.failed_op = self.failed_op or str(func)
            raise
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        flops = _dot_flops(name, args, out)
        n_bytes = 0
        if not (func.is_view or name in _SKIP_BYTES_OPS):
            schema_args = func._schema.arguments
            for i, a in enumerate(args):
                if i < len(schema_args) and schema_args[i].is_out or (
                        i == 0 and name in _WRITE_ONLY):
                    continue
                n_bytes += sum(_nbytes(t) for t in _tensors(a))
            for k, v in kwargs.items():
                if k != "out":
                    n_bytes += sum(_nbytes(t) for t in _tensors(v))
            n_bytes += sum(_nbytes(t) for t in _tensors(out))
        if flops or n_bytes:
            self.ops += 1
            self.flops += flops
            self.hbm_bytes += n_bytes

    # the result ---------------------------------------------------------

    def costs(self) -> OpCosts:
        if self._coll is None:
            raise RuntimeError("read an OpCensus after its with block")
        coll = {k: b for k, (b, _) in self._coll.items()}
        per = sorted(((k, b / c, c) for k, (b, c) in self._coll.items() if c),
                     key=lambda t: (-t[1] * t[2], t[0]))
        return OpCosts(flops=self.flops, hbm_bytes=float(self.hbm_bytes),
                       coll_bytes=float(sum(coll.values())),
                       coll_breakdown=coll, per_collective=per, ops=self.ops,
                       kernels={k: dict(v) for k, v in self.kernels.items()})


def count_ops(fn, *args, groups=(), **kwargs):
    """``(fn(*args, **kwargs), OpCosts)`` of one call."""
    census = OpCensus(groups)
    with census:
        result = fn(*args, **kwargs)
    return result, census.costs()
