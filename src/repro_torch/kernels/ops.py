"""Dispatch between the CUDA kernels and their plain versions, and the
host planner of the DIA form.

The rules:

* a CUDA tensor goes to the kernel (``ell_gather.py``, ``cheb_dia.py``);
* a CPU tensor goes to the plain version (``ref.py``);
* a CUDA tensor that the kernel cannot take raises; nothing falls back.

The CUDA kernels mask a ragged R or n_b themselves, so no shape is sent
elsewhere for being ragged. Both sweep x in column slabs: the DIA step in
the width ``plan.slab_width`` picks, the ELL product in one; ``slab=``
forces it, for tests and for ``chip_smoke.py``'s sweep. Which of the two
kernels carries a fused
Chebyshev step is a structural choice made once, at operator build time
(``core/spmv.py``): the DIA whole-step when :func:`plan_dia` accepts the
operator (and it needs no halo), the ELL contraction whose last block
carries the fused epilogue otherwise.

An op census (``launch/op_analysis.py``) sees PyTorch's own ops, not a
kernel launched through ``ctypes``. So each call of a wrapper reports
itself to the active censuses (:data:`censuses`) as one op of its kernel,
with the bytes of its bound (the operator as the kernel reads it, x, y0,
w1 and w2 where the kernel takes them, and y, each once: ``PERF.md`` §6)
and 2·nnz·n_b flops (×4 complex), and the ops inside the call are kept
out of their counts: the plain version's on the CPU, the wrapper's
allocations on the card. The count is the same on either device. An ELL
launch is counted by :func:`ell_census` alone, which the engines' grouped
launch and the plain version standing for it enter too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from . import ref
from .plan import (CompactDia, CompactEll, compact_dia, diag_id_of,
                   ell_operator_bytes, span_of_dia)

#: Max distinct diagonal offsets before plan_dia refuses (the DIA form
#: stores n_diag * R values; past a few dozen diagonals the gather-free
#: format stops paying for itself).
DIA_MAX_DIAGS = 64

#: The op censuses a wrapper reports its calls to (each one's
#: ``kernel(name, n_bytes, flops)`` and ``quiet()``; ``launch/op_analysis.py``
#: adds and removes itself).
censuses: list = []


@contextlib.contextmanager
def kernel_calls(costs):
    """Report kernel calls to the active censuses and keep the ops run
    inside the block out of their counts. ``costs()`` gives the calls'
    ``(name, n_bytes, flops)``, computed quietly."""
    with contextlib.ExitStack() as quiet:
        for c in censuses:
            quiet.enter_context(c.quiet())
        calls = costs()
        for c in list(censuses):
            for name, n_bytes, flops in calls:
                c.kernel(name, n_bytes, flops)
        yield


def _flops(nnz: int, n_b: int, dtype: torch.dtype) -> float:
    return 2.0 * nnz * n_b * (4 if dtype.is_complex else 1)


def ell_cost(cols, vals, x_rows: int, n_b: int, epilogue: bool,
             compact: CompactEll | None = None, y0: bool = False,
             w1_is_x: bool = False) -> tuple:
    """``(name, n_bytes, flops)`` of one ELL kernel launch on the block
    ``cols/vals [R, W]``, or on the block of P row shards ``[P, R, W]``
    (one launch for all of them, ``compact`` their stacked form), against
    each shard's ``x [x_rows, n_b]``: the operator as the kernel reads it
    (:func:`plan.ell_operator_bytes` of all its rows), every shard's x,
    ``y0`` when the launch starts from one, with the epilogue w1 (unless
    ``w1_is_x``: it is x's leading rows, read once with x) and w2, and
    y."""
    P = int(cols.shape[0]) if cols.dim() == 3 else 1
    rows = P * int(cols.shape[-2])
    S = vals.element_size()
    nnz = (compact.cols.numel() if compact is not None
           else int((vals != 0).sum()))
    blocks = (1 + (1 if y0 else 0)
              + ((1 if w1_is_x else 2) if epilogue else 0))
    vec = (P * x_rows + rows * blocks) * n_b * S
    return ("ell_gather_cheb" if epilogue else "ell_gather",
            ell_operator_bytes(rows, nnz, S) + vec,
            _flops(nnz, n_b, vals.dtype))


def leads(w1, x) -> bool:
    """Whether ``w1`` is the leading rows of ``x`` (the same start and
    strides, no more rows): the block that a launch reads once for both,
    as the s-step filter's step reads its extended block."""
    return (w1.data_ptr() == x.data_ptr() and w1.stride() == x.stride()
            and w1.shape[:-2] == x.shape[:-2] and w1.shape[-1] == x.shape[-1]
            and w1.shape[-2] <= x.shape[-2])


def ell_census(cols, vals, x, y0, epilogue, compact: CompactEll | None = None):
    """The one rule by which an op census counts an ELL launch: a context
    (a null one while no census is active) that reports the launch of
    ``cols/vals`` on ``x [Rx, n_b]`` or ``[P, Rx, n_b]``, from ``y0`` or
    None, with ``epilogue = (w1, w2, alpha, beta)`` or None, as one op
    (:func:`ell_cost`) and keeps the ops run inside out of the counts. The
    kernel's launch and the plain version that stands for it enter it
    alike."""
    if not censuses:
        return contextlib.nullcontext()
    return kernel_calls(lambda: [ell_cost(
        cols, vals, x.shape[-2], x.shape[-1], epilogue is not None, compact,
        y0 is not None, epilogue is not None and leads(epilogue[0], x))])


def dia_cost(offsets, dvals, x, w1, w2, compact: CompactDia | None = None
             ) -> tuple:
    """``(name, n_bytes, flops)`` of one ``cheb_dia`` launch: the compact
    operator the kernel reads (``CompactDia.bytes_per_row``), x, w1 unless
    it is x (the filter's step reads one block for both), w2 and y."""
    cp = compact if compact is not None else compact_dia(
        dvals, diag_id_of(offsets))
    R, n_b, S = cp.R, x.shape[1], x.element_size()
    vecs = x.numel() + (0 if w1.data_ptr() == x.data_ptr() else w1.numel())
    n_bytes = cp.bytes_per_row * R + (vecs + w2.numel() + R * n_b) * S
    return "cheb_dia", n_bytes, _flops(cp.nnz, n_b, dvals.dtype)


def ell_spmv(cols, vals, x, y0=None, *, compact: CompactEll | None = None,
             slab: int | None = None, epilogue: tuple | None = None,
             out=None):
    """``y0 + A·x`` for one ELL block ``cols/vals [R, W]`` (``y0 = 0``
    when omitted), per row in slot order; with ``epilogue = (w1, w2,
    alpha, beta)`` the Chebyshev step ``2a·(y0 + A·x) + 2b·w1 − w2``
    (the last block of a fused step's chain). The kernel reads the
    padding-free form of the block (``compact``, built once per operator;
    built here when omitted), the plain version ``cols/vals``; ``slab``
    forces the kernel's slab width (the plain version has none). ``out``
    [R, n_b], when given, receives the result (it may be ``y0``)."""
    with ell_census(cols, vals, x, y0, epilogue, compact):
        if x.device.type != "cpu":
            from .ell_gather import ell_gather_spmv

            return ell_gather_spmv(cols, vals, x, y0, compact=compact,
                                   slab=slab, epilogue=epilogue, out=out)
        acc = y0 if y0 is not None else torch.zeros(
            (cols.shape[0], x.shape[1]), dtype=torch.result_type(vals, x))
        y = ref.ell_spmv_acc_ref(acc, cols, vals, x)
        if epilogue is not None:
            y = ref.cheb_epilogue(y, *epilogue)
        return y if out is None else out.copy_(y)


def cheb_dia(offsets, dvals, x, w1, w2, alpha, beta, *,
             compact: CompactDia | None = None, span: int | None = None,
             slab: int | None = None, out=None):
    """Fused Chebyshev DIA step ``2a·(A@x) + 2b·w1 − w2``. The kernel
    reads the compact form of ``dvals`` (a :class:`DiaPlan`'s ``compact``,
    built once; built here when omitted), the plain version ``dvals``.
    ``out`` [R, n_b], when given, receives the result."""
    if censuses:
        with kernel_calls(lambda: [dia_cost(offsets, dvals, x, w1, w2,
                                            compact)]):
            return _cheb_dia(offsets, dvals, x, w1, w2, alpha, beta,
                             compact, span, slab, out)
    return _cheb_dia(offsets, dvals, x, w1, w2, alpha, beta, compact, span,
                     slab, out)


def _cheb_dia(offsets, dvals, x, w1, w2, alpha, beta, compact, span, slab,
              out):
    if x.device.type == "cpu":
        y = ref.cheb_dia_ref(offsets, dvals, x, w1, w2, alpha, beta)
        return y if out is None else out.copy_(y)
    from .cheb_dia import cheb_dia as kernel

    return kernel(offsets, dvals, x, w1, w2, alpha, beta, compact=compact,
                  span=span, slab=slab, out=out)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Host-extracted DIA form of a one-shard zero-halo [R, W] ELL block:
    ``offsets`` sorted ascending (so the per-row accumulation order equals
    the ELL slot order), ``dvals[d, r]`` the value at (r, r + offsets[d])
    (0 where the diagonal has no entry). ``offsets/dvals`` are the
    canonical form, which the plain version reads; the CUDA kernel reads
    :attr:`compact`, built from them once, on their device."""

    offsets: tuple[int, ...]
    dvals: torch.Tensor  # [n_diag, R]

    @functools.cached_property
    def compact(self) -> CompactDia:
        return compact_dia(self.dvals, diag_id_of(self.offsets))

    @functools.cached_property
    def span(self) -> int:
        """``max |col − row|`` over the stored entries."""
        return span_of_dia(self.offsets, self.dvals)


def plan_dia(cols, vals, R: int, *, max_diags: int = DIA_MAX_DIAGS,
             device=None) -> DiaPlan | None:
    """Extract the DIA form of a one-shard ELL block, or ``None``.

    ``cols/vals`` are [R, W] numpy arrays or tensors, real or complex.
    Refuses (caller keeps the ELL path) when the values are not floating, a
    column lies outside ``[0, R)`` (the block has halo entries), or the
    block needs more than ``max_diags`` distinct diagonals. One scatter
    places every stored entry, however many rows there are.

    Here the port differs from the reference on purpose: the reference's
    ``plan_dia`` refuses complex values, so its complex solves run the ELL
    product and the XLA epilogue. The port sends a complex operator to its
    DIA kernel, which computes that same function bit for bit (ascending
    offsets are the ELL slot order, and the complex product is rounded as
    the reference's scan rounds it).
    """
    cols = cols.cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    vals = vals.cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
    if not np.issubdtype(vals.dtype, np.inexact):
        return None
    Rb, W = cols.shape
    if W == 0 or Rb != R:
        return None
    rr, ww = np.nonzero(vals != 0)
    if not len(rr):
        return None
    c = cols[rr, ww].astype(np.int64)
    if c.max() >= R:
        return None  # halo entries: not a comm-free local block
    offs = c - rr
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    dvals = np.zeros((len(uniq), R), dtype=vals.dtype)
    dvals[np.searchsorted(uniq, offs), rr] = vals[rr, ww]
    return DiaPlan(offsets=tuple(int(o) for o in uniq),
                   dvals=torch.as_tensor(dvals, device=device))
