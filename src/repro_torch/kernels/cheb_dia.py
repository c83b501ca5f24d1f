"""Wrapper of the CUDA fused DIA Chebyshev step (``csrc/cheb_dia.cu``).

``y = 2a·(A@x) + 2b·w1 − w2`` for a DIA operator (``offsets`` ascending,
``dvals [n_diag, R]``, zero where a diagonal has no entry). It replaces the
Pallas TPU kernel ``repro/kernels/cheb_dia.py::cheb_dia``; its plain
version is :func:`repro_torch.kernels.ref.cheb_dia_ref`. This wrapper takes
CUDA tensors only (``ops.cheb_dia`` sends CPU tensors to the plain version)
and raises on anything the kernel cannot take. The kernel reads the compact
form of ``dvals`` (``plan.CompactDia``) and sweeps x in column slabs whose
width :func:`slab_for` picks (``plan.slab_width``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, plan

#: Most diagonals one launch takes (the kernel's by-value offset table).
MAX_DIAGS = 64

_ENTRY = {dt: f"cheb_dia_{sfx}" for dt, sfx in build.ENTRY_SUFFIX.items()}


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def slab_for(dtype: torch.dtype, span: int, n_b: int,
             slab: int | None = None) -> int:
    """The slab width of a launch: ``slab`` when given (tests and the
    smoke run's sweep), else the rule's choice for this operator."""
    c = plan.check_slab(slab, n_b)
    if c is not None:
        return c
    return plan.slab_width(n_b, dtype.itemsize, span)


def cheb_dia(offsets, dvals: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor, alpha: float, beta: float, *,
             compact: plan.CompactDia | None = None,
             span: int | None = None,
             slab: int | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel. ``x [Rx, n_b]`` with Rx >= R (a halo may be
    appended), ``w1/w2 [R, n_b]``, all of one dtype (fp64, fp32,
    complex128 or complex64; ``alpha`` and ``beta`` are real), contiguous
    and on one CUDA device. ``compact`` and ``span`` are those of
    ``(offsets, dvals)`` (a ``DiaPlan``'s, built once; built here when
    omitted); ``slab`` forces the slab width; ``out`` [R, n_b]
    (contiguous, not ``x``, ``w1`` or ``w2``) receives the result,
    allocated when omitted."""
    if x.device.type != "cuda":
        raise ValueError(f"cheb_dia kernel needs CUDA tensors, got {x.device}")
    offsets = [int(o) for o in offsets]
    if len(offsets) > MAX_DIAGS or offsets != sorted(set(offsets)):
        raise ValueError(f"cheb_dia: needs <= {MAX_DIAGS} ascending distinct "
                         f"offsets, got {len(offsets)}")
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in (dvals, w1, w2)):
        raise TypeError("cheb_dia: dvals/x/w1/w2 must share one dtype of "
                        "float64, float32, complex128, complex64")
    R, nb = w1.shape
    if (w2.shape != (R, nb) or dvals.shape != (len(offsets), R)
            or x.ndim != 2 or x.shape[1] != nb or x.shape[0] < R):
        raise ValueError(f"cheb_dia: shapes dvals {tuple(dvals.shape)} "
                         f"x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)}")
    for t in (dvals, x, w1, w2):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("cheb_dia: operands must be contiguous and on "
                             "one device")
    if compact is None:
        compact = plan.compact_dia(dvals, plan.diag_id_of(offsets))
    arrays = [t for t in (compact.rowptr, compact.ids, compact.vals,
                          compact.table, compact.vidx, compact.diag)
              if t is not None]
    if (compact.R != R or compact.dtype != x.dtype
            or any(t.device != x.device for t in arrays)):
        raise ValueError("cheb_dia: the compact form does not match dvals")
    if span is None:
        span = plan.span_of_dia(offsets, dvals)
    c = slab_for(x.dtype, span, nb, slab) if nb else 1
    if out is not None and (
            out.shape != (R, nb) or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()
            or any(out.data_ptr() == t.data_ptr() for t in (x, w1, w2))):
        raise ValueError("cheb_dia: out must be a contiguous [R, n_b] block "
                         "of x's dtype and device, apart from x, w1, w2")
    y = (torch.empty((R, nb), dtype=x.dtype, device=x.device)
         if out is None else out)
    lib = build.load()
    name = _ENTRY[x.dtype]
    offs = (ctypes.c_int * max(len(offsets), 1))(*offsets)
    n_table = 0 if compact.table is None else len(compact.table)
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            offs, len(offsets), compact.rowptr.data_ptr(),
            compact.ids.data_ptr(), _ptr(compact.vals), _ptr(compact.vidx),
            _ptr(compact.table), n_table, _ptr(compact.diag), compact.diag_id,
            plan.TILE_ROWS, compact.tile_max, compact.max_row, x.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), y.data_ptr(), R, x.shape[0], nb, c, float(alpha),
            float(beta), build.stream_of(x))
    build.check(err, name)
    build.launches["cheb_dia"] += 1
    return y
