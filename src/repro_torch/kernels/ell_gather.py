"""Wrapper of the CUDA ELL SpMMV kernel (``csrc/ell_gather.cu``).

``y = y0 + A·x`` for one ELL block ``cols/vals [R, W]`` against
``x [Rx, n_b]``, per row in slot order. It replaces the Pallas TPU kernel
``repro/kernels/ell_gather.py::ell_gather_spmv``; its plain version is
:func:`repro_torch.kernels.ref.ell_spmv_acc_ref`. This wrapper takes CUDA
tensors only (``ops.ell_spmv`` sends CPU tensors to the plain version) and
raises on anything the kernel cannot take. The kernel reads the
padding-free form of the block (``plan.CompactEll``) and sweeps x in column
slabs whose width :func:`slab_for` picks.
"""
from __future__ import annotations

import torch

from . import build, plan

_ENTRY = {dt: f"ell_gather_{sfx}" for dt, sfx in build.ENTRY_SUFFIX.items()}


def slab_for(n_b: int, slab: int | None = None) -> int:
    """The slab width of a launch: ``slab`` when given (tests and the
    smoke run's sweep), else the whole block: one pass, which reads the
    operator (an int32 column and a value an entry, 156 B a row at
    Hubbard(12,6) fp64, against the DIA form's 25) once. Whether narrower
    slabs pay for this kernel too is open (PERF.md, Open questions)."""
    c = plan.check_slab(slab, n_b)
    return n_b if c is None else c


def ell_gather_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    y0: torch.Tensor | None = None, *,
                    compact: plan.CompactEll | None = None,
                    slab: int | None = None) -> torch.Tensor:
    """Launch the kernel: ``y0 + A·x`` (``y0 = 0`` when omitted).

    ``cols`` int32 [R, W] indexing rows of ``x``; ``vals`` [R, W] and
    ``x`` [Rx, n_b] of one dtype (fp64, fp32, complex128 or complex64);
    all contiguous and on one CUDA device. ``compact`` is
    ``plan.compact_ell(cols, vals)`` (built once per operator; built here
    when omitted); ``slab`` forces the slab width."""
    if x.device.type != "cuda":
        raise ValueError(f"ell_gather kernel needs CUDA tensors, got {x.device}")
    if vals.dtype not in _ENTRY or x.dtype != vals.dtype:
        raise TypeError(f"ell_gather: vals {vals.dtype} / x {x.dtype} "
                        "(expected one of float64, float32, complex128, "
                        "complex64)")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_gather: cols must be int32, got {cols.dtype}")
    R, W = cols.shape
    if vals.shape != (R, W) or x.ndim != 2:
        raise ValueError(f"ell_gather: shapes cols {tuple(cols.shape)} "
                         f"vals {tuple(vals.shape)} x {tuple(x.shape)}")
    nb = x.shape[1]
    if y0 is not None and (y0.shape != (R, nb) or y0.dtype != x.dtype):
        raise ValueError(f"ell_gather: y0 {tuple(y0.shape)} {y0.dtype}")
    tensors = [cols, vals, x] + ([y0] if y0 is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ell_gather: operands must be contiguous and on "
                             "one device")
    if compact is None:
        compact = plan.compact_ell(cols, vals)
    if (compact.R != R or compact.vals.dtype != x.dtype
            or compact.max_row > W
            or any(t.device != x.device or not t.is_contiguous()
                   for t in (compact.rowptr, compact.cols, compact.vals))):
        raise ValueError("ell_gather: the compact form does not match "
                         "cols/vals")
    c = slab_for(nb, slab) if nb else 1
    y = torch.empty((R, nb), dtype=x.dtype, device=x.device)
    lib = build.load()
    name = _ENTRY[x.dtype]
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            compact.rowptr.data_ptr(), compact.cols.data_ptr(),
            compact.vals.data_ptr(), plan.ELL_TILE_ROWS, compact.tile_max,
            compact.max_row, x.data_ptr(),
            y0.data_ptr() if y0 is not None else None, y.data_ptr(), R, nb,
            c, build.stream_of(x))
    build.check(err, name)
    build.launches["ell_gather"] += 1
    return y
