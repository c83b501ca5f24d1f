"""Wrapper of the CUDA ELL SpMMV kernel (``csrc/ell_gather.cu``).

``y = y0 + A·x`` for one ELL block ``cols/vals [R, W]`` against
``x [Rx, n_b]``, per row in slot order, or with the fused Chebyshev
epilogue ``y = 2a·(y0 + A·x) + 2b·w1 − w2`` (the ``ell_gather_cheb_*``
entries), which the last block of a fused step's chain carries. It
replaces the Pallas TPU kernel
``repro/kernels/ell_gather.py::ell_gather_spmv``, and with the epilogue
the XLA-fused step body around it (``repro/core/spmv.py:1092-1097``); its
plain versions are :func:`repro_torch.kernels.ref.ell_spmv_acc_ref` and
``ref.cheb_epilogue`` of it. This wrapper takes CUDA
tensors only (``ops.ell_spmv`` sends CPU tensors to the plain version) and
raises on anything the kernel cannot take. The kernel reads the
padding-free form of the block (``plan.CompactEll``) and sweeps x in column
slabs whose width :func:`slab_for` picks.
"""
from __future__ import annotations

import torch

from . import build, plan

_ENTRY = {dt: f"ell_gather_{sfx}" for dt, sfx in build.ENTRY_SUFFIX.items()}
_CHEB_ENTRY = {dt: f"ell_gather_cheb_{sfx}"
               for dt, sfx in build.ENTRY_SUFFIX.items()}


def slab_for(n_b: int, slab: int | None = None) -> int:
    """The slab width of a launch: ``slab`` when given (tests and the
    smoke run's sweep), else the whole block: one pass, which reads the
    operator (an int32 column and a value an entry, 156 B a row at
    Hubbard(12,6) fp64, against the DIA form's 25) once. Whether narrower
    slabs pay for this kernel too is open (PERF.md, Open questions)."""
    c = plan.check_slab(slab, n_b)
    return n_b if c is None else c


def _check_block(name: str, t: torch.Tensor | None, R: int, nb: int,
                 x: torch.Tensor) -> None:
    if t is None:
        return
    if (t.shape != (R, nb) or t.dtype != x.dtype or t.device != x.device
            or not t.is_contiguous()):
        raise ValueError(f"ell_gather: {name} {tuple(t.shape)} {t.dtype} "
                         f"on {t.device} (expected contiguous [{R}, {nb}] "
                         f"{x.dtype} on {x.device})")


def ell_gather_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    y0: torch.Tensor | None = None, *,
                    compact: plan.CompactEll | None = None,
                    slab: int | None = None,
                    epilogue: tuple | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``y0 + A·x`` (``y0 = 0`` when omitted), or with
    ``epilogue = (w1, w2, alpha, beta)`` the Chebyshev step
    ``2a·(y0 + A·x) + 2b·w1 − w2``.

    ``cols`` int32 [R, W] indexing rows of ``x``; ``vals`` [R, W] and
    ``x`` [Rx, n_b] of one dtype (fp64, fp32, complex128 or complex64);
    all contiguous and on one CUDA device; ``W`` may be 0 (then
    ``y = y0``, or its epilogue). ``w1``, ``w2`` [R, n_b] of the same
    dtype, ``alpha`` and ``beta`` real. ``out`` [R, n_b] (contiguous;
    it may be ``y0``, not ``w1`` or ``w2``) receives the result;
    allocated when omitted. ``compact`` is
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
    for t in (cols, vals, x):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ell_gather: operands must be contiguous and on "
                             "one device")
    _check_block("y0", y0, R, nb, x)
    _check_block("out", out, R, nb, x)
    if epilogue is not None:
        if len(epilogue) != 4:
            raise ValueError("ell_gather: epilogue is (w1, w2, alpha, beta)")
        w1, w2, alpha, beta = epilogue
        _check_block("w1", w1, R, nb, x)
        _check_block("w2", w2, R, nb, x)
        if w1 is None or w2 is None:
            raise ValueError("ell_gather: the epilogue needs w1 and w2")
        if isinstance(alpha, complex) or isinstance(beta, complex):
            raise TypeError("ell_gather: alpha and beta must be real")
        if out is not None and any(out.data_ptr() == t.data_ptr()
                                   for t in (w1, w2)):
            raise ValueError("ell_gather: out may not be w1 or w2")
    if compact is None:
        compact = plan.compact_ell(cols, vals)
    if (compact.R != R or compact.vals.dtype != x.dtype
            or compact.max_row > W
            or any(t.device != x.device or not t.is_contiguous()
                   for t in (compact.rowptr, compact.cols, compact.vals))):
        raise ValueError("ell_gather: the compact form does not match "
                         "cols/vals")
    c = slab_for(nb, slab) if nb else 1
    y = (torch.empty((R, nb), dtype=x.dtype, device=x.device)
         if out is None else out)
    lib = build.load()
    common = (compact.rowptr.data_ptr(), compact.cols.data_ptr(),
              compact.vals.data_ptr(), plan.ELL_TILE_ROWS, compact.tile_max,
              compact.max_row, x.data_ptr(),
              y0.data_ptr() if y0 is not None else None)
    with torch.cuda.device(x.device):
        if epilogue is None:
            name = _ENTRY[x.dtype]
            err = getattr(lib, name)(*common, y.data_ptr(), R, nb, c,
                                     build.stream_of(x))
        else:
            name = _CHEB_ENTRY[x.dtype]
            err = getattr(lib, name)(*common, w1.data_ptr(), w2.data_ptr(),
                                     y.data_ptr(), R, nb, c, float(alpha),
                                     float(beta), build.stream_of(x))
    build.check(err, name)
    build.launches["ell_gather" if epilogue is None else "ell_gather_cheb"] += 1
    return y
