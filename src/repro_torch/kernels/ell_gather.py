"""Wrapper of the CUDA ELL SpMMV kernel (``csrc/ell_gather.cu``).

``y = y0 + A·x`` for one ELL block ``cols/vals [R, W]`` against
``x [Rx, n_b]``, per row in slot order. It replaces the Pallas TPU kernel
``repro/kernels/ell_gather.py::ell_gather_spmv``; its plain version is
:func:`repro_torch.kernels.ref.ell_spmv_acc_ref`. This wrapper takes CUDA
tensors only (``ops.ell_spmv`` sends CPU tensors to the plain version) and
raises on anything the kernel cannot take.
"""
from __future__ import annotations

import torch

from . import build

_ENTRY = {torch.float64: "ell_gather_f64", torch.float32: "ell_gather_f32"}


def ell_gather_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    y0: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``y0 + A·x`` (``y0 = 0`` when omitted).

    ``cols`` int32 [R, W] indexing rows of ``x``; ``vals`` [R, W] and
    ``x`` [Rx, n_b] of one real dtype (fp64 or fp32); all contiguous and on
    one CUDA device."""
    if x.is_complex() or vals.is_complex():
        raise NotImplementedError("ell_gather: complex operators are not "
                                  "ported yet, see ROADMAP")
    if x.device.type != "cuda":
        raise ValueError(f"ell_gather kernel needs CUDA tensors, got {x.device}")
    if vals.dtype not in _ENTRY or x.dtype != vals.dtype:
        raise TypeError(f"ell_gather: vals {vals.dtype} / x {x.dtype} "
                        "(expected one of float64, float32)")
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
    y = torch.empty((R, nb), dtype=x.dtype, device=x.device)
    lib = build.load()
    name = _ENTRY[x.dtype]
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                                 y0.data_ptr() if y0 is not None else None,
                                 y.data_ptr(), R, W, nb, build.stream_of(x))
    build.check(err, name)
    build.launches["ell_gather"] += 1
    return y
