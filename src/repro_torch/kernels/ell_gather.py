"""Wrapper of the CUDA ELL SpMMV kernel (``csrc/ell_gather.cu``).

``y = y0 + A·x`` for an ELL block, per row in slot order, or with the
fused Chebyshev epilogue ``y = 2a·(y0 + A·x) + 2b·w1 − w2`` (the
``ell_gather_cheb_*`` entries), which the last block of a fused step's
chain carries. It replaces the Pallas TPU kernel
``repro/kernels/ell_gather.py::ell_gather_spmv``, and with the epilogue
the XLA-fused step body around it (``repro/core/spmv.py:1092-1097``); its
plain versions are :func:`repro_torch.kernels.ref.ell_spmv_acc_ref` and
``ref.cheb_epilogue`` of it, and for a block of P row shards
:func:`repro_torch.kernels.ref.ell_grouped_ref`.

One launch takes a block of every row shard: :class:`EllLaunch`, built
once per block from the shards' stacked padding-free form
(``plan.compact_ell_grouped``), checks the operator once and holds the C
entry points; each call checks only the views it is given (shapes,
strides, dtype, device, overlap) and passes each operand's shard stride,
so a strided view of a larger buffer goes in without a copy.
:func:`ell_gather_spmv` is one block (P = 1) through the same launch.
Both take CUDA tensors only (``ops.ell_spmv`` sends CPU tensors to the
plain version; the engines run ``core/spmv.py::_contract_plain`` on the
CPU) and raise on anything the kernel cannot take; ``ops.ell_census``
counts their launches for an op census. The kernel sweeps x in
column slabs whose width :func:`slab_for` picks.
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


def _extent(t: torch.Tensor) -> tuple[int, int]:
    """The byte range ``[a, b)`` of a ``[P, rows, nb]`` view whose rows
    are row-major."""
    P, rows, nb = t.shape
    if not t.numel():
        return t.data_ptr(), t.data_ptr()
    n = (P - 1) * t.stride(0) + rows * nb
    return t.data_ptr(), t.data_ptr() + n * t.element_size()


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class EllLaunch:
    """A prepared launch of the ELL kernel on a block of ``P`` row shards.

    ``compact`` is the block's stacked padding-free form
    (``plan.compact_ell_grouped``, or ``plan.compact_ell`` for one block),
    on one CUDA device, of fp64, fp32, complex128 or complex64. Built once
    per block: it checks the form and resolves the C entry points (the
    first one built builds the kernels). A call takes ``[P, rows, n_b]``
    views: ``x`` with at least ``compact.x_rows`` rows, ``y0``, ``out``
    and the epilogue's ``w1``, ``w2`` with ``R`` rows; each with its rows
    row-major (row stride ``n_b``, unit column stride) and any shard
    stride (a shard's rows of a larger buffer)."""

    def __init__(self, compact: plan.CompactEll):
        cp = compact
        dev = cp.vals.device
        if dev.type != "cuda":
            raise ValueError("ell_gather kernel needs CUDA tensors, got "
                             f"{dev}")
        if cp.vals.dtype not in _ENTRY:
            raise TypeError(f"ell_gather: vals {cp.vals.dtype} (expected one "
                            "of float64, float32, complex128, complex64)")
        if cp.rowptr.dtype != torch.int32 or cp.cols.dtype != torch.int32:
            raise TypeError("ell_gather: row pointers and columns must be "
                            "int32")
        if (cp.P < 1 or cp.rowptr.numel() != cp.P * cp.R + 1
                or cp.cols.shape != cp.vals.shape
                or any(t.device != dev or not t.is_contiguous()
                       for t in (cp.rowptr, cp.cols, cp.vals))):
            raise ValueError("ell_gather: the compact form is not P shards "
                             "of contiguous row pointers, columns and values "
                             "on one device")
        self.compact, self.P, self.R = cp, cp.P, cp.R
        self.dtype, self.device = cp.vals.dtype, dev
        lib = build.load()
        self._entry = getattr(lib, _ENTRY[self.dtype])
        self._cheb = getattr(lib, _CHEB_ENTRY[self.dtype])
        self._op = (cp.rowptr.data_ptr(), cp.cols.data_ptr(),
                    cp.vals.data_ptr(), plan.ELL_TILE_ROWS, cp.tile_max,
                    cp.max_row)

    def _view(self, name: str, t: torch.Tensor, rows: int | None,
              nb: int) -> int:
        """Check one ``[P, rows, nb]`` operand (``rows`` None: at least
        ``compact.x_rows``); its shard stride in elements."""
        ok = (t.dtype == self.dtype and t.device == self.device
              and t.dim() == 3 and t.shape[0] == self.P and t.shape[2] == nb
              and (t.shape[1] == rows if rows is not None
                   else t.shape[1] >= self.compact.x_rows)
              and (t.stride(2) == 1 or nb <= 1)
              and (t.stride(1) == nb or t.shape[1] <= 1))
        s = t.stride(0) if self.P > 1 else 0
        if not ok or s < 0:
            want = f"{rows}" if rows is not None else \
                f">= {self.compact.x_rows}"
            raise ValueError(
                f"ell_gather: {name} {tuple(t.shape)} strides {t.stride()} "
                f"{t.dtype} on {t.device} (expected [{self.P}, {want}, {nb}] "
                f"row-major rows of {self.dtype} on {self.device})")
        return s

    def __call__(self, x: torch.Tensor, y0: torch.Tensor | None = None, *,
                 out: torch.Tensor, epilogue: tuple | None = None,
                 slab: int | None = None) -> torch.Tensor:
        """One launch: ``out = y0 + A·x`` shard by shard (``y0 = 0`` when
        omitted), or with ``epilogue = (w1, w2, alpha, beta)`` (real
        ``alpha``, ``beta``) the Chebyshev step ``2a·(y0 + A·x) + 2b·w1 −
        w2``. ``out`` may be ``y0`` (the same view), and shares no memory
        with ``x``, ``w1`` or ``w2``; ``slab`` forces the slab width.
        Returns ``out``."""
        P, R = self.P, self.R
        nb = x.shape[-1]
        sx = self._view("x", x, None, nb)
        sy = self._view("out", out, R, nb)
        if P > 1 and R and sy < R * nb:
            raise ValueError(f"ell_gather: out's shard stride {sy} overlaps "
                             f"its shards of {R} × {nb}")
        span = _extent(out)
        if _overlap(span, _extent(x)):
            raise ValueError("ell_gather: out may not overlap x")
        sy0 = 0
        if y0 is not None:
            sy0 = self._view("y0", y0, R, nb)
            if _overlap(span, _extent(y0)) and (
                    y0.data_ptr() != out.data_ptr() or sy0 != sy):
                raise ValueError("ell_gather: y0 may be out but not overlap "
                                 "it otherwise")
        c = slab_for(nb, slab) if nb else 1
        stream = torch.cuda.current_stream(self.device).cuda_stream
        if epilogue is None:
            name = _ENTRY[self.dtype]
            args = (*self._op, x.data_ptr(),
                    None if y0 is None else y0.data_ptr(), out.data_ptr(), P,
                    R, nb, c, sx, sy0, sy, stream)
            fn = self._entry
        else:
            if len(epilogue) != 4:
                raise ValueError("ell_gather: epilogue is (w1, w2, alpha, "
                                 "beta)")
            w1, w2, alpha, beta = epilogue
            if w1 is None or w2 is None:
                raise ValueError("ell_gather: the epilogue needs w1 and w2")
            if isinstance(alpha, complex) or isinstance(beta, complex):
                raise TypeError("ell_gather: alpha and beta must be real")
            s1 = self._view("w1", w1, R, nb)
            s2 = self._view("w2", w2, R, nb)
            if _overlap(span, _extent(w1)) or _overlap(span, _extent(w2)):
                raise ValueError("ell_gather: out may not be (or overlap) "
                                 "w1 or w2")
            name = _CHEB_ENTRY[self.dtype]
            args = (*self._op, x.data_ptr(),
                    None if y0 is None else y0.data_ptr(), w1.data_ptr(),
                    w2.data_ptr(), out.data_ptr(), P, R, nb, c, sx, sy0, s1,
                    s2, sy, float(alpha), float(beta), stream)
            fn = self._cheb
        if torch.cuda.current_device() != self.device.index:
            with torch.cuda.device(self.device):
                err = fn(*args)
        else:
            err = fn(*args)
        build.check(err, name)
        build.launches["ell_gather" if epilogue is None
                       else "ell_gather_cheb"] += 1
        return out


def ell_gather_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    y0: torch.Tensor | None = None, *,
                    compact: plan.CompactEll | None = None,
                    slab: int | None = None,
                    epilogue: tuple | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One block, P = 1 of :class:`EllLaunch`: ``cols`` int32 and
    ``vals [R, W]``, ``x [Rx, n_b]``, ``y0``, ``out`` and the epilogue's
    ``w1``, ``w2 [R, n_b]``, as :meth:`EllLaunch.__call__` takes them
    (``out`` allocated when omitted). ``compact`` is
    ``plan.compact_ell(cols, vals)``, built here when omitted."""
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_gather: cols must be int32, got {cols.dtype}")
    launch = EllLaunch(plan.compact_ell(cols, vals) if compact is None
                       else compact)
    if launch.P != 1 or launch.R != cols.shape[0]:
        raise ValueError("ell_gather: the compact form is not that of "
                         "cols/vals")
    y = x.new_empty((launch.R, x.shape[-1])) if out is None else out
    epi = None if epilogue is None else (
        *(None if w is None else w[None] for w in epilogue[:2]),
        *epilogue[2:])
    launch(x[None], None if y0 is None else y0[None], out=y[None],
           epilogue=epi, slab=slab)
    return y
