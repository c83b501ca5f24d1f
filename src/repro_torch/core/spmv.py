"""Sparse matrix–(multiple)-vector multiplication on one shard.

Host side (:func:`build_dist_ell`): the one-shard ELL block of a matrix
family or CSR, real or complex, as the reference's
``build_dist_ell(matrix, 1)`` builds it — per row the stored entries in
ascending column order (lexsorted), padded to the row maximum W with column
0 and value 0. A family's rows come through the windowed generator
protocol (``matrices/matfree.py``), as the reference's do.

Device side: :func:`make_spmv` returns ``spmv(x) = A·x`` and
:func:`make_fused_cheb_step` the fused Chebyshev step
``2a·A·w1 + 2b·w1 − w2``. With the kernels on, a single SpMV runs the ELL
kernel, and the fused step runs the DIA kernel when ``ops.plan_dia``
accepts the operator (≤ 64 diagonals: Hubbard, SpinChainXXZ, Exciton,
TopIns), the ELL kernel plus the epilogue otherwise (RoadNet, HubNet). The
halo engines of the horizontal layer (P > 1) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops, plan, ref
from ..kernels.plan import span_of
from ..matrices.families import MatrixFamily
from ..matrices.matfree import collect_row_entries
from ..matrices.sparse import CSR

__all__ = ["DistEll", "build_dist_ell", "make_spmv", "make_fused_cheb_step"]


@dataclasses.dataclass
class DistEll:
    """The one-shard ELL operator: ``cols`` int32 / ``vals`` [R, W], and
    how far its entries lie from the diagonal (``span = max |col − row|``,
    recorded at build time; the DIA kernel's slab rule reads the same of
    its plan)."""

    cols: torch.Tensor
    vals: torch.Tensor
    R: int
    D: int
    span: int = 0

    @property
    def W(self) -> int:
        return int(self.cols.shape[1])


def value_dtype(dtype, is_complex: bool) -> np.dtype:
    """The working dtype of an operator: ``dtype`` (float64, float32,
    complex128 or complex64), promoted to the complex type of its
    precision when the entries are complex, as the reference's
    ``FilterDiag`` promotes (``repro/core/filter_diag.py:166-168``)."""
    dt = np.dtype(dtype)
    if dt not in (np.float64, np.float32, np.complex128, np.complex64):
        raise ValueError(f"dtype {dt}: expected float64, float32, complex128 "
                         "or complex64")
    if is_complex and dt.kind == "f":
        dt = np.dtype(np.complex128 if dt == np.float64 else np.complex64)
    return dt


def build_dist_ell(matrix: MatrixFamily | CSR, P_row: int = 1, dtype=None,
                   device="cpu") -> DistEll:
    """Build the ELL block of ``matrix`` for ``P_row`` = 1 shard, in
    ``dtype`` (the entries' own when None; a real ``dtype`` of a complex
    operator is promoted by :func:`value_dtype`)."""
    if P_row != 1:
        raise NotImplementedError("P_row > 1 (the horizontal layer) is not "
                                  "ported yet, see ROADMAP")
    if isinstance(matrix, CSR):
        D = matrix.shape[0]
        rows, cols, vals = matrix.row_entries(np.arange(D, dtype=np.int64))
    else:
        D = matrix.D
        rows, cols, vals = collect_row_entries(
            matrix, np.arange(D, dtype=np.int64))
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=D)
    W = int(counts.max()) if len(counts) else 0
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    vdt = value_dtype(dtype if dtype is not None else vals.dtype,
                      np.iscomplexobj(vals))
    cols_arr = np.zeros((D, W), dtype=np.int32)
    vals_arr = np.zeros((D, W), dtype=vdt)
    cols_arr[rows, slot] = cols
    vals_arr[rows, slot] = vals
    nz = vals != 0
    return DistEll(cols=torch.as_tensor(cols_arr, device=device),
                   vals=torch.as_tensor(vals_arr, device=device), R=D, D=D,
                   span=span_of(rows[nz], cols[nz]))


def make_spmv(ell: DistEll, *, use_kernel: bool = False):
    """Return ``spmv(x) = A·x`` for ``x [R, n_b]`` on the operator's
    device. ``use_kernel`` sends the contraction through ``ops.ell_spmv``
    (the CUDA kernel for CUDA tensors, which reads the padding-free form
    built here, once); otherwise the plain version runs. Both accumulate
    each row in slot order, each entry rounded as the reference rounds it
    (``ref.mac``)."""
    cols, vals = ell.cols, ell.vals
    if use_kernel:
        compact = (plan.compact_ell(cols, vals)
                   if cols.device.type == "cuda" else None)
        return lambda x: ops.ell_spmv(cols, vals, x, compact=compact)
    return lambda x: ref.ell_spmv_ref(cols, vals, x)


def make_fused_cheb_step(ell: DistEll, *, use_kernel: bool = False):
    """Return ``step(w1, w2, alpha, beta) = 2a·A·w1 + 2b·w1 − w2``.

    With ``use_kernel`` an operator that ``ops.plan_dia`` accepts runs the
    whole step in the DIA kernel (ascending offsets == ascending columns ==
    the ELL slot order, and the same epilogue, so the result is unchanged);
    otherwise the SpMV runs first and the epilogue follows in torch, in the
    reference's operation order. A step on the DIA route carries its
    :class:`~repro_torch.kernels.ops.DiaPlan` as ``step.dia``; the plan's
    compact form and span are built here, once."""
    if use_kernel:
        dia = ops.plan_dia(ell.cols, ell.vals, ell.R, device=ell.vals.device)
        if dia is not None:
            offsets, dvals = dia.offsets, dia.dvals
            compact, span = dia.compact, dia.span

            def step_dia(w1, w2, alpha, beta):
                return ops.cheb_dia(offsets, dvals, w1, w1, w2, alpha, beta,
                                    compact=compact, span=span)

            step_dia.dia = dia
            return step_dia
    spmv = make_spmv(ell, use_kernel=use_kernel)

    def step(w1, w2, alpha, beta):
        return ref.cheb_epilogue(spmv(w1), w1, w2, alpha, beta)

    return step
