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
operator, the ELL contraction plus epilogue otherwise.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import ref
from .plan import CompactDia, CompactEll, compact_dia, diag_id_of, span_of_dia

#: Max distinct diagonal offsets before plan_dia refuses (the DIA form
#: stores n_diag * R values; past a few dozen diagonals the gather-free
#: format stops paying for itself).
DIA_MAX_DIAGS = 64


def ell_spmv(cols, vals, x, y0=None, *, compact: CompactEll | None = None,
             slab: int | None = None):
    """``y0 + A·x`` for one ELL block ``cols/vals [R, W]`` (``y0 = 0``
    when omitted), per row in slot order. The kernel reads the
    padding-free form of the block (``compact``, built once per operator;
    built here when omitted), the plain version ``cols/vals``; ``slab``
    forces the kernel's slab width (the plain version has none)."""
    if x.device.type == "cpu":
        acc = y0 if y0 is not None else torch.zeros(
            (cols.shape[0], x.shape[1]), dtype=torch.result_type(vals, x))
        return ref.ell_spmv_acc_ref(acc, cols, vals, x)
    from .ell_gather import ell_gather_spmv

    return ell_gather_spmv(cols, vals, x, y0, compact=compact, slab=slab)


def cheb_dia(offsets, dvals, x, w1, w2, alpha, beta, *,
             compact: CompactDia | None = None, span: int | None = None,
             slab: int | None = None):
    """Fused Chebyshev DIA step ``2a·(A@x) + 2b·w1 − w2``. The kernel
    reads the compact form of ``dvals`` (a :class:`DiaPlan`'s ``compact``,
    built once; built here when omitted), the plain version ``dvals``."""
    if x.device.type == "cpu":
        return ref.cheb_dia_ref(offsets, dvals, x, w1, w2, alpha, beta)
    from .cheb_dia import cheb_dia as kernel

    return kernel(offsets, dvals, x, w1, w2, alpha, beta, compact=compact,
                  span=span, slab=slab)


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
