"""Plain PyTorch versions of the two kernels (shape-exact references).

They run on any device: on the CPU they are what ``ops`` dispatches to,
on the card ``chip_smoke.py`` holds each CUDA kernel against them.

Each entry is folded into the accumulator by :func:`mac`, in the rounding
of the reference's scan body ``acc + v·x[c]`` on the CPU:

* real: ``torch.addcmul``, ``acc + v·x`` with one rounding, as XLA's CPU
  backend contracts that body into an FMA, so in fp64 the ELL contraction
  here equals ``repro.kernels.ref`` bit for bit (a plain ``acc + v * x``
  rounds twice and differs in the last bits);
* complex: the product's planes as XLA's CPU backend contracts them,
  ``fma(vr, xr, −(vi·xi))`` and ``fma(vi, xr, vr·xi)``, then one rounded
  add into each plane of the accumulator (found by matching the reference
  on random complex blocks; complex ``addcmul`` on the CPU rounds each
  product instead and differs in the last bits). It is spelled here as
  separate torch operations on the real planes, each FMA an ``addcmul``,
  so that the plain version computes the same function on both devices.

``ell_spmv_slab_ref``, ``cheb_dia_compact_ref`` and ``ell_grouped_ref``
follow the CUDA kernels' schedule instead (column slabs, the compact DIA
form, one launch over the stacked form of P row shards); the CPU tests
hold them bit-equal to the two plain versions above them.
"""
from __future__ import annotations

import torch


def mac(acc, v, x):
    """``acc + v·x`` (``v`` broadcast over ``x``) in the reference's
    rounding: one fused multiply-add when real; when complex, each plane
    of the product one fused multiply-add over a rounded product, then one
    rounded add (module docstring)."""
    if not acc.is_complex():
        return torch.addcmul(acc, v, x)
    v, x = v.to(acc.dtype), x.to(acc.dtype)
    vr, vi, xr, xi = v.real, v.imag, x.real, x.imag
    pr = torch.addcmul(-(vi * xi), vr, xr)
    pi = torch.addcmul(vr * xi, vi, xr)
    return torch.complex(acc.real + pr, acc.imag + pi)


def ell_spmv_acc_ref(acc, cols, vals, x):
    """Accumulator-threaded ELL contraction: one slot per step into
    ``acc``, so per output element the addition order is the slot order.
    ``cols/vals [R, W]``, ``x [Rx, nb]``, ``acc [R, nb]``."""
    for w in range(cols.shape[1]):
        acc = mac(acc, vals[:, w, None], x.index_select(0, cols[:, w]))
    return acc


def ell_spmv_ref(cols, vals, x):
    """y[r] = sum_w vals[r, w] * x[cols[r, w]];  cols [R,W], x [Rx, nb]."""
    acc0 = torch.zeros((cols.shape[0], x.shape[1]),
                       dtype=torch.result_type(vals, x), device=x.device)
    return ell_spmv_acc_ref(acc0, cols, vals, x)


def cheb_dia_ref(offsets, dvals, x, w1, w2, alpha, beta):
    """Fused Chebyshev step for a DIA (diagonal-offset) matrix.

    y = 2*alpha*(A@x) + 2*beta*w1 - w2 with
    (A@x)[i] = sum_d dvals[d, i] * x[i + offsets[d]]  (zero out of range).

    ``offsets`` ascending ints; ``dvals [n_diag, R]``; ``x [Rx, nb]`` with
    Rx >= R (a halo may be appended); ``w1/w2 [R, nb]``. Each diagonal is
    one shifted slice of ``x`` (no gather), accumulated with one rounding
    per entry in ascending offset order — the ELL slot order of the same
    operator, so the two contractions agree bit for bit.
    """
    R, nb = w1.shape
    Rx = x.shape[0]
    acc = torch.zeros((R, nb), dtype=torch.result_type(dvals, x), device=x.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(R, Rx - off)
        if lo >= hi:
            continue
        acc[lo:hi] = mac(acc[lo:hi], dvals[d, lo:hi, None],
                         x[lo + off:hi + off])
    return cheb_epilogue(acc, w1, w2, alpha, beta)


def ell_spmv_slab_ref(cols, vals, x, y0, slab):
    """``y0 + A·x`` (``y0`` may be None) one column slab of width ``slab``
    at a time, as the ELL kernel sweeps it."""
    R, nb = cols.shape[0], x.shape[1]
    y = torch.empty((R, nb), dtype=torch.result_type(vals, x), device=x.device)
    for j0 in range(0, nb, slab):
        j1 = min(j0 + slab, nb)
        acc = (y0[:, j0:j1] if y0 is not None else
               torch.zeros((R, j1 - j0), dtype=y.dtype, device=x.device))
        y[:, j0:j1] = ell_spmv_acc_ref(acc, cols, vals, x[:, j0:j1])
    return y


def cheb_dia_compact_ref(offsets, compact, x, w1, w2, alpha, beta, slab):
    """The fused DIA step read from the compact form (``plan.CompactDia``)
    one column slab at a time, as the DIA kernel computes it: per row only
    the stored entries, in ascending offset order, masked to ``[0, Rx)``."""
    R, nb = w1.shape
    Rx = x.shape[0]
    rp = compact.rowptr.to(torch.int64)
    counts = rp[1:] - rp[:-1]
    slot = torch.arange(compact.max_row, device=x.device)
    live = slot[None, :] < counts[:, None]
    idx = torch.where(live, rp[:-1, None] + slot[None, :], 0)
    off = torch.as_tensor(list(offsets), dtype=torch.int64, device=x.device)
    cols = (torch.arange(R, device=x.device)[:, None]
            + off[compact.ids[idx].to(torch.int64)])
    ok = live & (cols >= 0) & (cols < Rx)
    vals = torch.where(ok, compact.entry_values()[idx], 0)
    cols = torch.where(ok, cols, 0)
    y = torch.empty((R, nb), dtype=x.dtype, device=x.device)
    for j0 in range(0, nb, slab):
        j1 = min(j0 + slab, nb)
        acc = ell_spmv_ref(cols, vals, x[:, j0:j1])
        y[:, j0:j1] = cheb_epilogue(acc, w1[:, j0:j1], w2[:, j0:j1], alpha, beta)
    return y


def ell_grouped_ref(compact, x, y0=None, epilogue=None):
    """The grouped ELL launch's plain version: ``y0 + A_p·x_p`` for each
    of the ``P`` row shards of ``compact`` (``plan.compact_ell_grouped``),
    with ``epilogue = (w1, w2, alpha, beta)`` its Chebyshev step
    ``2a·(y0 + A_p·x_p) + 2b·w1 − w2``. ``x [P, Rx, nb]``, ``y0``, ``w1``,
    ``w2 [P, R, nb]`` are the views the kernel takes, each shard's rows
    read where the view's shard stride puts them. It walks the stacked
    form as the kernel does: shard p's row r is row ``p·R + r``, its
    stored entries in slot order, each column local to the shard's x, each
    folded into the accumulator (``y0``, or 0) by :func:`mac`; an entry
    that is not stored is not visited. Returns a new ``[P, R, nb]``."""
    P, R = compact.P, compact.R
    nb = x.shape[2]
    cols, vals = compact.to_ell()  # [P·R, max_row], padded past each row
    rp = compact.rowptr.to(torch.int64)
    live = (torch.arange(compact.max_row, device=x.device)[None, :]
            < (rp[1:] - rp[:-1])[:, None]).view(P, R, -1)
    cols = cols.to(torch.int64).view(P, R, -1)
    vals = vals.view(P, R, -1)
    shard = torch.arange(P, device=x.device)[:, None]
    acc = (y0.clone() if y0 is not None else
           torch.zeros((P, R, nb), dtype=x.dtype, device=x.device))
    for w in range(compact.max_row):
        stored = live[:, :, w, None]
        acc = torch.where(stored, mac(acc, vals[:, :, w, None],
                                      x[shard, cols[:, :, w]]), acc)
    if epilogue is not None:
        acc = cheb_epilogue(acc, *epilogue)
    return acc


def cheb_epilogue(y, w1, w2, alpha, beta):
    """``2a·y + 2b·w1 − w2`` rounded as the reference's fused step body
    ``2.0 * a * y + 2.0 * b * w1 - w2`` is on the CPU: each product
    rounded, then the two sums in order (XLA does not contract this
    expression into an FMA). ``alpha`` and ``beta`` are real, so on a
    complex block each plane is scaled on its own: the same rounding,
    spelled on the planes so that no backend forms a complex product."""
    if y.is_complex():
        return torch.complex(
            cheb_epilogue(y.real, w1.real, w2.real, alpha, beta),
            cheb_epilogue(y.imag, w1.imag, w2.imag, alpha, beta))
    return 2.0 * alpha * y + 2.0 * beta * w1 - w2
