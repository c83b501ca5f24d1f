"""The benchmark's yardstick for bytes: the card's peak and what a step or
a kernel launch needs, counted from the matrix's shape and nonzeros (the
reference's own operator), never from what a kernel happens to read.

An operator entry needs its value and a 4-byte column index; a block of
``rows × n_b`` elements of ``b`` bytes is read or written once per use.
"""
from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at 700 W)
HBM_BYTES_PER_S = 3.35e12
INDEX_BYTES = 4


def elem_bytes(run) -> int:
    """Bytes of one element of the solve's blocks: the configuration's
    real dtype, doubled for a complex operator."""
    real = {"float64": 8, "float32": 4}[run.config["fd"].get("dtype",
                                                              "float64")]
    return 2 * real if np.iscomplexobj(run.A.data) else real


def step_bytes(nnz: int, D: int, n_s: int, b: int) -> int:
    """One fused filter step over the whole block with its ``Y`` update,
    ``w <- 2a·A·w1 + 2b·w1 - w2; Y += mu_k·w``: A's entries once, w1, w2
    and Y read, w and Y written."""
    return nnz * (b + INDEX_BYTES) + 5 * D * n_s * b


def dia_launch_bytes(nnz: int, rows: int, n_b: int, b: int) -> int:
    """One ``cheb_dia`` launch, ``w = 2a·A·w1 + 2b·w1 - w2`` over ``rows``
    rows at width ``n_b``: the operator once, w1 (which is also x) and w2
    read, w written."""
    return nnz * (b + INDEX_BYTES) + 3 * rows * n_b * b


def ell_cheb_launch_bytes(nnz: int, x_rows: int, rows: int, n_b: int,
                          b: int, y0: bool) -> int:
    """One ``ell_gather_cheb`` launch over all row shards: the block's
    ``nnz`` entries once, the ``x_rows`` rows of x it gathers, ``y0`` (the
    local block's partial sums, when the launch starts from them), w1 and
    w2 read, w written, each over ``rows`` rows at width ``n_b``."""
    vec = (x_rows + (4 if y0 else 3) * rows) * n_b * b
    return nnz * (b + INDEX_BYTES) + vec


def halo_need(A, P: int) -> tuple[int, int]:
    """``(entries, rows)`` of the halo of the equal-rows partition of
    ``A`` into ``P`` row shards of ``ceil(D/P)`` rows: the entries whose
    column another shard owns, and the distinct such columns, summed over
    the shards."""
    D = A.shape[0]
    R = -(-D // P)
    owner_row = np.repeat(np.arange(D) // R, np.diff(A.indptr))
    owner_col = A.indices // R
    remote = owner_row != owner_col
    pairs = np.unique(owner_row[remote] * D + A.indices[remote])
    return int(remote.sum()), int(pairs.size)


def _template_args(name: str, template: str) -> str | None:
    """The text between ``template<`` and its matching ``>`` in a
    demangled kernel name, or None."""
    i = name.find(template + "<")
    if i < 0:
        return None
    depth, j0 = 0, i + len(template)
    for j in range(j0, len(name)):
        depth += {"<": 1, ">": -1}.get(name[j], 0)
        if depth == 0:
            return name[j0 + 1:j]
    return None


def kernel_of(name: str) -> str | None:
    """Which of the program's kernels a device event is: every one is
    ``slab_sweep<T, VEC, NV, Op>`` (``kernels/csrc/common.cuh``), with
    ``DiaOp`` for ``cheb_dia`` and ``EllOp<T, VEC, EPI>`` for
    ``ell_gather`` (EPI false) and ``ell_gather_cheb`` (EPI true)."""
    if "DiaOp" in name:
        return "cheb_dia"
    args = _template_args(name, "EllOp")
    if args is not None:
        return "ell_gather_cheb" if args.rstrip().endswith("true") \
            else "ell_gather"
    return None


def kernel_time(run, kernel: str) -> tuple[int, float]:
    """``(launches, device seconds)`` of ``kernel`` in the traced
    window."""
    n, s = 0, 0.0
    for name, (count, seconds) in run.trace["kernels"].items():
        if kernel_of(name) == kernel:
            n += count
            s += seconds
    return n, s
