"""The yardstick's byte counts equal hand counts at the configurations'
SMOKE sizes, and the kernel names map to the program's kernels."""
import numpy as np
import pytest

import _tiny  # noqa: F401  (the paths)

from portbench.harness import roofline as rf
from portbench.harness.record import Run
from portbench.reference import check

SMOKE = [("hubbard", dict(family="Hubbard", n_sites=8, n_fermions=4, U=4.0,
                          ranpot=1.0), 16, 8),
         ("exciton", dict(family="Exciton", L=4), 16, 16)]


@pytest.mark.parametrize("ref,matrix,n_s,b", SMOKE)
def test_step_and_launch_bytes_by_hand(ref, matrix, n_s, b):
    A = check.operator(dict(reference=ref, matrix=matrix))
    D, nnz = A.shape[0], A.nnz
    run = Run(config=dict(fd=dict(dtype="float64")), traffic={}, setup_s=0,
              window_s=0, solves=[], peak_mem_bytes=0, A=A)
    assert rf.elem_bytes(run) == b
    # a fused step: every entry (value + int32 column), then w1, w2, Y
    # read and w, Y written
    hand = 0
    for _ in range(nnz):
        hand += b + 4
    for _ in range(5):
        hand += D * n_s * b
    assert rf.step_bytes(nnz, D, n_s, b) == hand
    assert rf.dia_launch_bytes(nnz, D, n_s, b) == hand - 2 * D * n_s * b
    assert rf.ell_cheb_launch_bytes(nnz, 0, D, n_s, b, y0=False) == \
        rf.dia_launch_bytes(nnz, D, n_s, b)


@pytest.mark.parametrize("ref,matrix,n_s,b", SMOKE)
@pytest.mark.parametrize("P", [2, 4])
def test_halo_need_by_hand(ref, matrix, n_s, b, P):
    A = check.operator(dict(reference=ref, matrix=matrix))
    D = A.shape[0]
    R = -(-D // P)
    entries, rows = 0, 0
    for p in range(P):
        mine = set(range(p * R, min((p + 1) * R, D)))
        remote = set()
        for r in mine:
            for c in A.indices[A.indptr[r]:A.indptr[r + 1]]:
                if c not in mine:
                    entries += 1
                    remote.add(int(c))
        rows += len(remote)
    assert rf.halo_need(A, P) == (entries, rows)
    x_rows = rows
    want = entries * (b + 4) + (x_rows + 4 * D) * n_s * b
    assert rf.ell_cheb_launch_bytes(entries, x_rows, D, n_s, b,
                                    y0=True) == want


def test_kernel_names():
    f64 = "double"
    dia = (f"void slab_sweep<{f64}, 2, 4, DiaOp<{f64}, 2, false> >"
           f"(DiaOp<{f64}, 2, false>, {f64} const*, {f64}*, Sweep)")
    epi = (f"void slab_sweep<{f64}, 2, 4, EllOp<{f64}, 2, true> >"
           f"(EllOp<{f64}, 2, true>, {f64} const*, {f64}*, Sweep)")
    cx = ("void slab_sweep<c10::complex<double>, 1, 1, "
          "EllOp<c10::complex<double>, 1, false> >(...)")
    assert rf.kernel_of(dia) == "cheb_dia"
    assert rf.kernel_of(epi) == "ell_gather_cheb"
    assert rf.kernel_of(cx) == "ell_gather"
    # as the profiler names them on the card
    for flag, kernel in (("true", "ell_gather_cheb"), ("false", "ell_gather")):
        op = f"repro_torch::EllOp<double, 2, {flag}>"
        traced = (f"void repro_torch::slab_sweep<double, 2, 4, {op} >({op}, "
                  "double const*, double*, repro_torch::Sweep)")
        assert rf.kernel_of(traced) == kernel
    assert rf.kernel_of("void at::native::vectorized_elementwise_kernel") \
        is None
    run = Run(config={}, traffic={}, setup_s=0, window_s=0, solves=[],
              peak_mem_bytes=0,
              trace=dict(kernels={dia: [3, 0.5], epi: [2, 0.25],
                                  "other": [9, 9.0]}))
    assert rf.kernel_time(run, "cheb_dia") == (3, 0.5)
    assert rf.kernel_time(run, "ell_gather_cheb") == (2, 0.25)
    assert np.isclose(rf.HBM_BYTES_PER_S, 3.35e12)
