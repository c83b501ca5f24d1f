"""The reference's frozen generators give the program's matrices, and its
eigenvalues agree with a dense ``numpy.linalg.eigh`` (SMOKE sizes)."""
import numpy as np
import pytest

import _tiny  # noqa: F401  (the paths)

from portbench.reference import check

SMOKE = [("hubbard", dict(family="Hubbard", n_sites=8, n_fermions=4, U=4.0,
                          ranpot=1.0)),
         ("hubbard", dict(family="Hubbard", n_sites=6, n_fermions=3, U=25.0,
                          ranpot=1.0)),
         ("exciton", dict(family="Exciton", L=4)),
         ("exciton", dict(family="Exciton", L=2))]


@pytest.mark.parametrize("ref,matrix", SMOKE)
def test_frozen_generator_equals_the_programs(ref, matrix):
    from repro_torch.matrices import get_family

    params = dict(matrix)
    B = get_family(params.pop("family"), **params).build_csr().to_scipy()
    B.sum_duplicates()
    B.sort_indices()
    A = check.operator(dict(reference=ref, matrix=matrix))
    assert A.shape == B.shape and A.dtype == B.dtype
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


@pytest.mark.parametrize("ref,matrix", SMOKE)
def test_reference_eigenvalues_match_dense_eigh(ref, matrix, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(check, "CACHE", tmp_path)
    config = dict(name="smoke", reference=ref, matrix=matrix)
    A = check.operator(config)
    dense = np.linalg.eigvalsh(A.toarray())
    w = check.reference_eigenvalues(config, A, 12)
    assert np.max(np.abs(w - dense[:12])) < 1e-12
    assert len(list(tmp_path.iterdir())) == 1
    again = check.reference_eigenvalues(config, A, 12)  # from the cache
    assert np.array_equal(again, w)


def test_judge_reads_pairs():
    A = check.operator(dict(reference="hubbard", matrix=SMOKE[1][1]))
    w, X = np.linalg.eigh(A.toarray())
    good = dict(eigenvalues=w[:4], eigenvectors=X[:, :4])
    v = check.judge(A, w[:12], [good], n_target=4, target=w[0] - 0.1)
    assert v["failed"] == 0
    assert v["eig_err"] < 1e-13 and v["resid"] < 1e-12
    assert v["orth_err"] < 1e-13
    short = dict(eigenvalues=w[:3], eigenvectors=X[:, :3])
    assert check.judge(A, w[:12], [good, short, dict(error="x")],
                       n_target=4, target=w[0] - 0.1)["failed"] == 2
    moved = dict(eigenvalues=w[:4] + 1e-6, eigenvectors=X[:, :4])
    v = check.judge(A, w[:12], [moved], n_target=4, target=w[0] - 0.1)
    assert v["eig_err"] > 9e-7 and v["resid"] > 9e-7


def test_judge_wants_the_nearest_states_entry_by_entry():
    """A solve that steps over a wanted state and returns the next one
    out, each pair exact, fails ``eig_err``; the reference must hold every
    state that near the target; an interior target takes both sides."""
    A = check.operator(dict(reference="hubbard", matrix=SMOKE[1][1]))
    w, X = np.linalg.eigh(A.toarray())
    tau = w[0] - 0.1
    skip = [0, 2, 3, 4]
    stepped = dict(eigenvalues=w[skip], eigenvectors=X[:, skip])
    v = check.judge(A, w[:12], [stepped], n_target=4, target=tau)
    assert v["resid"] < 1e-12 and v["orth_err"] < 1e-13
    assert v["eig_err"] > 1e-2
    assert v["eig_err"] == pytest.approx(np.max(w[skip] - w[:4]))
    # more pairs than asked for: the nearest n_target are judged
    more = dict(eigenvalues=w[:6], eigenvectors=X[:, :6])
    assert check.judge(A, w[:12], [more], n_target=4,
                       target=tau)["eig_err"] < 1e-13
    with pytest.raises(ValueError, match="reference_k"):
        check.judge(A, w[:4], [more], n_target=4, target=w[3])
    mid = float(w[20])
    near = np.argsort(np.abs(w - mid))[:4]
    inner = dict(eigenvalues=w[near], eigenvectors=X[:, near])
    assert check.judge(A, w[:40], [inner], n_target=4,
                       target=mid)["eig_err"] < 1e-13
