"""Judge the eigenpairs a solve returned against the plain reference.

The reference builds the operator itself (``<reference>.coo`` of the
configuration's ``reference`` module, from the configuration's matrix
parameters) and computes its lowest eigenvalues with ARPACK in float64.
Those depend on the configuration alone, so they are cached under
``portbench/_cache/reference/`` at a path named by a digest of what they
depend on: only a checkout's first run pays for them.

Three numbers are compared for every solve, each the worst over the
window (``judge``):

* ``eig_err``: the ``n_target`` returned eigenvalues nearest the target,
  in ascending order, against the ``n_target`` reference eigenvalues
  nearest the target, in ascending order, entry by entry: a solve that
  steps over an eigenvalue, or over one copy of a repeated one, and
  returns one farther out in its place reads the gap between them;
* ``resid``: ``||A x - theta x|| / ||x||`` of every returned pair, with
  the reference's operator;
* ``orth_err``: the largest entry of ``X^H X - I`` of a solve's vectors.

A solve that returns fewer than ``n_target`` pairs, or raises, has failed.
"""
from __future__ import annotations

import hashlib
import importlib
import json
import os
from pathlib import Path

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

CACHE = Path(__file__).resolve().parent.parent / "_cache" / "reference"
#: bump when the way the reference eigenvalues are computed changes
VERSION = 1
NUMBERS = ("eig_err", "resid", "orth_err")


def operator(config: dict) -> scipy.sparse.csr_matrix:
    """The configuration's matrix as a SciPy CSR, built by the frozen
    generator its ``reference`` key names."""
    gen = importlib.import_module(f"{__package__}.{config['reference']}")
    params = {k: v for k, v in config["matrix"].items() if k != "family"}
    rows, cols, vals, D = gen.coo(**params)
    A = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(D, D))
    A.sum_duplicates()
    A.sort_indices()
    return A


def lowest(A, k: int, seed: int = 0) -> np.ndarray:
    """The ``k`` lowest eigenvalues of the Hermitian ``A`` by ARPACK
    (``eigsh`` to machine precision, from a seeded start), ascending. A
    run that does not converge raises."""
    v0 = np.random.default_rng(seed).standard_normal(A.shape[0])
    w = scipy.sparse.linalg.eigsh(
        A, k=k, which="SA", tol=0.0, v0=v0.astype(A.dtype),
        ncv=min(A.shape[0] - 1, max(2 * k + 1, 80)),
        return_eigenvectors=False)
    return np.sort(w)


def reference_eigenvalues(config: dict, A, k: int) -> np.ndarray:
    """The ``k`` lowest eigenvalues of the configuration's operator in
    float64, from the cache when it holds them."""
    key = json.dumps(dict(v=VERSION, ref=config["reference"],
                          matrix=config["matrix"], k=k), sort_keys=True)
    path = CACHE / (f"{config['name']}-"
                    f"{hashlib.sha256(key.encode()).hexdigest()[:16]}.npy")
    if path.exists():
        return np.load(path)
    w = lowest(A, k)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
    np.save(tmp, w)
    os.replace(tmp, path)
    return w


def nearest(w: np.ndarray, target: float, n: int) -> np.ndarray:
    """The ``n`` entries of ``w`` nearest ``target``, ascending."""
    w = np.asarray(w, dtype=np.float64)
    return np.sort(w[np.argsort(np.abs(w - target), kind="stable")[:n]])


def wanted(lam_ref: np.ndarray, target: float, n_target: int) -> np.ndarray:
    """The ``n_target`` eigenvalues nearest ``target``, from the lowest
    ``k`` of the reference. Every eigenvalue that near the target has to
    lie among those ``k``: the farthest of the ``n_target`` must lie below
    the largest of them."""
    want = nearest(lam_ref, target, n_target)
    reach = np.max(np.abs(want - target))
    if not target + reach < lam_ref[-1]:
        raise ValueError(
            f"the reference's {len(lam_ref)} lowest eigenvalues (up to "
            f"{lam_ref[-1]!r}) do not hold every eigenvalue within {reach!r}"
            f" of the target {target!r}: raise reference_k")
    return want


def judge_pairs(A, want: np.ndarray, theta: np.ndarray, X: np.ndarray,
                target: float) -> dict:
    """The three numbers of one solve's pairs ``(theta [m], X [D, m])``
    against the wanted eigenvalues ``want`` (``len(want) <= m``)."""
    theta = np.asarray(theta, dtype=np.float64)
    X = np.asarray(X)
    eig = np.abs(nearest(theta, target, len(want)) - want)
    norms = np.linalg.norm(X, axis=0)
    R = A @ X - X * theta[None, :]
    resid = np.linalg.norm(R, axis=0) / norms
    G = X.conj().T @ X - np.eye(X.shape[1])
    return dict(eig_err=float(np.max(eig)), resid=float(np.max(resid)),
                orth_err=float(np.max(np.abs(G))))


def judge(A, lam_ref: np.ndarray, solves: list, n_target: int,
          target: float) -> dict:
    """The worst of each number over ``solves`` (dicts with
    ``eigenvalues`` and ``eigenvectors``, or ``error``) and how many
    failed: raised, or returned fewer than ``n_target`` pairs, or numbers
    that are not finite. ``lam_ref`` holds the reference's lowest
    eigenvalues, ascending."""
    want = wanted(lam_ref, target, n_target)
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = 0
    for s in solves:
        if s.get("error") is not None or len(s["eigenvalues"]) < n_target:
            failed += 1
            continue
        nums = judge_pairs(A, want, s["eigenvalues"], s["eigenvectors"],
                           target)
        if not all(np.isfinite(v) for v in nums.values()):
            failed += 1
            continue
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
    return dict(worst, failed=failed)
