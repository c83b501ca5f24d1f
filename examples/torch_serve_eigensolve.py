"""Eigensolve-as-a-service on the PyTorch port: batched multi-tenant filter
diagonalization.

Three tenants request eigenpairs of the same spin chain at different
spectral targets. The service plans the operator once (persisting the
plan to a JSON cache — rerun with the same ``--work`` directory and watch
the planner be skipped), batches the three requests into ONE block of
search vectors (the paper's vertical layer as a request-batching
dimension: extra vector columns, zero extra halo exchanges), checkpoints
the batched solve, and demuxes per-request results bit-identically to
solo solves.

    PYTHONPATH=src python examples/torch_serve_eigensolve.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.service import EigenService, PlanCache, SolveRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work", default=None,
                    help="directory of the plan cache and checkpoints "
                         "(default: a new temporary one)")
    args = ap.parse_args(argv)
    work = args.work or tempfile.mkdtemp(prefix="eigenservice_")
    cache = PlanCache(os.path.join(work, "plans.json"))
    svc = EigenService(plan_cache=cache, device=args.device,
                       ckpt_root=os.path.join(work, "ckpt"))

    spin = dict(family="SpinChainXXZ", params=dict(n_sites=10, n_up=5))
    svc.submit(SolveRequest("tenant-a", **spin, n_target=4, n_search=16,
                            target=-3.0, tol=1e-9, seed=11))
    svc.submit(SolveRequest("tenant-b", **spin, n_target=4, n_search=16,
                            target=0.0, tol=1e-9, seed=22))
    svc.submit(SolveRequest("tenant-c", **spin, n_target=4, n_search=16,
                            target=1.5, tol=1e-9, seed=33))

    results = svc.drain()
    print(f"plan cache: hits={cache.hits} misses={cache.misses} "
          f"planner calls={cache.plan_calls}  ({cache.path})")
    for rid in sorted(results):
        r = results[rid]
        print(f"[{rid}] {r.n_converged} converged in {r.iterations} "
              f"iterations / {r.total_spmvs} SpMVs: "
              f"{np.array2string(np.sort(r.eigenvalues), precision=8)}")

    # solo re-solve of tenant-a demuxes to the exact batched values
    solo = EigenService(plan_cache=cache, device=args.device)
    solo.submit(SolveRequest("tenant-a", **spin, n_target=4, n_search=16,
                             target=-3.0, tol=1e-9, seed=11))
    r_solo = solo.drain()["tenant-a"]
    same = np.array_equal(r_solo.eigenvalues, results["tenant-a"].eigenvalues)
    print(f"solo == batched (bit-identical demux): {same}; "
          f"cache hits now {cache.hits} (planner never re-ran)")
    assert same, "a batched request must equal its solo solve bit for bit"


if __name__ == "__main__":
    main()
