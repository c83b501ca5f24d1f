"""Persistent plan cache: χ-planner results keyed by the sparsity pattern
(the port's copy of ``repro/service/plan_cache.py``; the same keys, the
same JSON, so a store written by one package reads in the other).

``plan_layout`` scales with the pattern pass (0.8–1.3 s a plan for the
smoke's 48,000-row graphs and Hubbard(12,6), ``PERF.md``) — waste when
the same matrix family and size is solved repeatedly, as a service does.
This module serializes :class:`~repro_torch.core.planner.Plan`
(candidates, engine axes, and the planned
:class:`~repro_torch.core.partition.RowMap`) losslessly to a
merge-on-write JSON store: a single versioned JSON object, fully
validated before every merge, atomically replaced on write.

Cache key design (the service's multi-tenant contract):

  * ``pattern_hash`` — SHA-256 of the canonical (sorted, deduplicated)
    CSR pattern from ``partition._pattern_csr``. Sorting makes the hash
    invariant under ELL slot-order permutation of the same matrix (the
    planner's inputs are pattern-only, so so is the key); D is folded in,
    making different sizes/families distinct.
  * ``P`` (device count) and the **machine-model fingerprint** (name +
    the exact b_m/b_c/κ/α constants) — a re-calibrated machine must not
    hit stale plans.
  * every remaining ``plan_layout`` argument that shapes the result
    (n_search, degree, d_pad, axis tuples, splits) is folded into a
    params digest, and :data:`CACHE_VERSION` is part of the key — bump it
    on ANY planner-axis change (new engine axis, changed ranking key) so
    old stores are ignored wholesale rather than misapplied.

A cache hit skips ``plan_layout`` entirely (the service asserts this via
a call counter) while selecting the byte-identical engine plan: the
round-trip is lossless, including the RowMap the candidate was scored
on, so ``comm_plan`` recomputed from the cached candidate reproduces the
original ``comm_bytes_per_device`` exactly.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
from typing import Any

import numpy as np

from ..core import partition, planner
from ..core import perf_model as pm
from ..core.partition import RowMap
from ..core.planner import Candidate, Plan

__all__ = ["SCHEMA", "CACHE_VERSION", "pattern_hash", "machine_fingerprint",
           "cache_key", "plan_to_json", "plan_from_json", "validate_store",
           "PlanCache", "cached_plan_layout"]

SCHEMA = "plan-cache/v1"

#: Bump on ANY planner-axis change (new engine axis, changed ranking
#: key, changed Candidate fields): the version is part of every cache
#: key, so stale entries miss instead of misapplying. The current value
#: corresponds to the seven-axis grid (layout x overlap x comm x
#: schedule x partition x kernel x s-step).
CACHE_VERSION = 1


# ---------------------------------------------------------------- keys --

#: D above which ``pattern_hash`` probes generator families instead of
#: materializing the canonical CSR (matches the streaming planner's
#: regime: a 10^7-row matrix-free instance must key the cache without a
#: full pattern pass). CSR inputs always hash the full pattern.
PATTERN_HASH_PROBE_D = 2_000_000
_PATTERN_PROBE_ROWS = 4096


def pattern_hash(matrix) -> str:
    """SHA-256 of the canonical sparsity pattern (sorted, deduplicated
    CSR) — invariant under ELL slot-order permutation of the same
    matrix, distinct across families and sizes.

    Generator families past :data:`PATTERN_HASH_PROBE_D` rows are hashed
    from a deterministic evenly-spaced row probe of ``row_cols`` instead
    (sorted per probe row, so the same slot-order invariance holds on
    the probed subset): materializing the canonical CSR is exactly the
    O(nnz) pass the sampled planner exists to avoid. The probe keys on D
    plus the probed rows' exact column sets — distinct seeds/params of
    the same family produce distinct column sets on 4096 spread rows."""
    h = hashlib.sha256()
    D = int(matrix.D) if hasattr(matrix, "D") else int(matrix.shape[0])
    if hasattr(matrix, "row_cols") and D > PATTERN_HASH_PROBE_D:
        rows = np.unique(np.linspace(0, D - 1,
                                     _PATTERN_PROBE_ROWS).astype(np.int64))
        r, c = matrix.row_cols(rows)
        order = np.lexsort((c, r))
        h.update(b"pattern-probe/v1:")
        h.update(np.int64(D).tobytes())
        h.update(np.ascontiguousarray(r[order], dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(c[order], dtype=np.int64).tobytes())
        return h.hexdigest()
    indptr, cols = partition._pattern_csr(matrix)
    h.update(b"pattern/v1:")
    h.update(np.int64(len(indptr) - 1).tobytes())
    h.update(np.ascontiguousarray(indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(cols, dtype=np.int64).tobytes())
    return h.hexdigest()


def machine_fingerprint(machine: pm.MachineModel) -> str:
    """Name + exact model constants: a re-fit machine misses old plans."""
    return (f"{machine.name}:bm={machine.b_m!r}:bc={machine.b_c!r}"
            f":k={machine.kappa!r}:a={machine.alpha!r}")


def _params_digest(params: dict) -> str:
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def cache_key(phash: str, n_devices: int, machine: pm.MachineModel,
              **params: Any) -> str:
    """Store key ``(pattern_hash, P, machine fingerprint)`` plus a digest
    of every other plan-shaping argument and the cache version."""
    return (f"{phash}/P{n_devices}/{machine_fingerprint(machine)}"
            f"/{_params_digest(params)}/v{CACHE_VERSION}")


# ------------------------------------------------------- serialization --

def _rowmap_to_json(rm: RowMap | None):
    if rm is None:
        return None
    identity_perm = bool(np.array_equal(
        rm.perm, np.arange(rm.D, dtype=np.int64)))
    return {
        "D": int(rm.D), "P": int(rm.P), "R": int(rm.R),
        "balance": rm.balance, "reorder": rm.reorder,
        "sstep": int(rm.sstep),
        # identity permutations (balance-only maps) compress to null
        "perm": None if identity_perm else [int(x) for x in rm.perm],
        "boundaries": [int(x) for x in rm.boundaries],
    }


def _rowmap_from_json(j) -> RowMap | None:
    if j is None:
        return None
    D = int(j["D"])
    perm = (np.arange(D, dtype=np.int64) if j["perm"] is None
            else np.asarray(j["perm"], dtype=np.int64))
    return RowMap(D=D, P=int(j["P"]), balance=j["balance"],
                  reorder=j["reorder"], perm=perm,
                  boundaries=np.asarray(j["boundaries"], dtype=np.int64),
                  R=int(j["R"]), sstep=int(j["sstep"]))


_CANDIDATE_SCALARS = ("layout", "n_row", "n_col", "overlap", "comm",
                      "schedule", "redistribute", "chi1", "chi2", "chi_eng",
                      "t_iter", "t_redist", "t_pass",
                      "comm_bytes_per_device", "balance", "reorder",
                      "kernel", "sstep")


def _candidate_to_json(c: Candidate) -> dict:
    out = {k: getattr(c, k) for k in _CANDIDATE_SCALARS}
    out["rowmap"] = _rowmap_to_json(c.rowmap)
    return out


def _candidate_from_json(j: dict) -> Candidate:
    kw = {k: j[k] for k in _CANDIDATE_SCALARS}
    for k in ("n_row", "n_col", "comm_bytes_per_device", "sstep"):
        kw[k] = int(kw[k])
    for k in ("chi1", "chi2", "chi_eng", "t_iter", "t_redist", "t_pass"):
        kw[k] = float(kw[k])
    return Candidate(rowmap=_rowmap_from_json(j.get("rowmap")), **kw)


def plan_to_json(plan: Plan) -> dict:
    """Lossless JSON form of a Plan (floats round-trip exactly via repr)."""
    return {
        "matrix": plan.matrix, "D": int(plan.D),
        "n_devices": int(plan.n_devices), "n_search": int(plan.n_search),
        "degree": int(plan.degree), "machine": plan.machine,
        "candidates": [_candidate_to_json(c) for c in plan.candidates],
    }


def plan_from_json(j: dict) -> Plan:
    return Plan(matrix=j["matrix"], D=int(j["D"]),
                n_devices=int(j["n_devices"]), n_search=int(j["n_search"]),
                degree=int(j["degree"]), machine=j["machine"],
                candidates=tuple(_candidate_from_json(c)
                                 for c in j["candidates"]))


# ----------------------------------------------------------- the store --

def validate_store(store) -> list[str]:
    """All schema errors of a plan-cache store object (empty = valid): a
    malformed entry merged once would otherwise survive forever."""
    if not isinstance(store, dict):
        return ["store is not a JSON object"]
    errors: list[str] = []
    if store.get("schema") != SCHEMA:
        errors.append(f"schema is {store.get('schema')!r}, "
                      f"expected {SCHEMA!r}")
    entries = store.get("entries")
    if not isinstance(entries, dict):
        return errors + ["'entries' missing or not an object"]
    for key, ent in entries.items():
        where = f"entries[{key[:32]}…]" if len(key) > 32 else f"entries[{key}]"
        if not isinstance(ent, dict) or "plan" not in ent:
            errors.append(f"{where}: missing 'plan'")
            continue
        pj = ent["plan"]
        if not isinstance(pj, dict):
            errors.append(f"{where}: 'plan' not an object")
            continue
        for field in ("matrix", "D", "n_devices", "n_search", "degree",
                      "machine", "candidates"):
            if field not in pj:
                errors.append(f"{where}: plan missing {field!r}")
        cands = pj.get("candidates")
        if not isinstance(cands, list) or not cands:
            errors.append(f"{where}: plan has no candidates")
            continue
        for i, cj in enumerate(cands):
            missing = [k for k in _CANDIDATE_SCALARS
                       if not isinstance(cj, dict) or k not in cj]
            if missing:
                errors.append(f"{where}: candidates[{i}] missing {missing}")
    return errors


class PlanCache:
    """Merge-on-write JSON store of serialized plans.

    ``get``/``put`` count ``hits``/``misses``/``plan_calls`` so the
    service (and the acceptance test) can assert the hit path never
    invoked the planner. A corrupt store never crashes a solve: ``get``
    treats it as empty; ``put`` refuses to merge into it (explicit
    ``ValueError`` listing the schema errors) so corruption cannot
    propagate.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.hits = 0
        self.misses = 0
        self.plan_calls = 0

    # -- store I/O ------------------------------------------------------
    def _load(self) -> dict | None:
        """The validated store object, or None when absent/corrupt."""
        try:
            with open(self.path) as f:
                store = json.load(f)
        except (OSError, ValueError):
            return None
        return store if not validate_store(store) else None

    def get(self, key: str) -> Plan | None:
        store = self._load()
        ent = (store or {}).get("entries", {}).get(key)
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        return plan_from_json(ent["plan"])

    def put(self, key: str, plan: Plan):
        """Merge ``key -> plan`` into the store and atomically rewrite.

        Existing entries are kept (merge-on-write); the merged store is
        fully re-validated before the write, and an existing-but-invalid
        store is refused rather than silently clobbered.

        Concurrent writers are safe: the read-merge-validate-write cycle
        runs under an exclusive ``flock`` on a ``.lock`` sidecar (held by
        every ``put``, so two processes cannot interleave their reads and
        drop each other's entries), the temp file is per-PID (two writers
        never scribble on one buffer), and the final ``os.replace`` keeps
        readers crash-consistent — a reader never observes a torn store,
        locked or not.
        """
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                store: dict
                if os.path.exists(self.path):
                    try:
                        with open(self.path) as f:
                            store = json.load(f)
                    except ValueError as e:
                        raise ValueError(
                            f"{self.path}: existing store is not valid "
                            f"JSON ({e}); refusing to merge") from e
                    errors = validate_store(store)
                    if errors:
                        raise ValueError(
                            f"{self.path}: existing store is invalid, "
                            f"refusing to merge: {errors}")
                else:
                    store = {"schema": SCHEMA, "entries": {}}
                store["entries"][key] = {"plan": plan_to_json(plan)}
                errors = validate_store(store)
                if errors:
                    raise ValueError(
                        f"refusing to write invalid store: {errors}")
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(store, f)
                os.replace(tmp, self.path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)


def cached_plan_layout(matrix, n_devices: int, *, n_search: int,
                       cache: PlanCache | None = None,
                       machine: pm.MachineModel = pm.H100_1CARD,
                       degree: int | None = None, ranks: bool = False,
                       device=None, **kwargs) -> tuple[Plan, bool]:
    """``plan_layout`` behind the cache: returns ``(plan, hit)``.

    On a miss the fresh plan is stored under the full key (pattern hash,
    P, machine fingerprint, params digest, cache version); on a hit
    ``plan_layout`` is never called — ``cache.plan_calls`` counts the
    planner invocations this wrapper made. ``kwargs`` are forwarded to
    ``plan_layout`` verbatim and folded into the key.

    With ``ranks`` (every rank of a started process group calls it) rank
    0 alone hashes the pattern, reads and writes the store and plans; its
    ``(plan, hit)`` goes to every rank in one broadcast (``device``: this
    rank's, where nccl stages it). The other ranks' ``cache`` is not
    touched.
    """
    if ranks:
        from ..core.ranks import broadcast_object, is_lead

        got = (cached_plan_layout(matrix, n_devices, n_search=n_search,
                                  cache=cache, machine=machine,
                                  degree=degree, **kwargs)
               if is_lead() else None)
        return broadcast_object(got, device)
    degree = degree if degree is not None else planner.DEFAULT_PLAN_DEGREE
    if cache is None:
        plan = planner.plan_layout(matrix, n_devices, n_search=n_search,
                                   degree=degree, machine=machine, **kwargs)
        return plan, False
    key = cache_key(pattern_hash(matrix), n_devices, machine,
                    n_search=n_search, degree=degree, **kwargs)
    plan = cache.get(key)
    if plan is not None:
        return plan, True
    cache.plan_calls += 1
    plan = planner.plan_layout(matrix, n_devices, n_search=n_search,
                               degree=degree, machine=machine, **kwargs)
    cache.put(key, plan)
    return plan, False
