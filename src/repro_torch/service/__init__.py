"""Eigensolve as a service: plan cache, request batching, resumable jobs
(the port's counterpart of ``repro.service``).

The paper's vertical layer, bundles of search vectors over column
groups, is a request-batching dimension: columns stay independent through
every SpMV and filter step, so the search vectors of different
filter-diagonalization requests can share one panel. This package turns
the one-shot :class:`~repro_torch.core.filter_diag.FilterDiag` solver into
a schedulable, cacheable, resumable service:

* ``plan_cache``: persistent χ-planner results keyed by ``(pattern_hash,
  P, machine fingerprint)``; a repeat matrix skips ``plan_layout`` and
  runs the same engine plan;
* ``jobs``: resumable FilterDiag jobs, the :class:`FDState` checkpointed
  at iteration boundaries and driven by the runtime supervisor;
* ``batcher``: a request queue and a batcher that packs compatible
  requests into one panel as extra columns, each request's result
  bit-identical to serving it alone.
"""
from .plan_cache import (CACHE_VERSION, PlanCache, cache_key,
                         cached_plan_layout, machine_fingerprint,
                         pattern_hash, plan_from_json, plan_to_json)
from .jobs import FilterDiagJob, pack_state, unpack_state
from .batcher import BatchedJob, EigenService, SolveRequest, request_compat_key

__all__ = [
    "CACHE_VERSION", "PlanCache", "cache_key", "cached_plan_layout",
    "machine_fingerprint", "pattern_hash", "plan_from_json", "plan_to_json",
    "FilterDiagJob", "pack_state", "unpack_state",
    "BatchedJob", "EigenService", "SolveRequest", "request_compat_key",
]
