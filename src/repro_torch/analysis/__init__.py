"""Static communication checks of the port (``python -m
repro_torch.analysis.check_comm``; the counterpart of ``repro/analysis``
and ``scripts/check_comm.py``).

* :mod:`.plan_lint` — pattern-only invariants of the neighbour
  schedules, row maps and :class:`~repro_torch.core.planner.SpmvCommPlan`
  byte accounting (nothing runs on a device);
* :mod:`.overlap_check` — the split-phase and round-pipeline proofs over
  the ordered record (:class:`~repro_torch.core.shards.CommTrace`) of one
  engine call;
* :mod:`.census` — one FD macro-iteration run with the record on, every
  collective attributed to a predicted term of the comm plan;
  unattributed or missing collectives are errors.
"""
from ..core.shards import CommEntry, CommTrace  # noqa: F401
from .census import (CensusReport, ExpectedTerm, attribute,  # noqa: F401
                     census_of, expected_census, extra_psum, measured,
                     run_census_cell, skip_gram)
from .overlap_check import (OverlapReport, PipelineReport,  # noqa: F401
                            check_round_pipeline, check_split_phase,
                            dropped_wait, late_start)
from .plan_lint import (lint_comm_plan, lint_dist_ell,  # noqa: F401
                        lint_rounds, lint_rowmap, lint_sampled_plan,
                        lint_schedules, lint_sstep, run_plan_lint)

__all__ = [
    "CensusReport", "ExpectedTerm", "attribute", "expected_census",
    "run_census_cell", "census_of", "measured", "extra_psum", "skip_gram",
    "OverlapReport", "PipelineReport", "check_split_phase",
    "check_round_pipeline", "late_start", "dropped_wait", "lint_comm_plan",
    "lint_dist_ell", "lint_rounds", "lint_rowmap", "lint_schedules",
    "lint_sstep", "lint_sampled_plan", "run_plan_lint", "CommTrace",
    "CommEntry",
]
