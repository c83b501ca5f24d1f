"""Step-time health tracking and straggler detection.

On a real multi-host deployment each host runs a StepTimer and publishes
its per-step wall time; the HealthMonitor (rank 0 or an external
controller) flags hosts whose EWMA step time exceeds k standard
deviations of the fleet — the straggler remedy ladder is:

  1. log + alert,
  2. re-balance: for the eigensolver, re-partition matrix rows by
     communication volume (the paper's own χ₂-vs-χ₃ imbalance fix);
     for LM training, shrink the straggler's microbatch share,
  3. evict + elastic restart from the last committed checkpoint
     (checkpoint/ restores onto the shrunken grid of shards).

This module is pure bookkeeping (no torch, no device) so it is trivially
testable and can run in the controller process. It is the port's own
copy of ``repro/runtime/health.py``, line for line; the tests hold the
two to the same answers.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StepTimer:
    alpha: float = 0.1  # EWMA factor
    ewma: float | None = None
    var: float = 0.0
    count: int = 0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(dt)
        return dt

    def observe(self, dt: float):
        if self.ewma is None:
            self.ewma = dt
        else:
            d = dt - self.ewma
            self.ewma += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1

    @property
    def std(self) -> float:
        return self.var ** 0.5


@dataclasses.dataclass
class StragglerWatchdog:
    """Single-job straggler hook: flags a step whose wall time exceeds the
    job's own EWMA by ``k_sigma`` standard deviations.

    The fleet-level :class:`HealthMonitor` compares hosts against each
    other; a supervised eigensolve job has one step stream, so the
    reference is its own history (after ``warmup`` observations). The
    supervisor (``Supervisor.run_job``) calls :meth:`observe` per
    iteration and invokes its ``on_straggler`` remedy callback when the
    step is flagged — step 1 of the remedy ladder above; steps 2/3
    (commvol re-partition, elastic restart from the last committed
    checkpoint) are what the plan cache and ``checkpoint/`` provide.
    """

    k_sigma: float = 3.0
    warmup: int = 3
    min_slack: float = 1e-3  # absolute floor [s] — jitter is not a straggler
    timer: StepTimer = dataclasses.field(default_factory=StepTimer)
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = (self.timer.count >= self.warmup
                and self.timer.ewma is not None
                and dt > self.timer.ewma
                + max(self.k_sigma * self.timer.std, self.min_slack))
        self.timer.observe(dt)
        if slow:
            self.flagged.append((step, dt))
        return slow


class HealthMonitor:
    """Fleet-level view: flags stragglers and dead hosts."""

    def __init__(self, n_hosts: int, k_sigma: float = 3.0,
                 heartbeat_timeout: float = 60.0):
        self.n_hosts = n_hosts
        self.k_sigma = k_sigma
        self.heartbeat_timeout = heartbeat_timeout
        self.timers = {h: StepTimer() for h in range(n_hosts)}
        self.last_seen = {h: time.monotonic() for h in range(n_hosts)}

    def report(self, host: int, step_time: float):
        self.timers[host].observe(step_time)
        self.last_seen[host] = time.monotonic()

    def stragglers(self) -> list[int]:
        ew = [t.ewma for t in self.timers.values() if t.ewma is not None]
        if len(ew) < max(2, self.n_hosts // 2):
            return []
        med = sorted(ew)[len(ew) // 2]
        spread = max(1e-9, 1.4826 * sorted(abs(e - med) for e in ew)[len(ew) // 2])
        out = []
        for h, t in self.timers.items():
            if t.ewma is not None and t.ewma > med + self.k_sigma * spread:
                out.append(h)
        return out

    def dead(self) -> list[int]:
        now = time.monotonic()
        return [h for h, ts in self.last_seen.items()
                if now - ts > self.heartbeat_timeout]

    def rebalance_fractions(self) -> list[float]:
        """Microbatch share per host inversely proportional to step time."""
        ew = [self.timers[h].ewma or 1.0 for h in range(self.n_hosts)]
        inv = [1.0 / e for e in ew]
        s = sum(inv)
        return [x / s for x in inv]
