"""Supervisor: crash/restart orchestration from committed checkpoints (the
port's counterpart of ``repro/runtime/supervisor.py``).

Run a step loop, catch failures (injected or real), restore from the last
committed checkpoint, possibly onto another grid of shards, and continue.
:meth:`Supervisor.run` drives a plain ``step_fn`` loop;
:meth:`Supervisor.run_job` drives a resumable job (``service/jobs.py``,
``service/batcher.py``), restoring each leaf onto the job's device.

On ranks (one process per shard; ``link`` the launch's ``RankLink``) the
checkpoints are written by the first rank behind a barrier
(``checkpoint/``), and :meth:`Supervisor.run_job` restarts from a failure
that every rank raises at the same iteration boundary: before it
restores, every rank checks with the others (``job.agree``) that all are
at the same step. A failure on one rank alone is not recovered: the
others are blocked in a collective, and the launch ends there.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

from ..checkpoint import CheckpointManager, restore
from .health import StepTimer, StragglerWatchdog

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    checkpoint_interval: int = 50
    keep_checkpoints: int = 3


class Supervisor:
    """``restarts`` counts the failures recovered from (over every run)."""

    def __init__(self, ckpt_dir: str,
                 cfg: SupervisorConfig = SupervisorConfig(), link=None):
        self.cfg = cfg
        self.manager = CheckpointManager(
            ckpt_dir, interval=cfg.checkpoint_interval,
            keep=cfg.keep_checkpoints, link=link)
        self.timer = StepTimer()
        self.restarts = 0

    def _failed(self, what: str, e: Exception) -> None:
        """Count a failure; re-raise it past ``max_restarts``."""
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise e
        log.warning("%s failed (%s); restarting (%d/%d)", what, e,
                    self.restarts, self.cfg.max_restarts)

    def run(self, *, init_state: Callable, step_fn: Callable, n_steps: int,
            state_specs=None, fault_hook: Callable | None = None,
            device=None):
        """Run ``n_steps`` of ``step_fn(state, step) -> state`` with
        checkpoint/restart. ``init_state()`` builds a fresh state (a dict
        of tensors); ``fault_hook(step)`` may raise to inject a failure.
        Restored leaves go to ``device`` (default: the fresh state's
        leaves' devices). Returns ``(state, step)``."""
        try:
            state, start, _ = restore(self.manager.directory, init_state(),
                                      device=device)
            log.info("restored checkpoint at step %d", start)
            start += 1
        except FileNotFoundError:
            state, start = init_state(), 0
        step = start
        while step < n_steps:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                self.timer.start()
                state = step_fn(state, step)
                self.timer.stop()
                self.manager.maybe_save(step, state, specs=state_specs,
                                        extra={"pipeline_index": step})
                step += 1
            except Exception as e:  # noqa: BLE001 — restart on any fault
                self._failed(f"step {step}", e)
                try:
                    state, last, _ = restore(self.manager.directory,
                                             init_state(), device=device)
                    step = last + 1
                except FileNotFoundError:
                    state, step = init_state(), 0
        return state, step

    def run_job(self, job, *, fault_hook: Callable | None = None,
                watchdog: StragglerWatchdog | None = None,
                on_straggler: Callable | None = None):
        """Drive a resumable job (``template / init / step / done /
        step_index / pack / unpack``, and its ``device``, ``grid`` and
        ``specs``) to completion with checkpoint/restart.

        The job owns its split of the state into tensor leaves and a JSON
        extra (``pack``/``unpack``) and its own termination (``done``),
        so a solve that converges early stops early. ``fault_hook(step)``
        may raise to inject a failure; the loop then restores the last
        committed checkpoint onto ``job.device`` (an uncommitted step is
        ignored, the previous one restored) or starts over from
        ``job.init()``. A :class:`StragglerWatchdog`, when given,
        observes every step and calls ``on_straggler(step, dt)`` on a
        flagged one. A job packs its state only at the steps the manager
        saves. On ranks, ``job.agree(step)`` (a job's check that every
        rank holds the same values) runs before every restore after a
        failure."""
        def _restore():
            tree, _, extra = restore(self.manager.directory, job.template(),
                                     device=getattr(job, "device", None))
            return job.unpack(tree, extra)

        try:
            state = _restore()
            log.info("resumed job at step %d", job.step_index(state))
        except FileNotFoundError:
            state = job.init()
        agree = getattr(job, "agree", None)
        while not job.done(state):
            at = job.step_index(state)
            try:
                if fault_hook is not None:
                    fault_hook(at)
                self.timer.start()
                state = job.step(state)
                dt = self.timer.stop()
                if watchdog is not None and watchdog.observe(
                        job.step_index(state), dt):
                    log.warning("straggling step %d (%.3fs, ewma %.3fs)",
                                job.step_index(state), dt,
                                watchdog.timer.ewma)
                    if on_straggler is not None:
                        on_straggler(job.step_index(state), dt)
                if self.manager.due(job.step_index(state)):
                    tree, extra = job.pack(state)
                    self.manager.maybe_save(
                        job.step_index(state), tree,
                        specs=getattr(job, "specs", None), extra=extra,
                        grid=getattr(job, "grid", None))
            except Exception as e:  # noqa: BLE001 — restart on any fault
                self._failed("job step", e)
                if agree is not None:
                    agree(at)
                try:
                    state = _restore()
                except FileNotFoundError:
                    state = job.init()
        return state
