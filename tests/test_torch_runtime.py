"""The port's fault-tolerance runtime (``repro_torch/runtime``) on the CPU:
the counterparts of ``tests/test_runtime.py`` (the step timer, straggler
and dead-host detection, a supervisor restarting from its checkpoint,
giving up past ``max_restarts``), and the copied health bookkeeping held
to the reference's on the same step times."""
import time

import numpy as np
import pytest
import torch

from repro.runtime import HealthMonitor as RefHealthMonitor
from repro.runtime import StepTimer as RefStepTimer
from repro.runtime import StragglerWatchdog as RefWatchdog
from repro_torch.runtime import (HealthMonitor, StepTimer, StragglerWatchdog,
                                 Supervisor, SupervisorConfig)


def test_step_timer_ewma():
    t = StepTimer(alpha=0.5)
    for dt in (1.0, 1.0, 3.0):
        t.observe(dt)
    assert 1.0 < t.ewma < 3.0
    assert t.count == 3


def test_step_timer_start_stop():
    t = StepTimer()
    t.start()
    dt = t.stop()
    assert dt >= 0.0 and t.count == 1 and t.ewma == dt


def _fleet_times(n_hosts=8, n_steps=20, slow=5):
    return [(step, h, 1.0 + 0.01 * np.sin(h + step)
             + (2.0 if h == slow else 0.0))
            for step in range(n_steps) for h in range(n_hosts)]


def test_straggler_detection():
    hm = HealthMonitor(n_hosts=8, k_sigma=3.0)
    for _, h, dt in _fleet_times():
        hm.report(h, dt)
    assert hm.stragglers() == [5]
    fr = hm.rebalance_fractions()
    assert fr[5] == min(fr)  # the straggler gets the smallest share
    assert abs(sum(fr) - 1.0) < 1e-9


def test_dead_host_detection():
    hm = HealthMonitor(n_hosts=3, heartbeat_timeout=0.05)
    time.sleep(0.1)
    hm.report(0, 1.0)
    dead = hm.dead()
    assert 1 in dead and 2 in dead and 0 not in dead


@pytest.mark.parametrize("slow", [0, 3, 7])
def test_health_monitor_equals_the_reference(slow):
    """The copy gives the reference's EWMAs, stragglers and shares."""
    mine, ref = HealthMonitor(n_hosts=8), RefHealthMonitor(n_hosts=8)
    for _, h, dt in _fleet_times(slow=slow):
        mine.report(h, dt)
        ref.report(h, dt)
    assert [t.ewma for t in mine.timers.values()] == \
        [t.ewma for t in ref.timers.values()]
    assert mine.stragglers() == ref.stragglers() == [slow]
    assert mine.rebalance_fractions() == ref.rebalance_fractions()


@pytest.mark.parametrize("spike", [0.12, 0.5, 5.0])
def test_straggler_watchdog_equals_the_reference(spike):
    mine, ref = StragglerWatchdog(), RefWatchdog()
    steps = [0.1, 0.101, 0.099, 0.1, 0.1, spike, 0.1, 0.1]
    got = [mine.observe(i, dt) for i, dt in enumerate(steps)]
    want = [ref.observe(i, dt) for i, dt in enumerate(steps)]
    assert got == want and mine.flagged == ref.flagged
    t, r = StepTimer(alpha=0.3), RefStepTimer(alpha=0.3)
    for dt in steps:
        t.observe(dt)
        r.observe(dt)
    assert (t.ewma, t.std, t.count) == (r.ewma, r.std, r.count)


def test_straggler_watchdog_flags_spike():
    wd = StragglerWatchdog(k_sigma=3.0, warmup=3, min_slack=1e-3)
    assert not any(wd.observe(i, 0.1) for i in range(8))
    assert wd.observe(8, 0.5)  # 5x spike after a steady baseline
    assert wd.flagged and wd.flagged[-1][0] == 8


def _init_state():
    return {"x": torch.zeros((), dtype=torch.float64),
            "hist": torch.zeros(20, dtype=torch.float64)}


def _step_fn(state, step):
    hist = state["hist"].clone()
    hist[step] = step
    return {"x": state["x"] + step, "hist": hist}


@pytest.mark.parametrize("fault_at,interval", [(7, 3), (1, 3), (11, 5)])
def test_supervisor_restart_from_checkpoint(tmp_path, fault_at, interval):
    """A fault injected at one step: the run restarts from the last
    committed checkpoint and ends in the clean run's state."""
    faults = {"armed": True}

    def fault_hook(step):
        if step == fault_at and faults["armed"]:
            faults["armed"] = False
            raise RuntimeError("simulated node failure")

    sup = Supervisor(str(tmp_path), SupervisorConfig(
        checkpoint_interval=interval, max_restarts=2))
    state, step = sup.run(init_state=_init_state, step_fn=_step_fn,
                          n_steps=12, fault_hook=fault_hook)
    assert step == 12 and sup.restarts == 1
    clean = _init_state()
    for i in range(12):
        clean = _step_fn(clean, i)
    assert torch.equal(state["hist"], clean["hist"])
    assert float(state["x"]) == float(clean["x"])


def test_supervisor_resumes_a_finished_run(tmp_path):
    sup = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=1))
    sup.run(init_state=_init_state, step_fn=_step_fn, n_steps=6)
    again = Supervisor(str(tmp_path), SupervisorConfig(checkpoint_interval=1))
    state, step = again.run(init_state=_init_state, step_fn=_step_fn,
                            n_steps=6, device="cpu")
    assert step == 6 and again.restarts == 0
    assert float(state["x"]) == sum(range(6))


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, step):
        raise RuntimeError("always broken")

    sup = Supervisor(str(tmp_path), SupervisorConfig(max_restarts=2))
    with pytest.raises(RuntimeError, match="always broken"):
        sup.run(init_state=_init_state, step_fn=step_fn, n_steps=3)
    assert sup.restarts == 3
