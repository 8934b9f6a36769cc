"""Fault tolerance + straggler mitigation for the training loop
(``repro``'s ``distributed/fault_tolerance.py``):

- TrainSupervisor.run: step loop with periodic async checkpoints; any
  exception inside a step (injected in tests; device loss in production)
  triggers restore-from-latest-valid and continues, up to max_restarts.
- StragglerWatchdog: per-step deadline (EWMA of recent step times x slack);
  overruns are recorded and surfaced, and a callback may act on them.

The port's train step updates the state it is given in place, so the
supervisor keeps a host copy of ``init_state`` from before the first step:
a restart that finds no valid checkpoint starts again from those values
(written back into ``init_state``), not from whatever the steps left in
it.  (``repro``'s launcher donates ``init_state``'s buffers to its jitted
step, so there that restart fails; ROADMAP.md §3.)  Elastic restarts onto
another mesh (``state_shardings``) are ROADMAP.md §1 item 12.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import host_arrays, load_arrays
from repro_torch.not_ported import not_ported


@dataclass
class StragglerWatchdog:
    slack: float = 3.0
    ewma: float | None = None
    events: list = field(default_factory=list)
    on_straggler: object = None

    def observe(self, step: int, dt: float):
        if self.ewma is None:
            self.ewma = dt
            return
        deadline = self.ewma * self.slack
        if dt > deadline and step > 2:
            self.events.append({"step": step, "dt": dt, "deadline": deadline})
            if self.on_straggler is not None:
                self.on_straggler(step, dt, deadline)
        self.ewma = 0.9 * self.ewma + 0.1 * dt


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    restored_steps: list = field(default_factory=list)
    straggler_events: list = field(default_factory=list)


class TrainSupervisor:
    def __init__(self, ckpt_dir: str, ckpt_every: int = 50,
                 max_restarts: int = 3, watchdog_slack: float = 3.0):
        self.manager = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.watchdog = StragglerWatchdog(slack=watchdog_slack)

    def run(self, *, init_state, step_fn, n_steps: int,
            state_shardings=None, extra_from_state=None) -> tuple:
        """Run `n_steps` of `step_fn(state, step) -> state` with checkpoint/
        restart. Returns (final state, SupervisorReport)."""
        if state_shardings is not None:
            raise not_ported("mesh")
        report = SupervisorReport()
        report.straggler_events = self.watchdog.events
        initial = host_arrays(init_state)
        state = init_state
        step0, restored, extra = self.manager.restore(init_state)
        start = 0
        if restored is not None:
            state, start = restored, step0
            report.restored_steps.append(step0)

        step = start
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                state = step_fn(state, step)
                self.watchdog.observe(step, time.perf_counter() - t0)
                step += 1
                report.steps_run += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    extra = (extra_from_state(state)
                             if extra_from_state else {})
                    self.manager.save(step, state, extra=extra)
            except Exception:
                if report.restarts >= self.max_restarts:
                    raise
                report.restarts += 1
                self.manager.wait()
                step0, restored, _ = self.manager.restore(init_state)
                if restored is None:
                    state, step = load_arrays(initial, init_state), 0
                else:
                    state, step = restored, step0
                report.restored_steps.append(step)
        self.manager.wait()
        return state, report
