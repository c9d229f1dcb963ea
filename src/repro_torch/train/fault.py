"""Fault-tolerance control plane (port of ``repro.train.fault``): bounded
retry, heartbeat / straggler deadline, restart from a checkpoint.

  * ``run_with_restarts`` executes a step function; on an exception it
    restores the latest checkpoint and replays from there, up to
    ``max_failures`` times (then re-raises).
  * ``Heartbeat`` tracks per-step wall time; a step exceeding
    ``deadline_s`` is flagged as a straggler.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


@dataclasses.dataclass
class Heartbeat:
    deadline_s: float
    history: List[float] = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Record a step time; returns True if it was a straggler."""
        self.history.append(step_seconds)
        if step_seconds > self.deadline_s:
            self.stragglers += 1
            return True
        return False

    def adaptive_deadline(self, factor: float = 3.0, min_history: int = 8
                          ) -> float:
        """Deadline = factor x median of recent steps (self-tuning)."""
        if len(self.history) < min_history:
            return self.deadline_s
        recent = sorted(self.history[-64:])
        return factor * recent[len(recent) // 2]


@dataclasses.dataclass
class RestartStats:
    failures: int = 0
    restarts_from: List[int] = dataclasses.field(default_factory=list)


def run_with_restarts(
    *,
    init_state: Any,
    init_step: int,
    run_steps: Callable[[Any, int], Tuple[Any, int]],
    restore_fn: Callable[[], Tuple[Any, int]],
    max_failures: int = 3,
) -> Tuple[Any, int, RestartStats]:
    """Drive ``run_steps(state, step) -> (state, step)`` to completion.

    ``run_steps`` raising is treated as a node failure: the latest
    checkpoint is restored via ``restore_fn`` and execution resumes.  The
    exception is re-raised once ``max_failures`` is exhausted (fail-stop
    rather than silent data corruption).
    """
    stats = RestartStats()
    state, step = init_state, init_step
    while True:
        try:
            return (*run_steps(state, step), stats)
        except KeyboardInterrupt:
            raise
        except Exception:
            stats.failures += 1
            if stats.failures > max_failures:
                raise
            state, step = restore_fn()
            stats.restarts_from.append(step)
