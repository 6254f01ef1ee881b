"""Straggler mitigation + failure handling for thousand-node runs.

Port of the JAX package's ``training/stragglers.py`` (a copy: the logic
is host Python). On a real multi-node deployment each host runs this
monitor around its train loop:

- step-time EMA with outlier detection (a straggling host shows up as a
  slow all-reduce for EVERYBODY; the monitor attributes blame via the
  pre-collective barrier time so the orchestrator can evict the slow host),
- a heartbeat file that the cluster orchestrator watches (missed
  heartbeats => reschedule the job from the last checkpoint),
- graceful-degradation hook: on SIGTERM (preemption notice) an emergency
  checkpoint is requested before the process dies.

The monitor times the host's wall clock. CUDA launches return before the
card finishes, so, like the reference under JAX's async dispatch, it
sees the time to launch a step unless the step synchronises (the train
step reads nothing back); it adds no synchronisation of its own. Tests
drive it with injected timings; the logic is host-count agnostic.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import List, Optional


@dataclasses.dataclass
class StragglerConfig:
    ema_alpha: float = 0.1
    outlier_factor: float = 2.0     # step > factor * EMA  => straggler event
    trip_threshold: int = 3         # consecutive events before flagging
    heartbeat_path: Optional[str] = None
    heartbeat_every: int = 10       # steps


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.consecutive = 0
        self.events: List[dict] = []
        self._last = None
        self._steps = 0

    def start_step(self):
        self._last = time.perf_counter()

    def end_step(self, step: int, duration: Optional[float] = None) -> bool:
        """Record a step; returns True if this host is flagged a straggler."""
        if duration is None:
            duration = time.perf_counter() - self._last
        flagged = False
        if self.ema is None:
            self.ema = duration
        else:
            if duration > self.cfg.outlier_factor * self.ema:
                self.consecutive += 1
                self.events.append({"step": step, "duration": duration,
                                    "ema": self.ema})
                if self.consecutive >= self.cfg.trip_threshold:
                    flagged = True
            else:
                self.consecutive = 0
            self.ema = (1 - self.cfg.ema_alpha) * self.ema \
                + self.cfg.ema_alpha * duration
        self._steps += 1
        if (self.cfg.heartbeat_path
                and self._steps % self.cfg.heartbeat_every == 0):
            with open(self.cfg.heartbeat_path, "w") as f:
                f.write(f"{step} {time.time()}\n")
        return flagged


class PreemptionHandler:
    """SIGTERM -> request emergency checkpoint at the next step boundary.
    ``install`` works in the main thread only (``signal.signal``)."""

    def __init__(self):
        self.requested = False
        self._orig = None

    def install(self):
        self._orig = signal.signal(signal.SIGTERM, self._on_term)
        return self

    def _on_term(self, signum, frame):
        self.requested = True

    def uninstall(self):
        if self._orig is not None:
            signal.signal(signal.SIGTERM, self._orig)
