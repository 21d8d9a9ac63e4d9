"""Fault-tolerance runtime: preemption handling, heartbeat, stragglers.

A copy of the JAX package's ``training/fault_tolerance.py`` (pure-Python
control plane, no device state). Fault tolerance is (a) always-resumable
checkpoints (``checkpoint.py``), (b) a preemption handler that forces a
final checkpoint inside the grace window, (c) a heartbeat/straggler
monitor that flags slow hosts so the scheduler can evict and resume on
fewer devices (checkpoints hold whole leaves, so N-1 resume is a
restore, not a rescue). Unit-tested with a fake clock in
``tests/test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict


class PreemptionHandler:
    """SIGTERM-driven graceful shutdown: flip a flag, let the train loop
    checkpoint and exit cleanly within the preemption grace period."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._installed = False

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def _on_signal(self, signum, frame):
        self._requested = True

    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:   # for tests / manual drain
        self._requested = True

    def agreed(self, mesh) -> bool:
        """Whether any rank of ``mesh`` was asked to stop (``Mesh.
        agree_max``, one collective every rank calls at the same point
        of a step): the ranks checkpoint and stop together, since a rank
        that checkpointed alone would pair its gathers with the others'
        next step."""
        return mesh.agree_max(float(self._requested)) > 0


@dataclasses.dataclass
class HostHealth:
    last_beat: float
    step_time_ewma: float
    steps: int


class StragglerMonitor:
    """Per-host step-time EWMA; a host is a straggler when its EWMA exceeds
    ``threshold`` × the fleet median. At 1000+ nodes this is the signal for
    hot-spare swap-in / slow-host eviction (the training driver beats
    ``host{rank}`` on every rank of a mesh); in-process it throttles the
    reporting hook so the job can choose to checkpoint + downscale.
    """

    def __init__(self, ewma: float = 0.9, threshold: float = 1.5,
                 clock: Callable[[], float] = time.monotonic):
        self.ewma = ewma
        self.threshold = threshold
        self.clock = clock
        self.hosts: Dict[str, HostHealth] = {}

    def beat(self, host: str, step_time: float) -> None:
        now = self.clock()
        h = self.hosts.get(host)
        if h is None:
            self.hosts[host] = HostHealth(now, step_time, 1)
        else:
            h.last_beat = now
            h.step_time_ewma = (self.ewma * h.step_time_ewma
                                + (1 - self.ewma) * step_time)
            h.steps += 1

    def _median(self) -> float:
        ts = sorted(h.step_time_ewma for h in self.hosts.values())
        if not ts:
            return 0.0
        return ts[len(ts) // 2]

    def stragglers(self) -> list:
        med = self._median()
        if med <= 0:
            return []
        return [k for k, h in self.hosts.items()
                if h.step_time_ewma > self.threshold * med]

    def dead(self, timeout: float) -> list:
        now = self.clock()
        return [k for k, h in self.hosts.items()
                if now - h.last_beat > timeout]


@dataclasses.dataclass
class RunState:
    """Host-side resumable cursor saved in every checkpoint manifest."""
    step: int = 0
    data_position: int = 0
    rng_seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunState":
        return cls(**{k: d[k] for k in ("step", "data_position", "rng_seed")
                      if k in d})
