"""Observability: phase timers, throughput counters, profiler capture.

The reference has no timers or counters beyond ``n_accept_draws``
(SURVEY.md §5). This module provides the instrumentation layer:

- :class:`PhaseTimer` — wall-clock per named phase with explicit device
  synchronization, so async dispatch doesn't hide compute in a later phase;
- :func:`throughput` — draws/sec and leapfrog-steps/sec accounting;
- :func:`trace` / :func:`capture_trace` — thin wrappers over
  :mod:`jax.profiler` for op-level device traces viewable in TensorBoard /
  Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax

__all__ = ["PhaseTimer", "throughput", "trace", "capture_trace"]


@dataclass
class PhaseTimer:
    """Usage::

        timer = PhaseTimer()
        with timer.phase("warmup", sync=state):
            state = warmup(state)
        print(timer.timings)  # {"warmup": 1.23}
    """

    timings: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            target = box.get("sync", sync)
            if target is not None:
                jax.block_until_ready(target)
            self.timings[name] = self.timings.get(name, 0.0) \
                + time.perf_counter() - t0

    def count(self, name: str, n: float):
        self.counters[name] = self.counters.get(name, 0.0) + n

    def rates(self) -> Dict[str, float]:
        """counter / matching-phase-seconds for counters named 'phase.metric'."""
        out = {}
        for cname, n in self.counters.items():
            phase = cname.split(".")[0]
            secs = self.timings.get(phase)
            if secs:
                out[cname + "_per_sec"] = n / secs
        return out


def throughput(n_draws: int, n_chains: int, seconds: float,
               leapfrogs_per_draw: Optional[float] = None) -> Dict[str, float]:
    out = {
        "draws_per_sec": n_draws / seconds,
        "samples_per_sec": n_draws * n_chains / seconds,
    }
    if leapfrogs_per_draw is not None:
        out["leapfrog_steps_per_sec"] = n_draws * n_chains * leapfrogs_per_draw / seconds
    return out


def trace(name: str):
    """Annotate a region so it shows up named in a captured device trace."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a jax.profiler trace around the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
