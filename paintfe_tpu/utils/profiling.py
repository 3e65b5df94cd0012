"""Tracing / profiling: per-stage wall-clock timers + JAX profiler hooks.

Behavioral contract: the reference's observability surface (SURVEY §5) —
per-file wall clock in CLI verbose (cli.rs:164), FPS ring, script
elapsed_ms — upgraded to device-aware equivalents: stage timers that
block on device work, and optional jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple


class _StageHandle:
    """Set `.result` inside a stage block to have the timer block on it."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class StageTimer:
    """Accumulates named stage durations; blocks on device results so times
    reflect real device work, not async dispatch."""

    def __init__(self):
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time one named stage.

        To make jitted work count as device time (not async dispatch),
        either pass `block_on` as a ZERO-ARG CALLABLE (evaluated at stage
        exit, so it can reference values produced inside the block) or set
        `handle.result` on the yielded handle:

            with timer.stage("flatten") as h:
                h.result = flatten(img)   # blocked on at stage exit
        """
        handle = _StageHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            target = handle.result
            if target is None and block_on is not None:
                target = block_on() if callable(block_on) else block_on
            if target is not None:
                import jax

                jax.block_until_ready(target)
            self.stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        lines = [f"  {name}: {dt * 1000:.1f} ms" for name, dt in self.stages]
        return "\n".join(lines)


@contextlib.contextmanager
def jax_trace(log_dir: Optional[str]):
    """Wrap a region in a jax.profiler trace when a log dir is given."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class FpsRing:
    """60-sample frame-time ring (canvas/view/core.rs:253-268)."""

    def __init__(self, size: int = 60):
        self.samples: List[float] = []
        self.size = size
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.size:
                self.samples.pop(0)
        self._last = now

    def fps(self) -> float:
        if not self.samples:
            return 0.0
        return len(self.samples) / sum(self.samples)
