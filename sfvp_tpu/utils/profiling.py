"""Tracing / profiling hooks (SURVEY.md §5).

The reference has no timestamps or query pools. Here ``profile_trace``
captures a jax.profiler trace (device and host timelines) for
tensorboard / xprof, and ``named_scope`` is re-exported for labelling
phases in such traces; no render phase is wrapped in one yet.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import jax

named_scope = jax.named_scope  # re-export: phase annotation for kernels


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of the enclosed block::

        with profile_trace("/tmp/sfvp_trace"):
            renderer.step(8)
    """
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock phase timer with EMA smoothing for the driver's logs."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema = {}
        self._t0 = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else (
                self.alpha * dt + (1 - self.alpha) * prev
            )

    def summary(self) -> dict:
        return {k: round(v, 5) for k, v in self.ema.items()}
