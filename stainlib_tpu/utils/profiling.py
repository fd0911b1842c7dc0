"""Profiling and tracing helpers.

The reference's observability is wall-clock prints (SURVEY.md section 5);
here the same counters exist (:mod:`stainlib_tpu.utils.meters`) plus proper
device traces via ``jax.profiler`` — the device-side upgrade.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class StepTimer:
    """Blocking step timer: median/p50 wall time of jitted steps.

    ``block=True`` inserts ``block_until_ready`` so async dispatch doesn't
    hide device time (the pitfall of naive Python timing around jit).
    """

    def __init__(self, block: bool = True):
        self.block = block
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self, result_getter=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if self.block and "result" in out:
            jax.block_until_ready(out["result"])
        self.times.append(time.perf_counter() - t0)

    def p50(self) -> Optional[float]:
        if not self.times:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]
