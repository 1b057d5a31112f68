"""Tracing/profiling hooks around the jitted pipeline.

The reference has no profiling at all — its closest artifacts are the
StopCondition printouts and iteration logs (SURVEY.md section 5, tracing).
This module provides `jax.profiler` traces with named scopes per stage, plus
a lightweight wall-clock stage timer for hosts without TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import numpy as np


def force(tree):
    """Materialize every array of a pytree on the host and return it.

    A timing fence that includes the device-to-host copy of the whole
    output pytree (``timeit_forced`` below times through it).
    """
    return jax.tree.map(np.asarray, tree)


def timeit_forced(fn, *args, reps: int = 5, warmup: int = 2, **kwargs):
    """Median wall-clock seconds of ``force(fn(*args))`` over ``reps`` runs.

    Compilation and backend warmup are excluded by the untimed warmup calls.
    Returns (median_seconds, last_result).
    """
    out = None
    for _ in range(warmup):
        out = force(fn(*args, **kwargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = force(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view in TensorBoard / xprof):

        with profiling.trace("/tmp/vo_trace"):
            pipe.run_sequence(frames)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope visible in profiler timelines (use inside jitted code)."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Wall-clock per-stage accumulator with device sync at boundaries.

    Usage:
        t = StageTimer()
        with t("frontend"): out = frontend(...)
        with t("solve"):    res = solve(...)
        print(t.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = []
        for stage, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[stage]
            lines.append(
                f"{stage:24s} {total:8.3f} s total  {total / n * 1e3:8.2f} ms/call"
                f"  x{n}"
            )
        return "\n".join(lines)
