"""Profiling / tracing utilities (SURVEY.md §5 tracing row).

The reference's tracing is manual ``time.perf_counter`` spans printed as
学習時間/圧縮時間/展開時間 (image_comp.py:106-153) plus a per-step Time
scalar. JAX equivalents here:

- :class:`SpanTimer` — named wall-clock spans accumulated into a report
  (keeps the reference's habit, queryable instead of print-only);
- :func:`profile_trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace (the device timeline of XLA and kernels);
- :func:`annotate` — ``jax.profiler.TraceAnnotation`` passthrough so host
  code shows up in the device timeline.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["SpanTimer", "profile_trace", "annotate", "enable_nan_checks"]


class SpanTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(1, self.counts[k])}
            for k in self.totals
        }


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (XLA device timeline) into ``logdir``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Host-side annotation that appears on the profiler timeline."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def enable_nan_checks(enable: bool = True) -> None:
    """Global NaN/Inf detection in jitted code (jax_debug_nans) — the
    device-side complement of the reference's host-side safe_statistics
    audits (utils.py:149-181)."""
    import jax

    jax.config.update("jax_debug_nans", enable)
