"""Phase timers and throughput metrics (SURVEY.md §2 C18, §5.1/§5.5).

`PhaseTimer` wraps setup/factorize/solve phases with wall-clock timing and
emits a JSON-able report; `spmv_rate` converts an apply time to nnz/s (THE
metric, BASELINE.json:2). For kernel-level traces use `trace(logdir)` which
wraps `jax.profiler` (inspect with TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import json
import time


class PhaseTimer:
    """Accumulating named phase timer.

    with timer.phase("assemble"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return json.dumps(
            {
                name: {"total_s": self.totals[name], "calls": self.counts[name]}
                for name in self.totals
            }
        )


def spmv_rate(nnz: int, seconds: float) -> float:
    """nnz/s for one operator apply."""
    return nnz / seconds if seconds > 0 else float("inf")


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (per-kernel device times)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
