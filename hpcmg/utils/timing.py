"""Timing/profiling helpers.

The reference brackets whole runs with omp_get_wtime() / cudaEvent_t
(multigrid.cpp:244-246, mg_timer.cu:213-268).  JAX dispatches asynchronously,
so every timing here ends in `device_sync`.
"""

from __future__ import annotations

import contextlib
import time


def device_sync(x) -> None:
    """Block until every array in the pytree `x` has been computed."""
    import jax

    jax.block_until_ready(x)


class Timer:
    """Wall-clock timer with device synchronization.

    >>> with Timer() as t:
    ...     out = model.run()
    ...     t.sync(out[0])
    >>> t.seconds
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.seconds = None
        return self

    def sync(self, x) -> None:
        device_sync(x)

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def time_run(fn, *args, reps: int = 3, warmup: int = 1) -> dict:
    """Best-of-`reps` timing of `fn(*args)` with compile warm-up excluded."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        device_sync(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        device_sync(out)
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times), "times": times, "out": out}


@contextlib.contextmanager
def profile(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
