"""Tracing, profiling, and structured metrics.

The reference's only observability is unstructured stdout dumps
(slam.cpp:253-260) and rviz paths (SURVEY.md section 5). Here:

- :func:`trace` — context manager around ``jax.profiler.trace`` producing a
  TensorBoard-loadable trace directory (per-kernel device timelines);
- :func:`stage` — ``jax.named_scope`` alias so pipeline stages (sim /
  perception / filter) are labeled in profiles;
- :func:`time_fn` — the kernel-timing harness: compile, warm up, then
  median wall time, each call ended by ``jax.block_until_ready`` (JAX
  returns before the device finishes);
- :class:`MetricsLog` — JSONL logger for per-run metrics artifacts the
  driver/CI can diff.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Iterable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block to ``logdir`` (TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


stage = jax.named_scope


def _sync(tree):
    """Wait until every array of ``tree`` is computed on the device."""
    return jax.block_until_ready(tree)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> dict:
    """Median/best wall time of ``fn(*args)`` with warmup and host sync."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "best_s": times[0],
        "median_s": times[len(times) // 2],
        "mean_s": sum(times) / len(times),
        "iters": iters,
    }


class MetricsLog:
    """Append-only JSONL metrics artifact."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, **fields: Any) -> None:
        rec = {"t": time.time()}
        rec.update({
            k: (float(v) if hasattr(v, "dtype") or isinstance(v, (int, float))
                else v)
            for k, v in fields.items()
        })
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
