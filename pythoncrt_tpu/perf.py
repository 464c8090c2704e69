"""Named-stage performance accounting.

Same report contract as the reference's perf subsystem
(crt_filter.py:58-101): thread-safe accumulators keyed by stage name,
a plain-text report sorted by total time with per-call averages, and an
iterator wrapper for timing decode. Stage namespaces: ``io.*`` host I/O,
``fx.*`` effect compute (device step dispatch+sync).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterable, Iterator

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


def perf_add(name: str, dt: float) -> None:
    with _lock:
        _totals[name] += float(dt)
        _counts[name] += 1


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        perf_add(name, time.perf_counter() - t0)


def timed_iter(iterable: Iterable, name: str) -> Iterator:
    """Yield from ``iterable``, charging the time spent producing each
    item to ``name`` (used to time the decode iterator)."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            v = next(it)
        except StopIteration:
            return
        perf_add(name, time.perf_counter() - t0)
        yield v


def snapshot() -> dict[str, tuple[float, int]]:
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in _totals}


def perf_reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


def perf_report(total_frames: int, total_seconds: float, print_fn=print) -> str:
    """Plain-text report in the reference's format (crt_filter.py:69-76)."""
    lines = [f"perf total {total_seconds:.3f}s", f"perf frames {total_frames}"]
    if total_seconds > 0 and total_frames:
        lines.append(f"perf fps {total_frames / total_seconds:.1f}")
    for k, (tot, cnt) in sorted(snapshot().items(), key=lambda kv: kv[1][0], reverse=True):
        avg = (tot / cnt * 1000.0) if cnt else 0.0
        lines.append(f"{k} total={tot:.3f}s count={cnt} avg_ms={avg:.2f}")
    text = "\n".join(lines)
    if print_fn is not None:
        print_fn(text)
    return text


@contextlib.contextmanager
def device_trace(name: str):
    """Annotate a region for jax.profiler / xprof traces (no-op cost when
    no profiler session is active)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
