"""Profiler (reference `Profiler` singleton + RAII ProfileAutoEvent,
src/base/Profiler.h:25-138): named timing sessions aggregating avg/low/high,
text or JSONL output, plus a hook into jax.profiler traces. Time device
work with jax.block_until_ready around it: JAX returns before the device
finishes.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path


class Profiler:
    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def event(self, name: str):
        """RAII-style timing block (reference ProfileAutoEvent)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            out[name] = {
                "count": len(xs),
                "avg_ms": 1e3 * sum(xs) / len(xs),
                "low_ms": 1e3 * min(xs),
                "high_ms": 1e3 * max(xs),
            }
        return out

    def write_text(self, path: str | Path) -> None:
        lines = [
            f"{name}: n={s['count']} avg={s['avg_ms']:.3f}ms "
            f"low={s['low_ms']:.3f}ms high={s['high_ms']:.3f}ms"
            for name, s in self.stats().items()
        ]
        Path(path).write_text("\n".join(lines) + "\n")

    def write_jsonl(self, path: str | Path) -> None:
        with open(path, "a") as fh:
            for name, s in self.stats().items():
                fh.write(json.dumps({"event": name, **s}) + "\n")

    def reset(self) -> None:
        self._samples.clear()


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """jax.profiler trace wrapper (the `--xprof` CLI flag uses this)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_the_profiler: Profiler | None = None


def the_profiler() -> Profiler:
    global _the_profiler
    if _the_profiler is None:
        _the_profiler = Profiler()
    return _the_profiler
