"""Per-phase wall timings of the step loop.

Port of the span timer of `aic_tpu/profiling.py` (`SpanStats`,
`Profiler`); its JAX device-trace wrapper is not carried over
(`torch.profiler` takes its place where a device trace is wanted).

A span measures the host clock. Work a span queues on the card runs
after the host leaves it unless `sync` is set: a callable (e.g.
`torch.cuda.synchronize`) run at the end of every span, so that each
span holds its own device time, at the price of one synchronization per
span.

    prof = Profiler()
    with prof.span("light"):
        ...
    print(prof.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class SpanStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


@dataclass
class Profiler:
    """Hierarchical span timer."""

    spans: dict = field(default_factory=lambda: defaultdict(SpanStats))
    sync: Optional[Callable[[], None]] = None
    _stack: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self._stack.pop()
            self.spans[full].add(time.perf_counter() - t0)

    def report(self) -> str:
        """Info-text style report, longest total first."""
        rows = sorted(self.spans.items(), key=lambda kv: -kv[1].total_s)
        return "\n".join(
            f"{name:<28} {st.calls:>5}x  total {st.total_s * 1e3:8.1f} ms  max {st.max_s * 1e3:7.1f} ms"
            for name, st in rows
        )

    def reset(self) -> None:
        self.spans.clear()
