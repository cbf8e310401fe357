"""Per-phase wall timings of the step loop, spans and counters of the
relight path, and device traces.

Port of `aic_tpu/profiling.py`: the span timer (`SpanStats`,
`Profiler`) and `device_trace`, a device profile written to a directory
(`torch.profiler` where `aic_tpu` starts `jax.profiler`).

A span measures the host clock. Work a span queues on the card runs
after the host leaves it unless `sync` is set: a callable (e.g.
`torch.cuda.synchronize`) run at the end of every span, so that each
span holds its own device time, at the price of one synchronization per
span. A span's self time is its time less the part its child spans
cover. While a `torch.profiler` session records, every span also opens a
`record_function` range named by its path, so the span lands in the
Chrome trace as a `user_annotation` event on the kernels' clock.

    prof = Profiler()
    with prof.span("light"):
        ...
    prof.count("rounds")
    print(prof.report())

`RECORDER` is the process-wide profiler of the program's inner paths
(the transaction commit, the relight driver), driven by the module
functions `span`, `wait` and `count`. It records only while a
`torch.profiler` session records (`device_trace`, or a benchmark's
traced window); otherwise each call is one flag check and returns a
shared no-op context. `wait(name)` is a span around a line where the
host waits for the card (an `int()` or `bool()` of a card tensor, a
blocking host-to-card copy) and adds 1 to the counter `host_waits`.
No span or counter reads a tensor, synchronizes or allocates on the
card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

#: Whether a `torch.profiler` session is recording: a flag read (~0.1
#: µs), where a `record_function` range costs ~16 µs even with none.
recording = torch._C._autograd._profiler_enabled

#: The counter each `wait` adds 1 to.
HOST_WAITS = "host_waits"


@dataclass
class SpanStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    #: Time less the part the span's child spans cover.
    self_s: float = 0.0

    def add(self, dt: float, self_dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.self_s += self_dt
        self.max_s = max(self.max_s, dt)


@dataclass
class Profiler:
    """Hierarchical span timer with counters."""

    spans: dict = field(default_factory=lambda: defaultdict(SpanStats))
    counters: dict = field(default_factory=dict)
    #: Paths of the spans opened by `wait`.
    waits: set = field(default_factory=set)
    sync: Optional[Callable[[], None]] = None
    _stack: list = field(default_factory=list)
    #: Seconds the open spans' children took, one entry a stack level.
    _child_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        full = "/".join(self._stack + [name])
        rf = torch.profiler.record_function(full) if recording() else None
        if rf is not None:
            rf.__enter__()
        self._stack.append(name)
        self._child_s.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self._stack.pop()
            child = self._child_s.pop()
            if self._child_s:
                self._child_s[-1] += dt
            self.spans[full].add(dt, dt - child)
            if rf is not None:
                rf.__exit__(None, None, None)

    def wait(self, name: str):
        """A span around a line where the host waits for the card; counts
        one `host_waits`."""
        self.count(HOST_WAITS)
        self.waits.add("/".join(self._stack + [name]))
        return self.span(name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def waits_under(self, root: str) -> tuple[int, float]:
        """(calls, seconds) of the `wait` spans under the top-level span
        `root`."""
        paths = [p for p in self.waits if p.startswith(root + "/")]
        return sum(self.spans[p].calls for p in paths), sum(self.spans[p].total_s for p in paths)

    def report(self) -> str:
        """Info-text style report, longest total first."""
        rows = sorted(self.spans.items(), key=lambda kv: -kv[1].total_s)
        lines = [
            f"{name:<28} {st.calls:>5}x  total {st.total_s * 1e3:8.1f} ms  self {st.self_s * 1e3:8.1f} ms"
            f"  max {st.max_s * 1e3:7.1f} ms"
            for name, st in rows
        ]
        lines += [f"{name:<28} {n:>8}" for name, n in sorted(self.counters.items())]
        return "\n".join(lines)

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()
        self.waits.clear()


class _Off:
    """The no-op context of the module functions while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


#: The process-wide recorder of `span`, `wait` and `count`.
RECORDER = Profiler()
_OFF = _Off()


def span(name: str):
    """A `RECORDER` span while a `torch.profiler` session records, else a
    shared no-op context."""
    if not recording():
        return _OFF
    return RECORDER.span(name)


def wait(name: str):
    """A `RECORDER` wait span (`Profiler.wait`) while a `torch.profiler`
    session records, else a shared no-op context."""
    if not recording():
        return _OFF
    return RECORDER.wait(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to a `RECORDER` counter while a `torch.profiler` session
    records."""
    if recording():
        RECORDER.count(name, n)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merged(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _own_stretches(spans):
    """(start, end, name) of the stretches of one thread's nested spans
    (start, end, name), each stretch given to the innermost span open
    over it."""
    stack: list = []  # [(end, name)], innermost last
    t = None
    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            yield t, end, top
            t = end
        if stack:
            yield t, s, stack[-1][1]
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        yield t, end, top
        t = end


def idle_by_span(events) -> dict:
    """Attribute the card's idle time to program spans, from the events
    of a `torch.profiler` Chrome trace: {span path: {"idle_s", "host_s",
    "calls"}}. A span's idle seconds are those of its own time (its
    interval less its child spans', on its host thread) in which no
    kernel, copy or memset ran on the card; aten operators are not
    spans. `host_s` and `calls` are the span's events' total and count."""
    import bisect

    busy = _merged(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )
    starts = [s for s, _ in busy]
    prefix = [0.0]
    for s, e in busy:
        prefix.append(prefix[-1] + e - s)

    def busy_until(t: float) -> float:
        """Device-busy µs before t."""
        i = bisect.bisect_right(starts, t)
        return 0.0 if i == 0 else prefix[i - 1] + min(t, busy[i - 1][1]) - busy[i - 1][0]

    out: dict = {}
    threads: dict = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            s, dur = float(e["ts"]), float(e.get("dur", 0.0))
            threads[(e.get("pid"), e.get("tid"))].append((s, s + dur, e["name"]))
            st = out.setdefault(e["name"], {"idle_s": 0.0, "host_s": 0.0, "calls": 0})
            st["host_s"] += dur * 1e-6
            st["calls"] += 1
    for spans in threads.values():
        for s, e, name in _own_stretches(spans):
            out[name]["idle_s"] += ((e - s) - (busy_until(e) - busy_until(s))) * 1e-6
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile of the block (`aic_tpu` profiling.py:73,
    `jax.profiler.start_trace`): `torch.profiler` over the host and, where
    there is a card, the CUDA kernels, written into `log_dir` as a Chrome
    trace (`trace.json`, for chrome://tracing or Perfetto), and beside it
    `idle_by_span.json`: the card's idle seconds under each program span
    (`idle_by_span`)."""
    import json
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        events = events["traceEvents"] if isinstance(events, dict) else events
        with open(os.path.join(log_dir, "idle_by_span.json"), "w") as f:
            json.dump(idle_by_span(events), f, indent=1, sort_keys=True)
