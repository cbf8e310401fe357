"""The benchmark's harness: one cell, one run.

`run_cell` reads the cell from `BENCHMARK.json`, finds its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`, whose
`driver` names a module of `drivers/`) and the reader of each per-layer
metric (`metrics/<name>.py`) by name, and runs them:

1. set-up (`driver.setup`): load the world, warm every shape the cell
   uses; its seconds from the process's start are `setup_s`;
2. the window: units of work back to back (`driver.unit`), each one
   returned and the card synchronized before the next, for `--seconds`;
   with `--trace 1` under `torch.profiler` for the traffic's
   `trace_seconds` at most;
3. the check (`driver.check`): the program's state is freed, then the
   plain reference judges what the window produced.

Adding a cell, a world, a traffic mix or a metric adds files and
manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: Top-level module names that may not be loaded in the process that
#: prints a result: JAX and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "aic_tpu")


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (metric files carry dots in
    their names, so they are not importable by module name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the manifest with everything found by its names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    run_seconds: int

    @property
    def driver_name(self) -> str:
        return self.traffic["driver"]


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {', '.join(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
        run_seconds=int(bench["run_seconds"]),
    )


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"voxbench_metric_{name.replace('.', '_')}")


def driver_module(name: str):
    return load_module(BENCH_DIR / "drivers" / f"{name}.py", f"voxbench_driver_{name}")


def forbidden_loaded() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden,
    compared whole (`aic_tpu_torch` is not `aic_tpu`)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def require_chips(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: this benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")


# -- the run's context ------------------------------------------------------


@dataclass
class Run:
    """What a driver and a metric reader see of one run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    #: Overrides for a rehearsal or a test at a small size (e.g. "viewport").
    overrides: dict = field(default_factory=dict)
    #: Filled by the harness: the window's units, seconds, the trace's
    #: reduction (`TraceSummary`), and what the driver counts.
    units: int = 0
    traced_units: int = 0
    window_s: float = 0.0
    trace_summary: object = None
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    unit_ms: list = field(default_factory=list)

    def param(self, key, default=None):
        """A traffic parameter, unless a rehearsal overrides it."""
        return self.overrides.get(key, self.cell.traffic.get(key, default))

    def world_path(self) -> Path:
        return Path(self.overrides.get("world", ROOT / self.cell.config["world"]["file"]))


def seed_rng(seed: int, stream: str):
    """A numpy generator for one purpose of one seed: the traffic, the
    sample checked, ... never share a stream between purposes."""
    import numpy as np

    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in stream]
    return np.random.default_rng(words)


class Reservoir:
    """A seeded uniform sample of `k` of the units a window completes,
    kept without knowing the count in advance (algorithm R)."""

    def __init__(self, k: int, rng):
        self.k = k
        self.rng = rng
        self.items: list = []
        self.seen = 0

    def wants(self) -> int | None:
        """The slot the next unit would take, or None; call once a unit."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


# -- the device trace -------------------------------------------------------


@dataclass
class TraceSummary:
    """The profiler's trace of the traced window, reduced."""

    window_s: float
    busy_s: float
    #: kernel name -> (total seconds, launches)
    kernels: dict
    #: [(host op active over the gap, seconds)] longest first
    idle_gaps: list

    def kernel_seconds(self, *names: str) -> float:
        """Device seconds of the kernels whose name holds one of `names`
        (the profiler gives demangled signatures, with namespaces)."""
        return sum(t for name, (t, _) in self.kernels.items() if any(n in name for n in names))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The annotation around each traced unit of work.
UNIT_SPAN = "voxbench.unit"


def _union_seconds(intervals) -> tuple[float, list]:
    """Seconds covered by the union of (start, end) µs intervals, and the
    gaps between them [(start, end)]."""
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, gaps


def summarize_trace(path: str, window: tuple[float, float]) -> TraceSummary:
    """Reduce a Chrome trace of `torch.profiler` to device busy seconds
    within `window` (µs, the trace's clock), kernel time by name, and the
    longest idle gaps, each named by the innermost host op that covers
    its middle."""
    import bisect

    events = load_json(Path(path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    w0, w1 = window
    dev, host = [], []
    kernels: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if e < w0 or s > w1:
            continue
        s, e = max(s, w0), min(e, w1)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e))
            t, n = kernels.get(ev["name"], (0.0, 0))
            kernels[ev["name"]] = (t + (e - s) * 1e-6, n + 1)
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((s, e, ev["name"]))
    busy, gaps = _union_seconds(dev)
    if dev:
        first = min(s for s, _ in dev)
        last = max(e for _, e in dev)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for gs, ge in gaps[:10]:
        mid = (gs + ge) / 2
        best = None
        for h in host[max(0, bisect.bisect_right(starts, mid) - 2000): bisect.bisect_right(starts, mid)]:
            if h[0] <= mid <= h[1] and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        named.append([best[2] if best else "no host op", (ge - gs) * 1e-6])
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy, kernels=kernels, idle_gaps=named)


# -- one run ----------------------------------------------------------------


def host_probe(cuda: bool) -> dict:
    """How fast this run's host is, outside the window: the least of five
    timings (ms) of a fixed piece of interpreter work, and with a card of
    a round trip (a tiny launch and a synchronize, mean of 200). A run's
    spread that follows these is the machine's, not the program's."""
    import torch

    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i & 7
        best = min(best, (time.perf_counter() - t0) * 1e3)
    out = {"python_ms": best}
    if cuda:
        x = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            x += 1
            torch.cuda.synchronize()
        out["round_trip_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, nearest rank."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return float(v[k])


def run_cell(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    overrides: dict | None = None,
    t_start: float | None = None,
    driver_hooks: dict | None = None,
    control: bool = False,
) -> dict:
    """Run one cell once and return the result line's object. `device`
    "cpu" is a rehearsal: the program takes its plain twins, and the
    result names the CPU (no device metric is read from it). With
    `control` the result also holds the check's numbers for the reference
    in the next lower precision put in the program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
              overrides=dict(overrides or {}))
    drv = driver_module(cell.driver_name).Driver(run, **(driver_hooks or {}))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    probe_before = host_probe(cuda)

    trace_s = min(seconds, float(cell.traffic.get("trace_seconds", seconds)))
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        drv.tracing(True)
    tracing = False
    if prof is not None:
        prof.start()  # the profiler's own start-up (seconds the first time) stays outside the window
        tracing = True
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_end = t0 + trace_s
    n = 0
    unit_ms = []
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if tracing and now >= trace_end:
            prof.stop()  # the profiler's flush is no unit's time
            tracing = False
            run.traced_units = n
        u0 = time.perf_counter()
        if tracing:
            with torch.profiler.record_function(UNIT_SPAN):
                drv.unit(n)
                if cuda:
                    torch.cuda.synchronize()
        else:
            drv.unit(n)
            if cuda:
                torch.cuda.synchronize()
        unit_ms.append((time.perf_counter() - u0) * 1e3)
        n += 1
    window_s = time.perf_counter() - t0
    if tracing:
        prof.stop()
        run.traced_units = n
    run.units, run.window_s, run.unit_ms = n, window_s, unit_ms
    probe_after = host_probe(cuda)
    drv.window_closed()

    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="voxbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = load_json(Path(path))
            evs = events["traceEvents"] if isinstance(events, dict) else events
            # The traced window: the first traced unit's start to the last
            # one's end, on the trace's own clock.
            units = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in evs
                     if e.get("ph") == "X" and e.get("name") == UNIT_SPAN]
            w0 = min(s for s, _ in units) if units else 0.0
            w1 = max(e for _, e in units) if units else 0.0
            del events, evs
            run.trace_summary = summarize_trace(path, (w0, w1))
        finally:
            os.unlink(path)

    # Per-layer readings are taken before the check frees the program.
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run, drv)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = drv.end_to_end()
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    t_check = time.perf_counter()
    checks = drv.check()
    check_s = time.perf_counter() - t_check
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and drv.failed == 0
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu (rehearsal)",
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": bool(correct), "attempted": drv.attempted(), "failed": int(drv.failed),
              "metrics": metrics, "device": dev_info}
    if run.trace_summary is not None:
        ts = run.trace_summary
        dev_info["busy_s"] = ts.busy_s
        dev_info["window_s"] = ts.window_s
        top = sorted(ts.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[k, v[0]] for k, v in top], "idle_gaps": ts.idle_gaps[:10]}
    q = [percentile(unit_ms, x) for x in (0, 25, 50, 75, 95, 100)] if unit_ms else []
    result["unit_ms"] = dict(zip(("min", "p25", "p50", "p75", "p95", "max"), q))
    result["diagnostics"] = {"host_probe_ms": [probe_before, probe_after], "units": getattr(drv, "diagnostics", dict)()}
    result["reference_s"] = check_s
    if control:
        result["control"] = drv.control()
    result["checks"] = checks
    return result
