"""The port's span system (aic_tpu_torch.profiling): `Profiler` spans with
self time and counters, the process-wide recorder behind `span`, `wait`
and `count`, which records only while a `torch.profiler` session does,
the spans and counters of the transaction commit and the relight
driver, and `idle_by_span`, which puts the card's idle time down to the
program span that held the host. CPU only."""

import io
import json
import time

import numpy as np
import pytest
import torch

from aic_tpu_torch import block, logging, profiling
from aic_tpu_torch.light import update
from aic_tpu_torch.light.dense import evaluate_light_dense
from aic_tpu_torch.math.grid import GridAab
from aic_tpu_torch.space import Sky, Space, SpacePhysics
from aic_tpu_torch.universe import Universe
from aic_tpu_torch.universe.transaction import SpaceTransaction, UniverseTransaction


@pytest.fixture
def recorder():
    profiling.RECORDER.reset()
    yield profiling.RECORDER
    profiling.RECORDER.reset()


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _universe():
    """A lit 10x8x10 room with a lamp on the CPU, as a universe."""
    sp = Space(GridAab.from_lower_size((0, 0, 0), (10, 8, 10)),
               physics=SpacePhysics(sky=Sky.uniform((0.5, 0.6, 0.8)), light_max_distance=8))
    sp.fill(GridAab.from_lower_size((0, 0, 0), (10, 1, 10)), block.from_color((0.5, 0.5, 0.5, 1.0), "floor"))
    sp.fill(GridAab.from_lower_size((7, 1, 1), (1, 4, 6)), block.from_color((0.8, 0.3, 0.2, 1.0), "wall"))
    sp.set((2, 3, 2), block.from_color((1.0, 1.0, 1.0, 1.0), "lamp", emission=(3.0, 3.0, 2.5)))
    u = Universe(device="cpu")
    u.insert_space("world", sp)
    u.states["world"], _ = evaluate_light_dense(u.states["world"])
    return u


def _edit(u, cube=(4, 2, 6)):
    """Clear the lamp and set an opaque cube, as one transaction."""
    wall = u.spaces["world"].block_at((7, 1, 1))
    txn = SpaceTransaction.set_cube((2, 3, 2), new=block.AIR, conserved=False)
    txn = txn.merge(SpaceTransaction.set_cube(cube, new=wall, conserved=False))
    return UniverseTransaction(spaces={"world": txn})


def test_nothing_records_without_a_profiler(recorder, monkeypatch):
    """With no profiler session, `span`, `wait` and `count` record nothing
    and open no `record_function` range; a `Profiler` instance still
    times on the host clock, without a range."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: opened.append(a))
    assert not profiling.recording()
    with profiling.span("a"):
        with profiling.wait("b"):
            profiling.count("c", 5)
    assert profiling.span("x") is profiling.wait("y") is profiling._OFF
    assert not recorder.spans and not recorder.counters and not recorder.waits
    p = profiling.Profiler()
    with p.span("outer"):
        pass
    assert p.spans["outer"].calls == 1 and not opened


def test_nested_spans_give_paths_self_time_and_counters(recorder, tmp_path):
    """Under `torch.profiler.profile()` nested spans record their paths,
    calls, totals and self time (the total less the children's), counters
    add up, `wait` counts `host_waits`, and the Chrome trace holds one
    `user_annotation` event per span, named by its path."""
    with _cpu_profile() as prof:
        for _ in range(2):
            with profiling.span("a"):
                time.sleep(0.002)
                with profiling.span("b"):
                    time.sleep(0.003)
                    with profiling.wait("w"):
                        time.sleep(0.001)
                with profiling.span("c"):
                    time.sleep(0.001)
                profiling.count("n", 3)
    s = recorder.spans
    assert {k: v.calls for k, v in s.items()} == {"a": 2, "a/b": 2, "a/b/w": 2, "a/c": 2}
    assert s["a"].self_s == pytest.approx(s["a"].total_s - s["a/b"].total_s - s["a/c"].total_s, abs=1e-9)
    assert s["a/b"].self_s == pytest.approx(s["a/b"].total_s - s["a/b/w"].total_s, abs=1e-9)
    assert s["a/b/w"].self_s == s["a/b/w"].total_s >= 0.002
    assert s["a"].self_s >= 0.004 and s["a"].max_s <= s["a"].total_s
    assert recorder.counters == {"n": 6, profiling.HOST_WAITS: 2}
    assert recorder.waits == {"a/b/w"}
    calls, secs = recorder.waits_under("a")
    assert calls == 2 and secs == s["a/b/w"].total_s
    assert recorder.waits_under("b") == (0, 0)
    names = _annotations(prof, tmp_path)
    assert sorted(names) == sorted(p for p, st in s.items() for _ in range(st.calls))
    assert "self" in recorder.report() and "host_waits" in recorder.report()


def test_profiler_instances_share_the_ranges(recorder, tmp_path):
    """A `Profiler` of its own (the universe's, the session's) times on
    the host clock always and, under a profiler, also lands in the trace;
    it records nothing into the process-wide recorder."""
    p = profiling.Profiler()
    with _cpu_profile() as prof:
        with p.span("step"):
            with p.span("light"):
                pass
        p.count("frames")
    assert set(p.spans) == {"step", "step/light"} and p.counters == {"frames": 1}
    assert sorted(_annotations(prof, tmp_path)) == ["step", "step/light"]
    assert not recorder.spans
    p.reset()
    assert not p.spans and not p.counters


def test_evaluate_light_counts_rounds_rows_and_waits(recorder):
    """`evaluate_light` under the profiler counts the rounds it ran (as
    many as `light_update_round` driven by hand from the same state), the
    cubes relit (its return), the rows launched (the batch's rows a
    round) and one `host_waits` a wrapped site and call: the queue's size
    once, then one read-back of the round's counts a round. On the CPU the
    rounds run eagerly: no round graph is captured or replayed."""
    u = _universe()
    _edit(u).execute(u)
    start = u.states["world"]
    st, rounds, by_hand = start, 0, 0
    while True:
        st, stats = update.light_update_round(st)
        rounds += 1
        by_hand += int(stats["updated"])
        if int(stats["queue_remaining"]) == 0:
            break
    assert rounds >= 2
    assert not recorder.spans
    with _cpu_profile():
        got, updated = update.evaluate_light(start)
    c = recorder.counters
    assert c["light.rounds"] == rounds
    assert c["light.rows_relit"] == updated == by_hand
    assert c["light.rows_launched"] == rounds * update.batch_shape(start.light_dirty.numel(), 256)[0]
    assert "light.graph_rounds" not in c and "light.graph_captures" not in c
    assert torch.equal(got.light, st.light)
    s = recorder.spans
    assert s["light.evaluate"].calls == 1 and s["light.evaluate/light.round"].calls == rounds
    for name in ("light.select", "light.relight", "light.scatter"):
        assert s[f"light.evaluate/light.round/{name}"].calls == rounds
    assert recorder.waits == {"light.evaluate/light.n_dirty", "light.evaluate/light.counts"}
    assert s["light.evaluate/light.counts"].calls == rounds
    assert s["light.evaluate/light.n_dirty"].calls == 1
    assert c[profiling.HOST_WAITS] == sum(s[p].calls for p in recorder.waits) == 1 + rounds
    assert recorder.waits_under("light.evaluate")[0] == c[profiling.HOST_WAITS]


def test_a_queue_round_waits_for_nothing(recorder):
    """One `light_update_round` on cornell-box 16 under the profiler counts
    no `wait` under `light.round`, and neither do the inputs of the card's
    listed launch (`listed_inputs`): a round reads nothing back from the
    card and copies nothing to it from the host, which is what capturing
    it as a CUDA graph needs."""
    from aic_tpu_torch.content import cornell_box
    from aic_tpu_torch.space.state import scatter_set_cubes

    st = cornell_box(16).snapshot(device="cpu")
    st = scatter_set_cubes(st, torch.tensor([[8, 1, 8], [3, 5, 9]]), torch.zeros(2, dtype=torch.int32))
    pos, valid, _flat = update.select_batch(st.light_dirty, 256)
    assert not recorder.spans
    with _cpu_profile():
        _new, stats = update.light_update_round(st)
        update.listed_inputs(st, pos, valid)
    assert int(stats["updated"]) > 0
    assert recorder.spans["light.round"].calls == 1
    assert recorder.waits_under("light.round") == (0, 0)
    assert not recorder.waits and profiling.HOST_WAITS not in recorder.counters


def test_transaction_commit_spans_and_waits(recorder):
    """`UniverseTransaction.execute` under the profiler: the commit's span,
    the cells' rebuild inside it, and its four waits (two copies of the
    edit, the neighbour offsets, the dirty marks); its bounds checks
    compare with the shape's ints and wait for nothing."""
    u = _universe()
    with _cpu_profile():
        _edit(u).execute(u)
    s = recorder.spans
    assert s["txn.execute"].calls == 1
    cells = [p for p in s if p.endswith("/txn.cells")]
    assert cells and all(p.startswith("txn.execute/") for p in cells)
    assert recorder.waits_under("txn.execute")[0] == recorder.counters[profiling.HOST_WAITS] == 4
    names = sorted(p.rsplit("/", 1)[-1] for p in recorder.waits)
    assert names == ["space.mark_dirty", "space.mark_offsets", "txn.blocks", "txn.positions"]


def test_batch_shape_is_select_batchs(recorder):
    """`batch_shape` gives the rows `select_batch` returns, tiny volumes
    included."""
    for shape, batch in (((10, 8, 10), 256), ((3, 2, 5), 256), ((2, 2, 2), 4), ((60, 35, 40), 256), ((9, 9, 9), 1024)):
        dirty = torch.zeros(shape, dtype=torch.uint8)
        pos, valid, flat = update.select_batch(dirty, batch)
        assert pos.shape[0] == update.batch_shape(int(np.prod(shape)), batch)[0], shape


def test_idle_by_span_on_a_hand_written_trace():
    """Two nested program spans, an aten operator inside the inner one and
    two kernels: each span gets the idle time of its own stretch, the
    operator none."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "a", "ts": 0.0, "dur": 100.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "a/b", "ts": 20.0, "dur": 50.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 30.0, "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 20.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60.0, "dur": 30.0, "pid": 0, "tid": 7},
        {"ph": "i", "cat": "user_annotation", "name": "marker", "ts": 5.0, "pid": 1, "tid": 1},
    ]
    got = profiling.idle_by_span(events)
    assert set(got) == {"a", "a/b"}
    # a's own stretch: [0, 20] and [70, 100], busy [10, 20] and [70, 90].
    assert got["a"]["idle_s"] == pytest.approx(20e-6)
    # a/b: [20, 70], busy [20, 30] and [60, 70].
    assert got["a/b"]["idle_s"] == pytest.approx(30e-6)
    assert got["a"]["host_s"] == pytest.approx(100e-6) and got["a/b"]["host_s"] == pytest.approx(50e-6)
    assert got["a"]["calls"] == got["a/b"]["calls"] == 1


def test_device_trace_writes_idle_by_span(recorder, tmp_path):
    """`device_trace` writes `idle_by_span.json` beside `trace.json`; on
    the CPU there is no kernel, so each span's idle time is its own."""
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("outer"):
            time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.002)
    assert (tmp_path / "trace.json").exists()
    got = json.loads((tmp_path / "idle_by_span.json").read_text())
    assert set(got) == {"outer", "outer/inner"}
    assert got["outer"]["calls"] == 1 and got["outer"]["host_s"] >= 0.006
    assert got["outer"]["idle_s"] == pytest.approx(got["outer"]["host_s"] - got["outer/inner"]["host_s"], abs=1e-5)
    assert recorder.spans["outer"].calls == 1


def test_universe_step_reports_phases():
    """The step's phases still land in `u.profiler.spans`."""
    u = _universe()
    u.step()
    assert {"tick_actions", "behaviors", "physics", "light"} <= set(u.profiler.spans)
    assert "ms" in u.profiler.report()


def test_telemetry_phases_are_the_steps_own():
    """Each `universe_step` record's phases are that step's durations:
    over the steps they add up to the profiler's totals, where totals
    since the profiler began would add up to more."""
    u = _universe()
    out = io.StringIO()
    logging.Telemetry(stream=out).attach_to_universe(u)
    for _ in range(4):
        u.step()
    records = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert len(records) == 4
    for name, st in u.profiler.spans.items():
        assert sum(r["phases"][name] for r in records) == pytest.approx(st.total_s * 1e3, abs=4e-3), name
    for r in records:
        assert all(v <= r["wall_ms"] + 1e-3 for v in r["phases"].values()), r
