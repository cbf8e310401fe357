"""The per-layer metrics that read the program's own spans and counters
(`aic_tpu_torch.profiling`'s recorder): a traced CPU rehearsal of
atrium.relight reports all six, consistent with each other and with the
events' time; on the card, the program's `host_waits` are every
synchronization the card reports."""

import traceback
import warnings

import pytest

from voxbench import harness

METRICS = ("relight_rounds", "relight_fill_pct", "relight_host_waits", "relight_wait_ms", "relight_glue_ms",
           "txn_commit_ms")


def test_a_traced_rehearsal_reports_the_program_metrics(tiny_world, monkeypatch):
    from aic_tpu_torch import profiling

    seen = {}
    reader = harness.metric_reader

    class Spy:
        """A metric's reader that keeps the run it reads."""

        def __init__(self, name):
            self.mod = reader(name)

        def read(self, run, drv):
            seen["run"] = run
            return self.mod.read(run, drv)

    monkeypatch.setattr(harness, "metric_reader", Spy)
    profiling.RECORDER.reset()
    overrides = {"sample_events": 1, "mix": {"single": 1.0, "slab": 0.0, "wall": 0.0}} | tiny_world
    r = harness.run_cell(harness.find_cell("atrium.relight"), 2**33 + 29, 3.0, True, device="cpu",
                         overrides=overrides)
    profiling.RECORDER.reset()
    run = seen["run"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(METRICS) <= set(m), sorted(m)
    assert run.traced_units >= 1 and r["correct"], r["checks"]
    assert m["relight_rounds"] >= 1
    assert 0 < m["relight_fill_pct"] <= 100
    assert m["relight_host_waits"] >= 1 + 3 * m["relight_rounds"]
    traced_ms = run.unit_ms[: run.traced_units]
    assert m["txn_commit_ms"] + m["relight_glue_ms"] + m["relight_wait_ms"] <= sum(traced_ms) / len(traced_ms)
    assert all(m[k] > 0 for k in ("txn_commit_ms", "relight_glue_ms", "relight_wait_ms"))


@pytest.mark.cuda
def test_host_waits_are_the_cards_synchronizations(card):
    """Each event of the cell, on the card: the program's `host_waits` equal
    the synchronizations `torch.cuda.set_sync_debug_mode("warn")` reports
    from inside the program."""
    import torch

    from aic_tpu_torch import profiling

    cell = harness.find_cell("atrium.relight")
    run = harness.Run(cell=cell, seed=2**33 + 31, seconds=10, trace=False, device="cuda")
    drv = harness.driver_module(cell.driver_name).Driver(run)
    drv.setup()
    syncs = [0]

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message) and any("aic_tpu_torch" in f.filename for f in traceback.extract_stack()):
            syncs[0] += 1

    per_event = []
    profiling.RECORDER.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(24):
                    s0, w0 = syncs[0], profiling.RECORDER.counters.get(profiling.HOST_WAITS, 0)
                    drv.unit(i)
                    per_event.append((syncs[0] - s0, profiling.RECORDER.counters[profiling.HOST_WAITS] - w0))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    profiling.RECORDER.reset()
    print("syncs, host_waits per event:", per_event)
    assert all(s == w and s > 0 for s, w in per_event), per_event
