"""Host milliseconds an event spends waiting for the card: the program's
`wait` spans under `txn.execute` and `light.evaluate`, over the traced
events."""

from aic_tpu_torch import profiling

ROOTS = ("txn.execute", "light.evaluate")


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not rec.counters.get(profiling.HOST_WAITS) or not run.traced_units:
        return None
    return sum(rec.waits_under(r)[1] for r in ROOTS) * 1e3 / run.traced_units
