"""How often the host waits for the card in an event: the program's
`wait` spans (each an `int()` or `bool()` of a card tensor or a blocking
host-to-card copy, counted in `host_waits`) under the commit's span
`txn.execute` and the relight's `light.evaluate`, over the traced
events."""

from aic_tpu_torch import profiling

ROOTS = ("txn.execute", "light.evaluate")


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not rec.counters.get(profiling.HOST_WAITS) or not run.traced_units:
        return None
    return sum(rec.waits_under(r)[0] for r in ROOTS) / run.traced_units
