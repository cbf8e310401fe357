"""The 95th percentile of the window's edit-and-settle events after the
traced part (the profiler slows the host it paces), each timed on the
host from its edit to its settled light with the card synchronized.
Per-layer, not end to end: the card is idle for most of the window, so
the tail is paced by the host and repeats too loosely to decide a
change."""

from voxbench import harness


def read(run, driver):
    times = driver.event_ms[run.traced_units:]
    return harness.percentile(times, 95.0) if times else None
