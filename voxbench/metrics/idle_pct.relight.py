"""Device idle share of the traced window, in a cell that relights edits:
100 less the union of the device's operation intervals over the window
(torch.profiler)."""


def read(run, driver):
    ts = run.trace_summary
    if ts is None or ts.window_s <= 0.0 or ts.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ts.busy_s / ts.window_s)
