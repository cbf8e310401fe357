"""K2 (`csrc/relight.cu`: `relight_pass_kernel`, full and light-only, and
`relight_listed_kernel`): the least time the traced events' relights
could take (`roofline.relight_bytes` of their cube updates, at the card's
bandwidth) over K2's device time in the traced window, in %."""

from voxbench import roofline

KERNELS = ("relight_pass_kernel", "relight_listed_kernel")


def read(run, driver):
    ts = run.trace_summary
    if ts is None:
        return None
    k2_s = ts.kernel_seconds(*KERNELS)
    updates = sum(driver.updates[: run.traced_units])
    if k2_s <= 0.0 or updates <= 0:
        return None
    return roofline.share_pct(roofline.relight_bytes(updates), k2_s)
