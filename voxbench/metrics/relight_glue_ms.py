"""Host milliseconds an event spends in the relight driver outside its
waits: the program's span `light.evaluate` (`light/update.py`, whole)
less its `wait` spans, over the traced events: the selection, the
batch's inputs and launch, `finish` and the scatters as the host runs
them."""

from aic_tpu_torch import profiling


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    st = None if rec is None else rec.spans.get("light.evaluate")
    if st is None or not run.traced_units:
        return None
    return (st.total_s - rec.waits_under("light.evaluate")[1]) * 1e3 / run.traced_units
