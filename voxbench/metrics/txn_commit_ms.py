"""Host milliseconds an event spends committing its edit outside the
commit's waits: the program's span `txn.execute`
(`universe/transaction.py::UniverseTransaction.execute`, the check and
the commit, the trace cells' rebuild `txn.cells` inside it) less its
`wait` spans, over the traced events."""

from aic_tpu_torch import profiling


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    st = None if rec is None else rec.spans.get("txn.execute")
    if st is None or not run.traced_units:
        return None
    return (st.total_s - rec.waits_under("txn.execute")[1]) * 1e3 / run.traced_units
