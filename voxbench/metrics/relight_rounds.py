"""The relight driver's queue rounds an event: the program's counter
`light.rounds` (`light/update.py::evaluate_light`, one a round) over the
traced window, the only time the recorder of `aic_tpu_torch.profiling`
records in a run, over the traced events."""

from aic_tpu_torch import profiling


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    rounds = None if rec is None else rec.counters.get("light.rounds")
    if not rounds or not run.traced_units:
        return None
    return rounds / run.traced_units
