"""How full the queue rounds' batches are: 100 times the cubes they relit
(the program's counter `light.rows_relit`, the `updated` that
`evaluate_light` reads) over the rows they launched
(`light.rows_launched`, the batch's rows a round), in the traced window."""

from aic_tpu_torch import profiling


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    launched = None if rec is None else rec.counters.get("light.rows_launched")
    if not launched:
        return None
    return 100.0 * rec.counters.get("light.rows_relit", 0) / launched
