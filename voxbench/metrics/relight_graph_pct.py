"""How many of the relight driver's queue rounds ran as a replay of a
captured CUDA graph: 100 times the program's counter `light.graph_rounds`
(`light/update.py::RoundGraph.replay`, one a replay) over `light.rounds`
(one a round of `evaluate_light`), in the traced window. A program
without round graphs, or a CPU rehearsal, counts no `light.graph_rounds`
and reads nothing."""

from aic_tpu_torch import profiling


def read(run, driver):
    rec = getattr(profiling, "RECORDER", None)
    if rec is None:
        return None
    rounds, graph_rounds = rec.counters.get("light.rounds"), rec.counters.get("light.graph_rounds")
    if not rounds or graph_rounds is None:
        return None
    return 100.0 * graph_rounds / rounds
