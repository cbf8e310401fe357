#!/usr/bin/env python3
"""Where an atrium.relight event's time goes, untraced, on one card.

    python3 aic_tpu_torch/tools/relight_split.py [--root DIR] [--seed N] [--events 300]

Imports `aic_tpu_torch` and `voxbench` from `--root` (default: the
checkout that holds this script), so that two checkouts are split by the
same code: run it for each in one session on one card. It sets up the
benchmark's `atrium.relight` driver as `voxbench/run.py` does, runs 40
events of warm-up, then `--events` events with the relight of each
(`evaluate_light`) timed apart from the rest of the event, the commit
(host clock, the card synchronized before and after the relight), and
the queue rounds of each relight counted from K2's listed launches.
Where the checkout has round graphs (`update.round_graph`) it then
places a 12x12x1 wall, counts the eager rounds its queue takes, and
times that many rounds three ways, alternated, 7 times (CUDA events and
host clock, medians): graph replays with the buffers' load, eager
rounds, and the load alone. Prints one line, `SPLIT` and a JSON object:
per event the mean ms of the event, the relight and the rest, the
rounds, the relight's ms a round, the same by kind of edit, and the
wall's timings. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose aic_tpu_torch and voxbench are split")
    ap.add_argument("--seed", type=int, default=1900000101)
    ap.add_argument("--events", type=int, default=300)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the split is timed only on one")
    from voxbench import harness

    cell = harness.find_cell("atrium.relight")
    run = harness.Run(cell=cell, seed=args.seed, seconds=0, trace=False, device="cuda")
    drv = harness.driver_module(cell.driver_name).Driver(run)
    drv.setup()
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light import update

    real, rec = drv.evaluate_light, []

    def timed(st):
        torch.cuda.synchronize()
        t0, l0 = time.perf_counter(), rk.LAUNCHES_LISTED
        out = real(st)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t0) * 1e3, rk.LAUNCHES_LISTED - l0))
        return out

    drv.evaluate_light = timed
    for i in range(40):
        drv.unit(i)
    rec.clear()
    drv.event_ms.clear()
    drv.kinds.clear()
    for i in range(args.events):
        drv.unit(40 + i)
    ev = np.asarray(drv.event_ms)
    rl = np.asarray([r[0] for r in rec])
    rounds = np.asarray([r[1] for r in rec])
    kinds = drv.kinds
    out = {"root": root, "events": len(ev), "event_ms": float(ev.mean()), "relight_ms": float(rl.mean()),
           "rest_ms": float((ev - rl).mean()), "rounds": float(rounds.mean()),
           "relight_ms_a_round": float(rl.sum() / rounds.sum()),
           "by_kind": {k: [sum(1 for x in kinds if x == k),
                           float(np.mean([e for e, x in zip(ev, kinds) if x == k])),
                           float(np.mean([r for r, x in zip(rl, kinds) if x == k])),
                           float(np.mean([n for n, x in zip(rounds, kinds) if x == k]))]
                       for k in sorted(set(kinds))}}

    if hasattr(update, "round_graph"):
        from aic_tpu_torch.space.state import scatter_set_cubes

        st = drv.u.states[drv.name]
        wall = torch.stack(torch.meshgrid(torch.arange(24, 36), torch.arange(1, 13), torch.tensor([20]),
                                          indexing="ij"), -1).reshape(-1, 3)
        st = scatter_set_cubes(st, wall, torch.full((144,), 2, dtype=torch.int32))
        update.evaluate_light(st)
        n_rounds, s = 0, st
        while True:
            s, stats = update.light_update_round(s)
            n_rounds += 1
            if int(stats["queue_remaining"]) == 0:
                break
        g = update.round_graph(st, 256)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        res: dict = {"graph": [], "eager": [], "load": []}
        for _ in range(7):
            for mode in ("graph", "eager", "eager", "graph", "load"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                if mode == "eager":
                    s = st
                    for _ in range(n_rounds):
                        s, _stats = update.light_update_round(s)
                else:
                    g.load(st)
                    if mode == "graph":
                        for _ in range(n_rounds):
                            g.replay()
                e1.record()
                torch.cuda.synchronize()
                res[mode].append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
        out["wall_rounds"] = n_rounds
        for mode, v in res.items():
            v = np.asarray(v)
            out[f"{mode}_events_ms"] = float(np.median(v[:, 0]))
            out[f"{mode}_host_ms"] = float(np.median(v[:, 1]))
        out["graph_device_ms_a_round"] = (out["graph_events_ms"] - out["load_events_ms"]) / n_rounds
        out["eager_ms_a_round"] = out["eager_events_ms"] / n_rounds
    print("SPLIT", json.dumps(out))


if __name__ == "__main__":
    main()
