#!/usr/bin/env python3
"""Time `Universe.step` and its phases on the atrium, plaza640 and demo-city on one card.

    python3 aic_tpu_torch/tools/step_phases.py [--root DIR] [--ticks 60] [--worlds atrium ...]

Imports `aic_tpu_torch` from `--root` (default: the checkout that holds
this script), so that two checkouts can be timed by the same code: run
it for each, alternated (A, B, B, A), in one session on one card. The
atrium and plaza640 are stepped as `chip_smoke.step_world` steps them
(`build_universe` on the card, relit by `evaluate_light`, a Become cycle
and the placing behavior of `chip_smoke.py`, 36 ticks of warm-up),
demo-city as `chip_smoke.city_world` does (size 96, its own signal
cycle, 35 ticks of warm-up). Then `--ticks` ticks timed one by one (host
clock, synchronized after each step; ticks that grow the palette are
left out of the median), `--ticks` more with the profiler's phase spans
synchronized at their end, and `--ticks` more counting K2's listed
launches and those whose batch walked no row (`chip_smoke.walked_rows`,
read after the ticks). Prints one JSON line: the card's name and power
limit, the root, and per world the median and mean ms a step, the mean
ms a tick of each phase and the launch counts. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
WORLDS = ("atrium", "plaza640", "demo-city")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose aic_tpu_torch is timed")
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--worlds", nargs="+", choices=WORLDS, default=list(WORLDS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the step is timed only on one")
    import aic_tpu_torch

    if not os.path.abspath(aic_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"aic_tpu_torch came from {aic_tpu_torch.__file__}, not from {root}")
    sys.path.insert(1, ROOT)
    import chip_smoke  # the worlds' Become cycle, placing behavior and batch census
    from aic_tpu_torch.content import TemplateParameters, build_universe
    from aic_tpu_torch.light import relight_kernel
    from aic_tpu_torch.light.update import evaluate_light

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"device": smi, "root": root}
    for name in args.worlds:
        if name == "demo-city":
            u = build_universe(name, TemplateParameters(seed=0, size=96), device=dev)
            warmup = chip_smoke.CITY_WARMUP
        else:
            u = build_universe(name, device=dev)
            placed = chip_smoke.cycle_world(u.spaces["world"])
            u.resnapshot("world")
            warmup = chip_smoke.STEP_WARMUP
        u.states["world"], _ = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
        if name != "demo-city":
            u.add_behavior("world", chip_smoke.make_placer(placed, chip_smoke.PLACE_EVERY))
        for _ in range(warmup):
            u.step()
        sp = u.spaces["world"]
        ms, grew = [], 0
        for _ in range(args.ticks):
            pal = sp.palette_len()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u.step()
            torch.cuda.synchronize()
            if sp.palette_len() == pal:
                ms.append((time.perf_counter() - t0) * 1e3)
            else:
                grew += 1
        u.profiler.reset()
        u.profiler.sync = torch.cuda.synchronize
        for _ in range(args.ticks):
            u.step()
        spans = {k: round(v.total_s * 1e3 / v.calls, 3) for k, v in u.profiler.spans.items()}
        u.profiler.sync = None
        before = relight_kernel.LAUNCHES_LISTED
        with chip_smoke.walked_rows() as batches:
            for _ in range(args.ticks):
                u.step()
        walked = [int(n) for n, _batch in batches]
        out[name] = {"median_ms": round(float(np.median(ms)), 3), "mean_ms": round(float(np.mean(ms)), 3),
                     "ticks": len(ms), "palette_growing": grew,
                     "spans_ms": spans, "census_ticks": args.ticks,
                     "listed_launches": relight_kernel.LAUNCHES_LISTED - before,
                     "launches_walking_none": sum(n == 0 for n in walked)}
        del batches, u
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
