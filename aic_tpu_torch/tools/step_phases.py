#!/usr/bin/env python3
"""Time `Universe.step` and its phases on the atrium and plaza640 on one card.

    python3 aic_tpu_torch/tools/step_phases.py [--root DIR] [--ticks 60]

Imports `aic_tpu_torch` from `--root` (default: the checkout that holds
this script), so that two checkouts can be timed by the same code: run
it for each, alternated (A, B, B, A), in one session on one card. Each
world is stepped as `chip_smoke.step_world` steps it (`build_universe`
on the card, relit by `evaluate_light`, a Become cycle and the placing
behavior of `chip_smoke.py`, 36 ticks of warm-up), then `--ticks` ticks
timed one by one (host clock, synchronized after each step), then
`--ticks` more with the profiler's phase spans synchronized at their
end. Prints one JSON line: the card's name and power limit, the root,
and per world the median ms a step and the mean ms a tick of each phase.
Imports no JAX.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose aic_tpu_torch is timed")
    ap.add_argument("--ticks", type=int, default=60)
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
    import chip_smoke  # the worlds' Become cycle and placing behavior
    from aic_tpu_torch.content import build_universe
    from aic_tpu_torch.light.update import evaluate_light

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"device": smi, "root": root}
    for name in ("atrium", "plaza640"):
        u = build_universe(name, device=dev)
        placed = chip_smoke.cycle_world(u.spaces["world"])
        u.resnapshot("world")
        u.states["world"], _ = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
        u.add_behavior("world", chip_smoke.make_placer(placed, chip_smoke.PLACE_EVERY))
        for _ in range(chip_smoke.STEP_WARMUP):
            u.step()
        ms = []
        for _ in range(args.ticks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        u.profiler.reset()
        u.profiler.sync = torch.cuda.synchronize
        for _ in range(args.ticks):
            u.step()
        spans = {k: round(v.total_s * 1e3 / v.calls, 3) for k, v in u.profiler.spans.items()}
        out[name] = {"median_ms": round(float(np.median(ms)), 3), "spans_ms": spans}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
