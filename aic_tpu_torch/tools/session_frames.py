#!/usr/bin/env python3
"""Time the session's 1920x1080 frames (demo-city with its HUD) on one card.

    python3 aic_tpu_torch/tools/session_frames.py [--root DIR] [--frames 10]

Imports `aic_tpu_torch` from `--root` (default: the checkout that holds
this script), so that two checkouts can be timed by the same code: run
it for each, alternated (A, B, B, A), in one session on one card. The
world is played as `chip_smoke.session_world` plays it: demo-city (seed
0, size 96) from `build_universe` on the card, relit by
`evaluate_light`, a `Session` at 1920x1080 with its HUD, 35 warm-up
steps, then `--frames` frames of `maybe_step` + `render_with_ui` on a
clock advancing 1/60 s a frame, each timed on the host clock between
two synchronizations. Prints one JSON line: the card's name and power
limit, the root, the median ms a frame and every frame, and whether PIL
was imported. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose aic_tpu_torch is timed")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the session is timed only on one")
    import aic_tpu_torch

    if not os.path.abspath(aic_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"aic_tpu_torch came from {aic_tpu_torch.__file__}, not from {root}")
    from aic_tpu_torch.apps.session import STEP_DT, Session
    from aic_tpu_torch.content import TemplateParameters, build_universe
    from aic_tpu_torch.light.dense import OverrelaxFellBack
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.raytrace import Viewport

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    u = build_universe("demo-city", TemplateParameters(seed=0, size=96), device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", OverrelaxFellBack)
        u.states["world"], _ = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
    session = Session(u, viewport=Viewport(1920, 1080))
    session.enable_ui()
    warmup = 35
    for i in range(warmup):
        session.maybe_step(i * STEP_DT * 1.0001)
    frames = []
    for i in range(args.frames):
        now = (warmup + i) * STEP_DT * 1.0001
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.maybe_step(now)
        session.render_with_ui()
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"device": smi, "root": root, "median_ms": float(np.median(frames)),
                      "frames": [round(f, 1) for f in frames], "PIL": "PIL" in sys.modules}))


if __name__ == "__main__":
    main()
