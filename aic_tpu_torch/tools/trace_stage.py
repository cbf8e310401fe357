#!/usr/bin/env python3
"""Time the trace stage of a world's frame at 1920×1080 on one card.

    python3 aic_tpu_torch/tools/trace_stage.py [--root DIR] [--world plaza640] [--reps 10]

Imports `aic_tpu_torch` from `--root` (default: the checkout that holds
this script), so that two checkouts can be timed by the same code: run
it for each, alternated (A, B, B, A), in one session on one card. The
world is `content.plaza()` (traced by K3), `content.atrium()` or
demo-city at size 96, seed 0 (both traced by K1), snapshot on the card
and relit with `evaluate_light_dense`; the camera `main.default_camera`
with smoothstep lighting and no fog, as `chip_smoke.py` frames it. The
stage is one `trace_rays_kernel` call (its set-up, the kernel's rounds
or phases and their glue, shading and sky) between two
`torch.cuda.synchronize()`, on the host clock, after two warm-up calls.
Prints one JSON line: the card's name and power limit, the root, the
world and the `--reps` times in ms. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose aic_tpu_torch is timed")
    ap.add_argument("--world", choices=("plaza640", "atrium", "demo-city"), default="plaza640")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the trace stage is timed only on one")
    import aic_tpu_torch

    if not os.path.abspath(aic_tpu_torch.__file__).startswith(root + os.sep):
        sys.exit(f"aic_tpu_torch came from {aic_tpu_torch.__file__}, not from {root}")
    from aic_tpu_torch.content import TemplateParameters, atrium, build_template_space, plaza
    from aic_tpu_torch.light import evaluate_light_dense
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import GraphicsOptions
    from aic_tpu_torch.raytrace.trace_kernel import trace_rays_kernel

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    sp = {"plaza640": plaza, "atrium": atrium,
          "demo-city": lambda: build_template_space("demo-city", TemplateParameters(seed=0, size=96))}[args.world]()
    cam = default_camera(sp, 1920, 1080, opts)
    state, _ = evaluate_light_dense(sp.snapshot(device=dev))
    o, d = cam.pixel_rays(device=dev)
    for _ in range(2):
        trace_rays_kernel(state, o, d, cam.options)
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _light, _trans, unfinished = trace_rays_kernel(state, o, d, cam.options)
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 3))
        if unfinished:
            sys.exit("unfinished rays")
    print(json.dumps({"device": smi, "root": root, "world": args.world, "trace_ms": times}))


if __name__ == "__main__":
    main()
