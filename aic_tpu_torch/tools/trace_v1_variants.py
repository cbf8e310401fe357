#!/usr/bin/env python3
"""Time the design alternatives of the v1 surface finder (`csrc/trace_v1.cu`).

    python3 aic_tpu_torch/tools/trace_v1_variants.py [--reps 20]

Each variant is the committed `trace_v1.cu` with one change made by text
substitution (`VARIANTS`): block size, a register cap, the L1 row copied
into shared memory, blocks run in reverse order, the ray's origin and
direction held in registers instead of reloaded in the macro step, a
step into another region tested in the same attempt, the next step's row
word loaded ahead of the bit test. All are built with the kernels' nvcc
flags, one process each, started together, into the git-ignored
`aic_tpu_torch/_build/variants/`, and launched through
`trace_kernel_v1.launch` on the states of the main path: the four K3
launches of a warm plaza640 frame at 1920×1080 (rounds 1-4, each over
its walking list) and the atrium's 1920×1080 launch state. Every variant
must give the committed kernel's output bit for bit. Times are launch
only (`chip_smoke.launch_ms`, a spin kernel queued ahead, mean of
`--reps`), taken in two passes over the variants, the second in reverse
order; both are printed. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: name → [(text in trace_v1.cu, its replacement)], applied in order; each
#: text must occur exactly once.
VARIANTS = {
    "committed": [],
    "threads64": [("THREADS = 128;", "THREADS = 64;")],
    "threads256": [("THREADS = 128;", "THREADS = 256;")],
    "minblocks10": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 10)")],
    "minblocks12": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 12)")],
    "minblocks16": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 16)")],
    "l1_shared": [
        ("  const int j = blockIdx.x * blockDim.x + threadIdx.x;\n",
         "  __shared__ uint32_t l1[128];\n"
         "  for (int k = threadIdx.x; k < 128; k += blockDim.x) l1[k] = tb.l1[k];\n"
         "  __syncthreads();\n"
         "  const int j = blockIdx.x * blockDim.x + threadIdx.x;\n"),
        ("walk_outer(w, r, tb, tb.l1,", "walk_outer(w, r, tb, l1,"),
    ],
    "reversed_blocks": [(
        "const int j = blockIdx.x * blockDim.x + threadIdx.x;",
        "const int j = (gridDim.x - 1 - blockIdx.x) * blockDim.x + threadIdx.x;",
    )],
    "ray_in_registers": [
        ("  float ivx, ivy, ivz;\n};", "  float ivx, ivy, ivz;\n  float ox, oy, oz, dx, dy, dz;\n};"),
        ("r.ivx = rays[6 * m + i]; r.ivy = rays[7 * m + i]; r.ivz = rays[8 * m + i];",
         "r.ivx = rays[6 * m + i]; r.ivy = rays[7 * m + i]; r.ivz = rays[8 * m + i];\n"
         "  r.ox = rays[0 * m + i]; r.oy = rays[1 * m + i]; r.oz = rays[2 * m + i];\n"
         "  r.dx = rays[3 * m + i]; r.dy = rays[4 * m + i]; r.dz = rays[5 * m + i];"),
        ("const float ox = rays[0 * m + i], oy = rays[1 * m + i], oz = rays[2 * m + i];",
         "const float ox = r.ox, oy = r.oy, oz = r.oz;"),
        ("const float dx = rays[3 * m + i], dy = rays[4 * m + i], dz = rays[5 * m + i];",
         "const float dx = r.dx, dy = r.dy, dz = r.dz;"),
        ("const float ivx = rays[6 * m + i], ivy = rays[7 * m + i], ivz = rays[8 * m + i];",
         "const float ivx = r.ivx, ivy = r.ivy, ivz = r.ivz;"),
    ],
    # The step into another region switches the row and, in an occupied
    # region, is tested at once as the next iteration's first attempt
    # (the same step, the same budgets).
    "region_change_folded": [(
        "      if (nd != w.dom) {\n"
        "        w.dom = nd;\n"
        "        occupied = l1_bit(nd);\n"
        "        row = row_of(tb, nd);\n"
        "        ++it;\n"
        "        break;\n"
        "      }\n",
        "      if (nd != w.dom) {\n"
        "        w.dom = nd;\n"
        "        occupied = l1_bit(nd);\n"
        "        row = row_of(tb, nd);\n"
        "        ++it;\n"
        "        if (it >= max_iters || !occupied) break;\n"
        "        k = 0;\n"
        "      }\n",
    )],
    # The word of the step after this one (known once this step is) is
    # loaded before this step's bit test; the next attempt uses it unless
    # the row changed (a new region leaves the cube-step loop).
    "row_word_ahead": [
        ("    // ---- cube steps within the current region ----\n    for (int k = 0;;) {",
         "    // ---- cube steps within the current region ----\n    bool have_next = false;\n"
         "    uint32_t next_word = 0;\n    for (int k = 0;;) {"),
        ("      test_word_and_commit(w, r, s, row[local >> 5], local, HIT_OUTER);",
         "      const uint32_t word = have_next ? next_word : row[local >> 5];\n"
         "      {\n"
         "        Walk a = w;\n"
         "        a.cx = s.nx; a.cy = s.ny; a.cz = s.nz;\n"
         "        a.tmx = s.utx; a.tmy = s.uty; a.tmz = s.utz;\n"
         "        const Step s2 = step_of(a, r, tdx, tdy, tdz);\n"
         "        next_word = row[((((s2.nx & 15) << 8) | ((s2.ny & 15) << 4) | (s2.nz & 15)) >> 5)];\n"
         "        have_next = true;\n"
         "      }\n"
         "      test_word_and_commit(w, r, s, word, local, HIT_OUTER);"),
    ],
}


def variant_source(name: str, src: str) -> str:
    """The committed source with `VARIANTS[name]` applied."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {src.count(old)} times in trace_v1.cu")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """nvcc for every variant, one process each, all started together.
    Returns name → (library path, ptxas register and spill lines)."""
    from aic_tpu_torch import kernels

    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / "trace_v1.cu").read_text()
    jobs = {}
    for name in names:
        cu = out_dir / f"trace_v1_{name}.cu"
        cu.write_text(variant_source(name, src))
        so = out_dir / f"libtrace_v1_{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        built[name] = (so, [ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                            if "Used " in ln or "spill stores" in ln])
    return built


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the variants run only on one")
    import chip_smoke
    from aic_tpu_torch.content import atrium, plaza
    from aic_tpu_torch.light import evaluate_light_dense
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import GraphicsOptions, render
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    built = build_variants(VARIANTS)
    for name, (_, ptxas) in built.items():
        print(f"build {name}: {ptxas}", flush=True)
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).aic_trace_v1
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    # The states: a warm plaza640 frame's four launches, the atrium's first.
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    states = []
    sp = plaza()
    cam = default_camera(sp, 1920, 1080, opts)
    plaza_state, _ = evaluate_light_dense(sp.snapshot(device=dev))
    render(plaza_state, cam)
    for r, rec in enumerate(chip_smoke.v1_frame_launches(lambda: render(plaza_state, cam)), 1):
        states.append((f"plaza640 round {r}", rec["rays"], rec["st"], rec["ctx"], rec["idx"]))
    sp = atrium()
    st = sp.snapshot(device=dev)
    o, d = chip_smoke._local_rays(st, *default_camera(sp, 1920, 1080, opts).pixel_rays(device=dev))
    ctx = v1.get_bitmask_ctx(st)
    rays, s2, _ = tk.initial_state(st, o, d, ctx)
    states.append(("atrium 1920x1080", tk.PackedRays.pack(rays),
                   tk.pack_fields(v1.initial_state_v1(s2), v1.STATE_FIELDS, v1.FLOAT_FIELDS), ctx, None))

    real = v1._fn
    results = {}
    try:
        for label, rays, st_in, ctx, idx in states:
            n = st_in.shape[1] if idx is None else idx.numel()

            def run(idx=idx, rays=rays, st_in=st_in, ctx=ctx):
                return v1.launch(rays, st_in, ctx, idx)

            v1._fn = lambda: fns["committed"]
            want = run()
            times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    v1._fn = lambda name=name: fns[name]
                    if not torch.equal(run(), want):
                        sys.exit(f"variant {name} differs from the committed kernel on {label}")
                    times[name].append(round(chip_smoke.launch_ms(run, args.reps), 4))
            results[label] = times
            print(f"{label}, {n} rays (launch only, ms, two passes): {json.dumps(times)}", flush=True)
    finally:
        v1._fn = real
    print(json.dumps({"device": smi, "launch_ms": results}))


if __name__ == "__main__":
    main()
