#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aic_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, nothing is caught):

1. device  — the card's name; `nvidia-smi` name and power limit.
2. build   — nvcc builds both kernels from `aic_tpu_torch/csrc/`.
3. kernels — each CUDA kernel against its plain PyTorch twin on the
   card: the relight pass (K2) on a small mixed scene, cornell-box 16 and
   the atrium, one pass and the over-relaxed loop to convergence; the
   traversal megakernel (K1) on small atom, voxel and R32 scenes and on
   the atrium at 1920×1080. Times at the atrium's shapes.
4. slice   — the main path at full size: atrium snapshot on the card,
   `evaluate_light_dense`, `render` at 1920×1080 with smooth lighting;
   launch counters, flaws, image checks, PNG under `aic_tpu_torch/_build/`.
5. the last line: {"ok": true, "device": {...}}.

Needs CUDA and the `aic_tpu_torch` package beside this file; imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Tolerances. K2: packed light within one log step (the codec's unit;
#: kernel and twin sum the same f32 terms in another order), status
#: equal. K1: integer fields equal, t-like fields within 1e-5·max(1,|t|).
RELIGHT_MAX_STEP = 1
TRACE_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


# -- scenes (built with the port's own content code) ------------------------


def relight_scene(pkg, size=(12, 12, 12), md=8, seed=0):
    """Emissive, opaque and transparent blocks over a floor, under a sky."""
    block, GridAab, Space, Sky, SpacePhysics = pkg
    sp = Space(
        GridAab.from_lower_size((0, 0, 0), size),
        physics=SpacePhysics(sky=Sky.uniform((0.6, 0.7, 0.9)), light_max_distance=md),
    )
    rng = np.random.RandomState(seed)
    blocks = [
        block.from_color((0.8, 0.3, 0.2, 1.0)),
        block.from_color((0.2, 0.8, 0.3, 0.5)),
        block.from_color((0.9, 0.9, 0.9, 1.0), emission=(2.0, 1.5, 1.0)),
    ]
    for _ in range(max(6, int(np.prod(size) * 0.02))):
        sp.set(tuple(int(rng.randint(0, s)) for s in size), blocks[rng.randint(3)])
    sp.fill(GridAab.from_lower_size((0, 0, 0), (size[0], 1, size[2])),
            block.from_color((0.5, 0.5, 0.5, 1.0)))
    return sp


def trace_scenes(pkg):
    """Atoms across region corners; R8/R4 voxel blocks; R32 blocks."""
    block, GridAab, Space, Sky, SpacePhysics = pkg
    atoms = Space(GridAab.cube(24), physics=SpacePhysics(sky=Sky.uniform((0.4, 0.5, 0.6))))
    rng = np.random.RandomState(7)
    colors = [(1.0, 0.1, 0.1, 1.0), (0.1, 1.0, 0.1, 0.45), (0.2, 0.2, 1.0, 1.0)]
    for i in range(40):
        atoms.set(tuple(int(v) for v in rng.randint(0, 24, 3)), block.from_color(colors[i % 3]))

    inner8 = Space(GridAab.cube(8))
    inner8.fill(GridAab.from_lower_size((0, 0, 0), (8, 4, 8)), block.from_color((1.0, 1.0, 0.0, 1.0)))
    inner8.set((3, 6, 3), block.from_color((1.0, 0.0, 1.0, 0.5)))
    inner4 = Space(GridAab.cube(4))
    for x in range(4):
        for z in range(4):
            if (x + z) % 2 == 0:
                inner4.set((x, 0, z), block.from_color((0.0, 0.8, 0.8, 1.0)))
    voxels = Space(GridAab.cube(20), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.3, 0.35))))
    for c in [(2, 2, 2), (9, 2, 9), (17, 3, 5), (5, 10, 15)]:
        voxels.set(c, block.Block(block.Recur(space=inner8, resolution=8)))
    for c in [(4, 2, 7), (12, 5, 12), (16, 16, 16)]:
        voxels.set(c, block.Block(block.Recur(space=inner4, resolution=4)))

    inner32 = Space(GridAab.cube(32))
    inner32.fill(GridAab.from_lower_size((0, 0, 0), (32, 6, 32)), block.from_color((0.9, 0.7, 0.2, 1.0)))
    for i in range(32):
        inner32.set((i, i, i), block.from_color((0.2, 0.4, 0.9, 1.0)))
    r32 = Space(GridAab.cube(20), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.32, 0.4))))
    for c in [(3, 2, 3), (10, 2, 12), (16, 8, 6)]:
        r32.set(c, block.Block(block.Recur(space=inner32, resolution=32)))
    r32.set((8, 2, 5), block.Block(block.Recur(space=inner8, resolution=8)))
    return {"atoms": atoms, "voxels": voxels, "r32": r32}


def random_rays(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# -- comparisons --------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` calls, after one warm-up call (the
    twins' large allocations otherwise land in the kernel's window)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_relight(state, label):
    """K2 against its plain twin on one state (seeded light). Returns
    (max abs error of incoming/total, kernel ms, plain ms)."""
    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light.refproc import fast_evaluate_seed
    from aic_tpu_torch.math import lightpack

    state, _ = fast_evaluate_seed(state)
    ctx = dense.build_relight_ctx(state)
    light_rgb = lightpack.decode_rgb(state.light).contiguous()
    args = (state.contents, light_rgb, state.tables.light_face_rows, ctx)
    inc_k, tot_k = rk.relight_pass_cuda(*args)
    inc_p, tot_p = rk.relight_pass_plain(*args)
    torch.cuda.synchronize()
    pk = dense._finish(ctx, inc_k + ctx.incoming0, tot_k).cpu().numpy().astype(np.int32)
    pp = dense._finish(ctx, inc_p + ctx.incoming0, tot_p).cpu().numpy().astype(np.int32)
    step = int(np.abs(pk[..., :3] - pp[..., :3]).max())
    if step > RELIGHT_MAX_STEP or not np.array_equal(pk[..., 3], pp[..., 3]):
        fail(f"relight kernel vs plain on {label}: {step} packed steps, "
             f"status equal {np.array_equal(pk[..., 3], pp[..., 3])}")
    err = max(float((inc_k - inc_p).abs().max()), float((tot_k - tot_p).abs().max()))
    ms_k = cuda_ms(lambda: rk.relight_pass_cuda(*args), 20)
    ms_p = cuda_ms(lambda: rk.relight_pass_plain(*args), 2)
    phase("kernels", f"relight {label} {tuple(state.contents.shape)}: packed diff {step} "
          f"status equal, max abs err {err:.3e}, kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")
    return err, ms_k, ms_p


def compare_converge(space, label, dev):
    """The main path's relight on the card (`evaluate_light_dense`: the
    seed, then passes over-relaxed with w = OVERRELAX until the plain
    pass moves no cube by more than one step) against the same loop with
    the kernel's plain twin as the pass: passes within one, packed light
    within one step, statuses equal."""
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk

    got, passes = dense.evaluate_light_dense(space.snapshot(device=dev))
    kernel_pass = dense.relight_pass
    dense.relight_pass = rk.relight_pass_plain
    try:
        want, want_passes = dense.evaluate_light_dense(space.snapshot(device=dev))
    finally:
        dense.relight_pass = kernel_pass
    a = got.light.cpu().numpy().astype(np.int32)
    b = want.light.cpu().numpy().astype(np.int32)
    step = int(np.abs(a[..., :3] - b[..., :3]).max())
    status_equal = np.array_equal(a[..., 3], b[..., 3])
    if abs(passes - want_passes) > 1 or step > RELIGHT_MAX_STEP or not status_equal:
        fail(f"converged relight on {label}: {passes} passes vs plain {want_passes}, "
             f"{step} packed steps, status equal {status_equal}")
    phase("kernels", f"relight converged {label} (w={dense.OVERRELAX}): {passes} passes "
          f"(plain {want_passes}), packed diff {step}, status equal")


def compare_trace(state, o, d, label):
    """K1 against its plain twin from the phase-1 launch state. Returns
    (max abs error of the float fields, kernel ms, plain ms)."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk

    ctx = tk.get_bitmask_ctx2(state)
    dev = state.device
    lower = torch.as_tensor(state.lower, dtype=torch.float32, device=dev)
    o = torch.as_tensor(o, device=dev).reshape(-1, 3) - lower
    d = torch.as_tensor(d, device=dev).reshape(-1, 3)
    rays, st, _ = tk.initial_state(state, o.contiguous(), d.contiguous(), ctx)
    out_k = tk.megakernel_cuda(rays, st, ctx)
    out_p = tk.megakernel_plain(rays, st, ctx)
    torch.cuda.synchronize()
    if bool((out_p["mode"] != tk.MODE_DONE).any()):
        fail(f"trace {label}: plain megakernel left rays walking after {tk.MAX_ITERS} iterations")
    err = 0.0
    for k in tk.STATE_FIELDS:
        a, b = out_k[k], out_p[k]
        if k in tk.FLOAT_FIELDS:
            both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
            diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
            lim = TRACE_RTOL * torch.clamp(b.abs(), min=1.0)
            if bool((diff > lim).any()):
                fail(f"trace {label}: field {k} differs in {int((diff > lim).sum())} rays")
            err = max(err, float(diff.max()))
        elif not torch.equal(a, b):
            fail(f"trace {label}: field {k} differs in {int((a != b).sum())} rays")
    ms_k = cuda_ms(lambda: tk.megakernel_cuda(rays, st, ctx), 20)
    ms_p = cuda_ms(lambda: tk.megakernel_plain(rays, st, ctx), 2)
    phase("kernels", f"trace {label} {o.shape[0]} rays: 28 fields agree, max abs err "
          f"{err:.3e}, kernel {ms_k:.3f} ms plain {ms_p:.3f} ms")
    return err, ms_k, ms_p


def main() -> None:
    sys.path.insert(0, HERE)
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        import aic_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the aic_tpu_torch package is not beside chip_smoke.py ({e})")
    from aic_tpu_torch import block, kernels
    from aic_tpu_torch.content import atrium, cornell_box
    from aic_tpu_torch.light import evaluate_light_dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.math.grid import GridAab
    from aic_tpu_torch.raytrace import GraphicsOptions, render, save_png
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.space import Sky, Space, SpacePhysics

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    for name in ("relight", "trace"):
        kernels.load_library(name)
    regs = {
        n: [ln.strip() for ln in info[1].splitlines() if "registers" in ln]
        for n, info in kernels.BUILD_INFO.items()
    }
    phase("build", f"relight + trace built in {time.perf_counter() - t0:.1f} s; ptxas: {regs}")

    # 3. kernels against their plain twins
    pkg = (block, GridAab, Space, Sky, SpacePhysics)
    small = {"mixed 12^3": relight_scene(pkg), "cornell-box 16": cornell_box(16)}
    for label, sp in small.items():
        compare_relight(sp.snapshot(device=dev), label)
    for label, sp in trace_scenes(pkg).items():
        o, d = random_rays(4096, -4.0, 24.0, seed=len(label))
        compare_trace(sp.snapshot(device=dev), o, d, label)

    atrium_space = atrium()
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    cam = default_camera(atrium_space, 1920, 1080, opts)
    atrium_state = atrium_space.snapshot(device=dev)
    relight_err, relight_ms, relight_plain_ms = compare_relight(atrium_state, "atrium")
    for label, sp in dict(small, atrium=atrium_space).items():
        compare_converge(sp, label, dev)
    o, d = cam.pixel_rays(device=dev)
    trace_err, trace_ms, trace_plain_ms = compare_trace(atrium_state, o, d, "atrium 1920x1080")

    # 4. the slice at full size, through the kernels
    state = atrium_space.snapshot(device=dev)
    if tuple(state.contents.shape) != (60, 35, 40):
        fail(f"atrium is {tuple(state.contents.shape)}, expected (60, 35, 40)")
    rk.LAUNCHES = 0
    tk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, passes = evaluate_light_dense(state)
    torch.cuda.synchronize()
    relight_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = render(state, cam)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"relight": rk.LAUNCHES, "trace": tk.LAUNCHES}
    phase("slice", f"atrium {tuple(state.contents.shape)} relit in {passes} passes, "
          f"{relight_s:.3f} s; first 1920x1080 frame {first_ms:.1f} ms; launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    if frame.flaws:
        fail(f"render flaws {frame.flaws}")
    img = frame.data
    if img.shape != (1080, 1920, 4):
        fail(f"image shape {img.shape}")
    lit = state.light.cpu().numpy()
    if not (lit[..., 3] == 255).any():
        fail("relight left no visible light")
    if img[..., :3].reshape(-1, 3).std(0).max() == 0:
        fail("the image is constant")
    coverage = float((img[..., 3] > 0).mean())
    if coverage <= 0.5:
        fail(f"alpha coverage {coverage:.3f} <= 0.5")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        frame = render(state, cam)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / reps
    out_png = os.path.join(HERE, "aic_tpu_torch", "_build", "atrium_1080p.png")
    save_png(frame, out_png)
    phase("slice", f"atrium 1920x1080 smoothstep: {frame_ms:.1f} ms/frame warm "
          f"({1920 * 1080 / frame_ms / 1e3:.2f} Mrays/s), alpha coverage {coverage:.3f}, "
          f"wrote {os.path.relpath(out_png, HERE)}")

    print(json.dumps({"kernels": [
        {"name": "trace_megakernel", "route": "cuda",
         "source": "aic_tpu_torch/csrc/trace.cu",
         "replaces": "aic_tpu/raytrace/pallas_trace.py:1140",
         "launches": launches["trace"], "max_abs_err": trace_err,
         "ms": trace_ms, "plain_ms": trace_plain_ms},
        {"name": "relight_pass", "route": "cuda",
         "source": "aic_tpu_torch/csrc/relight.cu",
         "replaces": "aic_tpu/light/pallas_relight.py:338",
         "launches": launches["relight"], "max_abs_err": relight_err,
         "ms": relight_ms, "plain_ms": relight_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
