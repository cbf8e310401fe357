"""Entry points: a one-card traced frame, and the multi-GPU dry run.

Port of the repo root's `__graft_entry__.py`. `entry` gives a function
and its example tensors (a frame of the flagship scene through the
general tracer); `dryrun_multichip(n)` starts n ranks (`parallel.spawn`)
and runs, on each, one step of every multi-rank path: a ray-split relight
pass, a queue round, a body step, a row-sharded trace, then a slab-sharded
world's relight pass and composited trace. The JAX version re-executes
itself in a subprocess to leave a TPU plugin behind; the ranks here are
fresh processes already.

Everything runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _flagship_scene(device="cuda"):
    """Cornell box 16, snapshotted on `device`, and a 64×64 camera."""
    from .content import cornell_box
    from .raytrace import Camera, GraphicsOptions, Viewport

    space = cornell_box(16)
    state = space.snapshot(device=device)
    options = GraphicsOptions(lighting_display="flat", fog="none", transparency="surface")
    camera = Camera(options, Viewport(64, 64))
    camera.look_at(np.array([0.5, 0.5, 1.6]) * 16, (8, 8, 8))
    return state, camera, options


def entry(device="cuda"):
    """(fn, example_args): a raytraced frame of the flagship scene (the
    general tracer: two-level DDA and packed-light shading)."""
    from .raytrace.tracer import trace_rays

    state, camera, options = _flagship_scene(device)
    origins, directions = camera.pixel_rays(device=device)

    def fn(state, origins, directions):
        light, _trans = trace_rays(state, origins, directions, options)
        return light

    return fn, (state, origins, directions)


def dryrun_multichip(n_devices: int, device="cuda", transport: str = "nccl") -> list:
    """Run `_dryrun_multichip_impl` on `n_devices` ranks over `transport`
    ("nccl": one card per rank; "gloo": every rank on `device`, staged
    through the host). Returns each rank's kernel launch counts."""
    from .parallel import spawn

    return spawn(_dryrun_multichip_impl, n_devices, device, transport)


def launch_counts() -> dict:
    """This process's launches of the CUDA kernels, by kernel."""
    from .light import relight_kernel as rk
    from .raytrace import trace_kernel as tk
    from .raytrace import trace_kernel_v1 as v1

    return {"relight_pass": rk.LAUNCHES, "relight_pass_dyn": rk.LAUNCHES_DYN,
            "relight_batch": rk.LAUNCHES_LISTED, "trace_megakernel": tk.LAUNCHES, "trace_v1": v1.LAUNCHES}


def _dryrun_multichip_impl(mesh) -> dict:
    """One step of every multi-rank path on this rank of `mesh`, at tiny
    shapes: the flagship scene replicated, a ray-split relight pass
    (all-reduced), a queue round of batch 8·n, a step of n bodies and a
    trace of one row of pixels per rank (all-gathered); then a
    (4n, 8, 8) world split in slabs of 4 with light distance 5 (a halo of
    6 > 4 planes: two hops), one slab relight pass and one composited
    slab trace. Every result is checked finite. Returns the rank's kernel
    launch counts."""
    import torch

    from . import block
    from .light.dense import build_relight_ctx, relight_all_pass_sharded
    from .light.update import light_update_round
    from .math.grid import GridAab
    from .parallel import trace_rays_sharded
    from .parallel.slab import relight_pass_slab, shard_space, trace_rays_slab
    from .physics import Body, step_bodies
    from .space import Sky, Space, SpacePhysics

    n = mesh.world
    dev = mesh.device
    state, camera, options = _flagship_scene(dev)
    origins, directions = camera.pixel_rays(device=dev)
    # Tiny shapes: one row of pixels per rank.
    origins = origins[0:1].expand((n,) + tuple(origins.shape[1:]))
    directions = directions[0:1].expand((n,) + tuple(directions.shape[1:]))
    bodies = Body.stack([Body.make(position=(8.0, 8.0, 8.0), device=dev) for _ in range(n)])

    new_light = relight_all_pass_sharded(state, build_relight_ctx(state), mesh)
    state = dataclasses.replace(state, light=new_light)
    state, _stats = light_update_round(state, batch_size=8 * n)
    bodies, _info = step_bodies(state, bodies, 1.0 / 60.0, (0.0, -20.0, 0.0))
    light, _trans = trace_rays_sharded(state, origins, directions, options, mesh)
    if not (torch.isfinite(light).all() and torch.isfinite(bodies.position).all()):
        raise RuntimeError("dry run: the replicated step gave non-finite values")

    # The slab-sharded world: contents and light split in X slabs.
    sp = Space(GridAab.from_lower_size((0, 0, 0), (4 * n, 8, 8)),
               physics=SpacePhysics(sky=Sky.uniform((0.6, 0.7, 0.9)), light_max_distance=5))
    sp.fill(GridAab.from_lower_size((0, 0, 0), (4 * n, 1, 8)), block.from_color((0.5, 0.5, 0.4, 1.0)))
    for x in range(2, 4 * n, 4):
        sp.set((x, 1, 4), block.from_color((0.9, 0.2, 0.2, 1.0)))
    sh = shard_space(sp.snapshot(device="cpu"), mesh)
    relight_pass_slab(sh)  # halo of 6 > slab of 4: two hops
    eye = np.array([2.0 * n, 6.0, -6.0], np.float32)
    o = np.broadcast_to(eye, (n * 2, 3)).copy()
    d = np.stack([np.array([np.cos(a), -0.4, np.sin(a)], np.float32) for a in np.linspace(0.5, 2.6, n * 2)])
    light, trans = trace_rays_slab(sh, torch.as_tensor(o), torch.as_tensor(d), options)
    if not (torch.isfinite(light).all() and torch.isfinite(trans).all()):
        raise RuntimeError("dry run: the slab trace gave non-finite values")
    return launch_counts()
