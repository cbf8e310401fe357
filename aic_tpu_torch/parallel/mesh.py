"""Multi-GPU ranks: row-sharded trace and the process group they share.

Port of `aic_tpu/parallel/mesh.py`. The JAX package is SPMD over a
`jax.sharding.Mesh`, with XLA partitioning the arrays; the port follows
PyTorch's idiom, SPMD over `torch.distributed`: each rank is a process
with its own device, every rank calls the same functions on its own
share, and the collectives of `comm.py` join them.

- the trace is data-parallel over pixels (the reference's rayon
  par-iter over pixel rows, renderer.rs:543): each rank traces a block of
  rows against the whole state, and the frame is all-gathered;
- the relight pass is data-parallel over chart rays
  (`light.dense.relight_all_pass_sharded`);
- the world can be split in X slabs (`slab.py`).

`spawn` starts the ranks of one mesh: processes made by the `spawn`
start method, joined through a file store in a temporary directory, so
no port is ever fixed.
"""

from __future__ import annotations

import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..space.state import SpaceState
from . import comm


@dataclass(frozen=True)
class Mesh:
    """This process's place in the group of ranks: its rank, the world
    size, its device and the transport of `comm.py` ("nccl", "gloo", or
    None for one process without a group)."""

    rank: int
    world: int
    device: torch.device
    transport: str | None


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of this process's group (`aic_tpu` mesh.py:31).

    It raises when the group has another number of ranks than
    `n_devices`: a silently smaller mesh would make the sharding tests
    vacuous. Outside a group it is a mesh of one. Over NCCL rank r runs
    on card r and it raises where there are fewer cards than ranks (NCCL
    refuses two ranks on one card; the gloo transport stages through the
    host instead). Over gloo, or without a group, the ranks run on
    `device`, the card unless the caller asks for the CPU."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"requested a {n_devices}-rank mesh but this process is in no process group "
                "(start the ranks with parallel.spawn); a silently-smaller mesh would make "
                "sharding tests vacuous"
            )
        return Mesh(0, 1, torch.device(device or "cuda"), None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(
            f"requested a {n_devices}-rank mesh but the process group has {world} rank(s); "
            "a silently-smaller mesh would make sharding tests vacuous"
        )
    transport = dist.get_backend()
    if transport == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {world} ranks, {cards} card(s) (NCCL refuses two ranks "
                "on one card; the gloo transport stages through the host)"
            )
        dev = torch.device("cuda", rank)
        if device is not None and torch.device(device) not in (dev, torch.device("cuda")):
            raise RuntimeError(f"NCCL rank {rank} runs on {dev}, not {device}")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device or "cuda")
    return Mesh(rank, world, dev, transport)


def replicate(state, mesh: Mesh):
    """The state on this rank's device (`aic_tpu` mesh.py:45): every rank
    holds the whole of it."""
    return state.to(mesh.device)


def trace_rays_sharded(
    state: SpaceState,
    origins: torch.Tensor,
    directions: torch.Tensor,
    options,
    mesh: Mesh,
    include_sky: bool = True,
):
    """Trace with the rays' leading axis split over the ranks (`aic_tpu`
    mesh.py:50). Every rank passes the whole of `origins` / `directions`
    (N, ..., 3), N divisible by the world size, and the whole state; rank
    r traces rows [r·N/w, (r+1)·N/w) with the general tracer
    (`raytrace/tracer.py::trace_rays`) and the frame is all-gathered.
    Returns (light, transmittance) on every rank. Each ray's result is
    its own, so the frame is the unsharded one wherever the blocks keep
    the tracer's beam tiles whole (`render_sharded` makes them so)."""
    from ..raytrace.tracer import trace_rays

    n = origins.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    rows = n // mesh.world
    block = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    state = replicate(state, mesh)
    light, trans = trace_rays(state, origins[block].to(mesh.device), directions[block].to(mesh.device),
                              options, include_sky=include_sky)
    light = comm.all_gather(light, mesh)
    trans = comm.all_gather(trans, mesh)
    return light.reshape((n,) + tuple(light.shape[2:])), trans.reshape((n,) + tuple(trans.shape[2:]))


#: Rows of the general tracer's beam tile (`tracer.trace_rays`'s
#: `beam_tile`): a rank's block of rows is a whole number of them.
BEAM_ROWS = 8


def render_sharded(state: SpaceState, camera, mesh: Mesh):
    """A full frame with its rows split over the ranks (`aic_tpu`
    mesh.py:69): the rows are padded with copies of the last (edge
    padding, as there) to a whole number of beam tiles on every rank, so
    each tile of the frame is traced whole, as the unsharded trace traces
    it. Returns (light, transmittance) [H, W] on every rank."""
    origins, directions = camera.pixel_rays(device=mesh.device)
    h = origins.shape[0]
    step = BEAM_ROWS * mesh.world
    pad = (-h) % step
    if pad:
        origins = torch.cat([origins, origins[-1:].expand(pad, -1, -1)])
        directions = torch.cat([directions, directions[-1:].expand(pad, -1, -1)])
    light, trans = trace_rays_sharded(state, origins, directions, camera.options, mesh)
    return light[:h], trans[:h]


def _host(obj):
    """`obj` with every tensor in it (through dicts, lists and tuples)
    turned into a numpy array, to cross a process boundary by value."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, device, transport, store, args, threads, results):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(transport, init_method=f"file://{store}", rank=rank, world_size=world)
        mesh = make_mesh(world, device=device)
        results.put((rank, True, _host(fn(mesh, *args))))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, device, transport: str, args=(), threads: int = 1, timeout: float = 1800.0) -> list:
    """Run `fn(mesh, *args)` on `world` ranks, each a process started by
    the `spawn` method, over `transport` ("nccl": one card per rank;
    "gloo": ranks on `device`), and return the ranks' results in rank
    order, every tensor in them as a numpy array. `fn` must be importable
    by name (a module-level function), as must whatever `args` hold; CPU
    tensors in `args` reach the ranks through shared memory. Each rank
    uses `threads` CPU threads. The ranks meet through a file store in a
    fresh temporary directory. A rank that raises or dies, or a run past
    `timeout` seconds, raises here after every rank has been stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="aic_ranks_")
    store = os.path.join(tmp, "store")
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world, device, transport, store, args, threads, results),
                    daemon=True)
        for r in range(world)
    ]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited ({[procs[r].exitcode for r in dead]}) "
                                       "without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


