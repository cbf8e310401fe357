"""Functions that the multi-rank tests of the port run on each rank.

`aic_tpu_torch.parallel.spawn` starts every rank as a fresh process that
imports the function it runs by name, so these live in a module that
imports no JAX and nothing of `aic_tpu`: the ranks must run the port
alone. Each returns what its test compares, from rank 0 (the other ranks
return None), and whether JAX was imported in the rank.
"""

from __future__ import annotations

import sys

import torch

#: Seconds a test's world of ranks may run before `spawn` stops it and
#: raises: several times the slowest world's time under the whole suite,
#: so that a hung rank fails its test instead of holding the run.
RANKS_TIMEOUT = 300.0


def _jax_free() -> bool:
    return "jax" not in sys.modules and "aic_tpu" not in sys.modules


def slab_worker(mesh, worlds: dict, rays: dict, options: list, narrow):
    """For each light distance in `worlds` ({md: (state, lit state)}): the
    gathered light after one slab pass from the state's light, on every
    rank; the passes of `evaluate_light_slab` from the same light, the
    light it converged to and the slab-sharded trace of that world's
    "fans" rays under the lit `options` (all but the first); and the
    slab-sharded trace of the lit state on each set of `rays` ({name:
    (o, d)}) under each of `options`. Then `shard_space` on `narrow`, a
    state whose X the world size does not divide."""
    from aic_tpu_torch.parallel import slab

    out = {"jax_free": _jax_free(), "pass": {}, "passes": {}, "trace": {}, "relit": {}}
    for md, (state, lit) in worlds.items():
        sh = slab.shard_space(state, mesh)
        slab.relight_pass_slab(sh)
        out["pass"][md] = sh.gather().light
        sh = slab.shard_space(state, mesh)
        out["passes"][md] = slab.evaluate_light_slab(sh)
        out["relit"][md] = (sh.gather().light,) + tuple(
            slab.trace_rays_slab(sh, *rays["fans"], opts) for opts in options[1:])
        sh = slab.shard_space(lit, mesh)
        for name, (o, d) in rays.items():
            for i, opts in enumerate(options):
                out["trace"][md, name, i] = slab.trace_rays_slab(sh, o, d, opts)
    try:
        slab.shard_space(narrow, mesh)
        out["narrow"] = None
    except ValueError as e:
        out["narrow"] = str(e)
    return out if mesh.rank == 0 else None


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def parallel_worker(mesh, state, cameras: list, relight_state):
    """`make_mesh` asked for more ranks than the group has; `render_sharded`
    of `state` through each camera; one `relight_all_pass_sharded` of
    `relight_state`, with the rank's launches of K2 (none on the CPU)."""
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.parallel import comm, make_mesh, render_sharded

    out = {"jax_free": _jax_free()}
    # Each rank's slab of 3 planes of a known world, extended by a one-hop
    # and a two-hop halo; every rank's result gathered.
    local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 100 * (mesh.rank + 1)
    out["halos"] = {h: comm.all_gather(comm.halo_exchange(local, h, mesh), mesh) for h in (2, 5)}
    try:
        make_mesh(2 * mesh.world, device=mesh.device)
        out["overcommit"] = None
    except RuntimeError as e:
        out["overcommit"] = str(e)
    out["frames"] = [render_sharded(state, cam, mesh) for cam in cameras]
    ctx = dense.build_relight_ctx(relight_state)
    out["relight"] = dense.relight_all_pass_sharded(relight_state, ctx, mesh)
    out["launches"] = rk.LAUNCHES
    # Every rank holds the same light.
    out["ranks_agree"] = bool((comm.all_gather(out["relight"], mesh) == out["relight"]).all())
    return out if mesh.rank == 0 else None


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def slab_pass_worker(mesh, state):
    """One slab pass of `state`: the gathered light, and this rank's K2
    launches."""
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.parallel import slab

    sh = slab.shard_space(state, mesh)
    slab.relight_pass_slab(sh)
    return {"light": sh.gather().light, "launches": rk.LAUNCHES}
