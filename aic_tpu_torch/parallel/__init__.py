"""Multi-GPU parallelism: SPMD over `torch.distributed` (port of
`aic_tpu/parallel`, SPMD over a `jax.sharding.Mesh`)."""

from .mesh import Mesh, make_mesh, render_sharded, replicate, spawn, trace_rays_sharded

__all__ = ["Mesh", "make_mesh", "render_sharded", "replicate", "spawn", "trace_rays_sharded"]
