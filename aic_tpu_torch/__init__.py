"""aic_tpu_torch — the PyTorch/CUDA port of `aic_tpu`, beside the JAX package.

The package mirrors `aic_tpu`'s layout so that each module's counterpart
is easy to find. It imports `torch` and numpy and never `jax`: host
content code (blocks, spaces, templates, the light chart) is carried as
jax-free copies, and every Pallas kernel on the ported path is a CUDA
kernel written for Hopper (`csrc/`), with a plain PyTorch twin beside it.

Ported so far (two slices): `Space.snapshot` → `evaluate_light_dense`
→ `render` of a template, i.e. `python -m aic_tpu_torch.main --template
atrium --graphics record`, through every Pallas kernel of `aic_tpu`'s
counterpart on the card: the megakernel tracer, the v1 surface finder
(worlds whose megakernel tables exceed their budget, e.g. `plaza640`)
and both variants of the relight pass.

- :mod:`aic_tpu_torch.math`     — faces, grids, raycast, light/color codecs
- :mod:`aic_tpu_torch.block`    — block model + host evaluation (copied)
- :mod:`aic_tpu_torch.space`    — Space, snapshot and the tensor SpaceState
- :mod:`aic_tpu_torch.content`  — atrium, cornell-box and plaza640 templates
- :mod:`aic_tpu_torch.light`    — light chart, dense relight, relight kernel
- :mod:`aic_tpu_torch.raytrace` — camera, phase shader, trace kernels, render
"""

__version__ = "0.1.0"
