"""aic_tpu_torch — the PyTorch/CUDA port of `aic_tpu`, beside the JAX package.

The package mirrors `aic_tpu`'s layout so that each module's counterpart
is easy to find. It imports `torch` and numpy and never `jax`: host
content code (blocks, spaces, templates, the light chart) is carried as
jax-free copies, and every Pallas kernel on the ported path is a CUDA
kernel written for Hopper (`csrc/`), with a plain PyTorch twin beside it.

Ported so far: `Space.snapshot` → `evaluate_light_dense` → `render` of
a template (`python -m aic_tpu_torch.main --template atrium --graphics
record`) through every Pallas kernel of `aic_tpu`'s counterpart on the
card (the megakernel tracer, the v1 surface finder for worlds whose
megakernel tables exceed their budget, e.g. `plaza640`, and both
variants of the relight pass); the step loop (`Universe.step`, `--graphics
headless`); and every template but `menu`, demo-city and its exhibits
included.

- :mod:`aic_tpu_torch.math`     — faces, grids, raycast, chunking, light/color codecs
- :mod:`aic_tpu_torch.block`    — block model + host evaluation (copied)
- :mod:`aic_tpu_torch.space`    — Space, snapshot, the tensor SpaceState, drawing
- :mod:`aic_tpu_torch.content`  — the templates, demo-city and its exhibits
- :mod:`aic_tpu_torch.text`     — text masks (vendored table), system font, layout
- :mod:`aic_tpu_torch.vui`      — the widgets the exhibits draw
- :mod:`aic_tpu_torch.light`    — light chart, dense relight, light queue, relight kernel
- :mod:`aic_tpu_torch.universe` — universe, step loop, transactions, cursor tools
- :mod:`aic_tpu_torch.physics`  — body physics
- :mod:`aic_tpu_torch.raytrace` — camera, phase shader, trace kernels, render
"""

__version__ = "0.1.0"
