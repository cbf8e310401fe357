"""Decoding a saved world: a copy of the port's loader and block evaluation.

Copied from `aic_tpu_torch` (the native save format's block and space
schemas, `Space`'s palette, block evaluation, the sky), cut to what
turns a world file into its blocks' evaluated attributes: faces,
colours, opacity and emission. It decodes the input and computes none
of what the benchmark compares: the light equation the check holds the
program to is written anew in `voxbench/reference/light.py`.

It imports nothing of `aic_tpu_torch`, `aic_tpu` or `jax`.
"""
