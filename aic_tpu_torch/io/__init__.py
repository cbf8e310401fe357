"""Layer 5: input/output (port of `aic_tpu/io`; only provenance so far)."""
