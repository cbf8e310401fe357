"""Test apparatus (reference: test-renderers image comparison harness).

Port of `aic_tpu/testing`: the image differ and goldens (`imagecmp`),
the f64 light oracle (`refmath`) and the transaction-law tester
(`txn_tester`), importing neither JAX nor an imaging library, so the
card's machine can hold the port's frames, light and transactions to
references `aic_tpu` made."""

from .imagecmp import Threshold, compare_to_golden, diff_images, images_match

__all__ = ["Threshold", "compare_to_golden", "diff_images", "images_match"]
