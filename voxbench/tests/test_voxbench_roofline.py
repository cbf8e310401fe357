"""The roofline counts, from shapes alone, small enough to count by hand."""

import pytest

from voxbench import roofline


def test_relight_bytes_and_share():
    # 10 cubes relit: light in and out, block index in: 12 B each.
    assert roofline.relight_bytes(10) == 120
    # 3.35 GB at 3.35 TB/s is 1 ms: in 2 ms, 50% of the roofline.
    assert roofline.share_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None
