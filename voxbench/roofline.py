"""The yardstick of the kernels' roofline shares: peaks of the card, and
the bytes each kernel's work needs, counted from shapes alone.

No count comes from the program's plain twins, its walks or its compiled
code, so a count stays the same whatever implements the kernel: a
roofline share over 100% means the time left out part of the work.
"""

from __future__ import annotations

#: One NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bandwidth in bytes/s.
PEAK_BYTES_PER_S = 3.35e12

#: A cube relit: its packed light read and written (4 B each) and its
#: block index read (4 B).
RELIT_CUBE_BYTES = 12


def relight_bytes(cubes_relit: int) -> int:
    """The least the relight moves: each relit cube's light in and out and
    its block read once."""
    return cubes_relit * RELIT_CUBE_BYTES


def share_pct(bytes_moved: float, device_s: float) -> float | None:
    """The least time over the device time, in %; None without device time."""
    if device_s <= 0.0:
        return None
    return bytes_moved / PEAK_BYTES_PER_S / device_s * 100.0
