"""Universe provenance: where a universe came from.

The part of `aic_tpu/io/whence.py` that the `Universe` constructor needs
(the reference's `WhenceUniverse`, save/whence.rs:20): a fresh or
procedurally generated universe carries `NoWhence`. File provenance and
save/load come with the port's IO (ROADMAP A9).
"""

from __future__ import annotations


class NoWhence:
    """Fresh / procedurally generated universe (whence.rs:72): it has no
    source to reload and no file to save to."""

    def __repr__(self):
        return "NoWhence()"
