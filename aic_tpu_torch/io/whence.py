"""Universe provenance: where a universe came from, and save-back.

Port of `aic_tpu/io/whence.py`, the role of the reference's
`WhenceUniverse` trait (all-is-cubes/src/save/whence.rs:20): every
`Universe` carries a `whence` describing its storage origin — a window
title / document name, whether it can be (re)loaded or saved, and how.
Freshly created or procedurally generated universes carry `NoWhence`
(whence.rs:72 `impl WhenceUniverse for ()`); universes opened from disk
carry a `FileWhence` that saves back to the same path in the same format
(the desktop's save-to-origin flow, all-is-cubes-desktop/src/startup.rs:177).

Format dispatch is by extension, matching the CLI/port layer
(all-is-cubes-port ExportFormat): `.vox` = MagicaVoxel, anything else =
the native versioned JSON (io/save.py). The reference's interchange
schema, `.alliscubesjson`, needs `io/import_ref.py`, which the port does
not have yet (ROADMAP A9(c)): both directions raise `NotImplementedError`
for it rather than write or read another format.
"""

from __future__ import annotations

import os

_REF_JSON = ".alliscubesjson"


def _no_reference_json(path: str):
    return NotImplementedError(
        f"{path}: the port cannot read or write .alliscubesjson yet: io/import_ref.py is "
        "still to be ported (ROADMAP A9(c))"
    )


class WhenceUniverse:
    """Abstract provenance (whence.rs:20). Default: nothing is possible."""

    def document_name(self) -> str | None:
        return None

    def can_load(self) -> bool:
        return False

    def can_save(self) -> bool:
        return False

    def load(self):
        raise ValueError(
            "this universe cannot be reloaded because it has no source"
        )

    def save(self, universe) -> None:
        raise ValueError(
            "this universe cannot be saved because it does not have an "
            "associated file"
        )


class NoWhence(WhenceUniverse):
    """Fresh / procedurally generated universe (whence.rs:72)."""

    def __repr__(self):
        return "NoWhence()"


class FileWhence(WhenceUniverse):
    """A universe loaded from (or destined for) a file path; `load` puts
    it on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, path: str, device="cuda"):
        self.path = os.fspath(path)
        self.device = device

    def __repr__(self):
        return f"FileWhence({self.path!r})"

    def document_name(self) -> str | None:
        return os.path.basename(self.path)

    def can_load(self) -> bool:
        return True

    def can_save(self) -> bool:
        # .vox export flattens to one space's voxels; still a save.
        return True

    def load(self):
        return load_universe_file(self.path, device=self.device)

    def save(self, universe) -> None:
        path = self.path
        if path.endswith(_REF_JSON):
            raise _no_reference_json(path)
        if path.endswith(".vox"):
            from .vox import export_vox

            sp = universe.spaces.get("world") or next(iter(universe.spaces.values()))
            export_vox(sp, path)
        else:
            from .save import save_universe

            save_universe(universe, path)


def load_universe_file(path: str, device="cuda"):
    """Load a universe from any supported on-disk format onto `device`
    (the card unless the caller asks for the CPU), with `whence` set so
    it saves back to its origin (startup.rs DocumentSource role)."""
    if path.endswith(_REF_JSON):
        raise _no_reference_json(path)
    if path.endswith(".vox"):
        from ..universe import Universe
        from .vox import import_vox

        u = Universe(device=device)
        for i, sp in enumerate(import_vox(path)):
            u.insert_space("world" if i == 0 else f"model{i}", sp)
    else:
        from .save import load_universe

        u = load_universe(path, device=device)
    u.whence = FileWhence(path, device=device)
    return u
