"""Persistent settings store (reference: all-is-cubes-ui/src/settings.rs).

Copied unchanged from `aic_tpu/apps/settings.py` (host Python over the
port's `GraphicsOptions`).

Layered like the reference: a `Settings` holds a `GraphicsOptions`, may
inherit from a parent (fall through for unset values), and persists to a
JSON file (settings/serialize.rs). Unknown keys in the file are ignored
(forward compatibility); values are validated through
`GraphicsOptions.repair()` on load.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from ..raytrace.options import GraphicsOptions


class Settings:
    def __init__(
        self,
        options: Optional[GraphicsOptions] = None,
        parent: Optional["Settings"] = None,
        path: Optional[str] = None,
    ):
        self.parent = parent
        self.path = path
        self._overrides: dict = {}
        if options is not None:
            base = GraphicsOptions()
            for f in dataclasses.fields(GraphicsOptions):
                v = getattr(options, f.name)
                if v != getattr(base, f.name):
                    self._overrides[f.name] = v

    def graphics_options(self) -> GraphicsOptions:
        """Effective options: parent chain + local overrides."""
        base = (
            self.parent.graphics_options() if self.parent else GraphicsOptions()
        )
        return dataclasses.replace(base, **self._overrides).repair()

    def set(self, **kw):
        """Override one or more option fields (settings.rs mutation API)."""
        valid = {f.name for f in dataclasses.fields(GraphicsOptions)}
        for k, v in kw.items():
            if k not in valid:
                raise KeyError(f"unknown graphics option {k!r}")
            self._overrides[k] = v
        if self.path:
            self.save()

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            raise ValueError("no settings path configured")
        payload = {"version": 1, "graphics_options": self._overrides}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    @staticmethod
    def load(path: str, parent: Optional["Settings"] = None) -> "Settings":
        s = Settings(parent=parent, path=path)
        if os.path.exists(path):
            with open(path) as f:
                payload = json.load(f)
            valid = {f.name for f in dataclasses.fields(GraphicsOptions)}
            raw = payload.get("graphics_options", {})
            s._overrides = {k: v for k, v in raw.items() if k in valid}
            # Validate by constructing + repairing once.
            s._overrides = {
                k: getattr(
                    dataclasses.replace(GraphicsOptions(), **s._overrides).repair(), k
                )
                for k in s._overrides
            }
        return s
