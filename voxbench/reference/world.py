"""A saved world as the reference light reads it: the cube grid and, per
palette entry, what the light equation needs of a block (visibility,
opacity by face, face colours, mean opacity, emission), with the sky's
light by face and the light's maximum distance.

The blocks are decoded by the copied loader and evaluation in
`reference/plain/`; nothing here is taken from the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .plain.io import load_space


@dataclass
class World:
    contents: torch.Tensor  # i64[X,Y,Z] palette index of each cube
    max_distance: int
    visible: np.ndarray  # bool[P]
    opaque: np.ndarray  # bool[P,6] opaque by face
    face_rgba: np.ndarray  # f32[P,6,4]
    mean_alpha: np.ndarray  # f32[P] opacity of the block's mean colour, clamped to [0, 1]
    emission: np.ndarray  # f32[P,3]
    sky_faces: np.ndarray  # f32[6,3] the sky's light on each face of the world
    palette_len: int
    _on: dict = field(default_factory=dict, repr=False)

    def tables(self, device) -> dict:
        """The per-block tables as tensors on `device`, made once."""
        key = str(torch.device(device))
        if key not in self._on:
            t = {k: torch.as_tensor(getattr(self, k), device=device)
                 for k in ("visible", "opaque", "face_rgba", "mean_alpha", "emission", "sky_faces")}
            self._on[key] = t
        return self._on[key]

    def with_contents(self, contents: torch.Tensor) -> "World":
        """The same world with another cube grid (an edit applied)."""
        return World(contents, self.max_distance, self.visible, self.opaque, self.face_rgba,
                     self.mean_alpha, self.emission, self.sky_faces, self.palette_len, self._on)


def load(path, space: str = "world") -> World:
    sp = load_space(str(path), space)
    evs = [sp.evaluated(i) for i in range(sp.palette_len())]
    return World(
        contents=torch.as_tensor(sp.contents.astype(np.int64)),
        max_distance=int(sp.physics.light_max_distance),
        visible=np.array([ev.visible_or_animated() for ev in evs], bool),
        opaque=np.array([np.asarray(ev.opaque, bool) for ev in evs]).reshape(-1, 6),
        face_rgba=np.array([ev.face_colors for ev in evs], np.float32).reshape(-1, 6, 4),
        mean_alpha=np.clip(np.array([ev.color[3] for ev in evs], np.float32), 0.0, 1.0),
        emission=np.array([ev.light_emission for ev in evs], np.float32).reshape(-1, 3),
        sky_faces=np.asarray(sp.physics.sky.block_sky_faces(), np.float32),
        palette_len=sp.palette_len(),
    )
