"""Record-mode camera scripts (all-is-cubes-desktop/src/record/script.rs).

Port of `aic_tpu/apps/record_script.py`. `Performance.step` writes the
character's body on the bodies' device through `apps/session.py`'s
`set_body_row` (one copy to the card); the rest is host numpy, as in
`aic_tpu`.

A `CameraScript` is glTF-style keyframe animation data: per channel
(`position`, `look_direction`) a list of timestamps and values, sampled
with linear interpolation (script.rs `Data<T>`/`Lerp`). `Performance` is
the behavior that makes a Character follow the script during fixed-clock
record stepping (script.rs `Performance: Behavior<Character>`); the
record frontend can also sample the script directly per frame for
camera-only flights.

JSON format (matches the reference's serde shape):

    {"position":       {"times": [0.0, 2.0], "values": [[x,y,z], ...]},
     "look_direction": {"times": [0.0],      "values": [[dx,dy,dz]]}}
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..universe.universe import Behavior


@dataclasses.dataclass
class _Channel:
    """script.rs `Data<T>`: keyframe times + values, lerp sampled."""

    times: np.ndarray  # f64[K], non-decreasing
    values: np.ndarray  # f64[K, 3]

    @classmethod
    def from_dict(cls, d: dict | None) -> "_Channel | None":
        if not d or not d.get("times"):
            return None
        times = np.asarray(d["times"], np.float64)
        values = np.asarray(d["values"], np.float64)
        if times.ndim != 1 or values.shape != (times.shape[0], 3):
            raise ValueError("script channel: times [K] and values [K,3] required")
        if (np.diff(times) < 0).any():
            raise ValueError("script channel: times must be non-decreasing")
        return cls(times=times, values=values)

    def get(self, t: float) -> np.ndarray:
        """Sample at time t (clamped to the keyframe range; script.rs
        `Data::get` semantics — constant extrapolation at the ends)."""
        times, values = self.times, self.values
        if t <= times[0]:
            return values[0]
        if t >= times[-1]:
            return values[-1]
        i = int(np.searchsorted(times, t, side="right")) - 1
        t0, t1 = times[i], times[i + 1]
        mix = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        return values[i] * (1.0 - mix) + values[i + 1] * mix


@dataclasses.dataclass
class CameraScript:
    """script.rs `Script`: optional position + look-direction channels."""

    position: _Channel | None = None
    look_direction: _Channel | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "CameraScript":
        return cls(
            position=_Channel.from_dict(d.get("position")),
            look_direction=_Channel.from_dict(d.get("look_direction")),
        )

    @classmethod
    def from_file(cls, path: str) -> "CameraScript":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def add_frame(self, t: float, position, look_direction) -> None:
        """script.rs Script::add_frame — append one keyframe to both
        channels (used by script RECORDING, the write-on-exit role)."""
        for name, val in (("position", position), ("look_direction", look_direction)):
            ch = getattr(self, name)
            row = np.asarray(val, np.float64)[None]
            if ch is None:
                setattr(
                    self,
                    name,
                    _Channel(np.asarray([t], np.float64), row),
                )
            else:
                ch.times = np.append(ch.times, t)
                ch.values = np.concatenate([ch.values, row])

    def to_dict(self) -> dict:
        out = {}
        for name in ("position", "look_direction"):
            ch = getattr(self, name)
            if ch is not None:
                out[name] = {
                    "times": ch.times.tolist(),
                    "values": ch.values.tolist(),
                }
        return out

    def camera_at(self, t: float, camera, fallback_eye, fallback_look) -> None:
        """Point `camera` per the script at time t; un-scripted channels
        keep the caller's fallback."""
        eye = self.position.get(t) if self.position else np.asarray(fallback_eye)
        if self.look_direction is not None:
            look = eye + self.look_direction.get(t)
        else:
            look = np.asarray(fallback_look)
        camera.look_at(eye, look)


class Performance(Behavior):
    """script.rs `Performance`: a Character behavior that replays a
    CameraScript against the character's body each tick. Not persisted
    (script.rs `persistence() -> None`)."""

    def __init__(self, script: CameraScript, character_name: str = "player"):
        self.script = script
        self.character_name = character_name
        self.time = 0.0

    def step(self, universe, host_name, tick):
        ch = universe.characters.get(self.character_name)
        if ch is None or universe.bodies is None:
            return None, "drop"
        from .session import set_body_row

        fields = {}
        if self.script.position is not None:
            fields["position"] = self.script.position.get(self.time)
        if self.script.look_direction is not None:
            d = self.script.look_direction.get(self.time)
            # Body orientation from a look vector (inverse of the session
            # eye_camera forward = [-sin(yaw)cos(p), sin(p), -cos(yaw)cos(p)]).
            fields["yaw"] = np.degrees(np.arctan2(-d[0], -d[2]))
            fields["pitch"] = np.degrees(
                np.arctan2(d[1], np.hypot(d[0], d[2]) or 1e-9)
            )
        if fields:
            set_body_row(universe, ch.body_index, **fields)
        self.time += tick.dt
        return None, "step"
