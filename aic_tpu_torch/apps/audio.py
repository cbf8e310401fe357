"""Audio output: spatial fluff playback mixed to a PCM sink.

Port of `aic_tpu/apps/audio.py`, host numpy as there; `SessionAudio`
reads the listener's position and yaw from the bodies' device with one
copy (`apps/session.py::body_row`).

Role of the reference's audio frontend
(all-is-cubes-desktop/src/audio.rs): fluff broadcast by the universe is
mapped to sounds (`universe/sound.py` fluff_sound_map — the SoundDef
synthesis analog of its kira StaticSoundData), spatialized against the
listener (distance attenuation + stereo pan from the listener's yaw, the
role of kira's SpatialTrack listener at audio.rs:51-110), and mixed into
a stereo PCM stream.

Sink deviation (documented): the reference plays through a hardware
device via cpal; this environment has no audio device, so the default
sink renders to a WAV file (`WavFileSink`) — the mixing/spatialization
pipeline is the same, only the terminal device differs. A hardware sink
can be added by implementing `write(stereo_f32)`.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass, field

import numpy as np

from ..universe.sound import SoundDef, fluff_sound_map, synthesize

SAMPLE_RATE = 44100

#: Distance (cubes) at which a sound has faded to ~zero.
MAX_HEARING_DISTANCE = 40.0


@dataclass
class AudioMixer:
    """Accumulates scheduled mono sounds into one stereo f32 stream."""

    sample_rate: int = SAMPLE_RATE
    _buffer: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32)
    )

    def schedule(self, sound: SoundDef, at_seconds: float, gain: float = 1.0,
                 pan: float = 0.0) -> None:
        """Mix `sound` starting at `at_seconds`; pan ∈ [-1 left, +1 right]
        (equal-power panning)."""
        if gain <= 0.0:
            return
        pcm = synthesize(sound, self.sample_rate) * np.float32(gain)
        start = max(int(at_seconds * self.sample_rate), 0)
        end = start + len(pcm)
        if end > len(self._buffer):
            grown = np.zeros((end, 2), np.float32)
            grown[: len(self._buffer)] = self._buffer
            self._buffer = grown
        theta = (np.clip(pan, -1.0, 1.0) + 1.0) * (np.pi / 4.0)
        self._buffer[start:end, 0] += pcm * np.float32(np.cos(theta))
        self._buffer[start:end, 1] += pcm * np.float32(np.sin(theta))

    def take(self) -> np.ndarray:
        """The mixed stereo stream so far (clipped to [-1, 1])."""
        return np.clip(self._buffer, -1.0, 1.0)


class WavFileSink:
    """Terminal device writing 16-bit stereo WAV (the cpal stand-in)."""

    def __init__(self, path: str, sample_rate: int = SAMPLE_RATE):
        self.path = path
        self.sample_rate = sample_rate

    def write(self, stereo: np.ndarray) -> None:
        data = (np.clip(stereo, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(self.path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            w.writeframes(data.tobytes())


class NullSink:
    def write(self, stereo: np.ndarray) -> None:
        pass


def spatialize(listener_pos, listener_yaw_deg: float, source_pos):
    """(gain, pan) for a sound at `source_pos` heard from the listener
    (the kira spatial-track role, audio.rs:106-110): inverse-distance
    attenuation with a hearing radius, pan from the bearing relative to
    the listener's facing."""
    d = np.asarray(source_pos, np.float64) - np.asarray(listener_pos, np.float64)
    dist = float(np.linalg.norm(d))
    gain = float(np.clip(1.0 - dist / MAX_HEARING_DISTANCE, 0.0, 1.0))
    if dist < 1e-6:
        return 1.0, 0.0
    yaw = np.radians(listener_yaw_deg)
    # Facing -Z at yaw 0 (camera convention); right ear toward +X rotated.
    right = np.array([np.cos(yaw), 0.0, np.sin(yaw)])
    pan = float(np.clip(np.dot(d / max(dist, 1e-6), right), -1.0, 1.0))
    return gain, pan


class SessionAudio:
    """Drains a session's universe fluff each pump and mixes spatialized
    sounds at the session clock's time."""

    def __init__(self, session, sink=None, sounds=None):
        self.session = session
        self.sink = sink or NullSink()
        self.mixer = AudioMixer()
        self.sounds = sounds or fluff_sound_map()
        self._t0 = None

    def pump(self, now: float) -> int:
        """Collect this tick's fluff; returns the number of sounds mixed."""
        if self._t0 is None:
            self._t0 = now
        u = self.session.universe
        ch = self.session.character
        listener = (0.0, 0.0, 0.0)
        yaw = 0.0
        if ch is not None:
            from .session import body_row

            row = body_row(u, ch.body_index)
            listener = tuple(float(v) for v in row["position"])
            yaw = float(row["yaw"])
        n = 0
        for fluff in u.drain_fluff("audio"):
            sound = self.sounds.get(fluff.name)
            if sound is None:
                continue
            pos = np.asarray(fluff.position, np.float64) + 0.5
            gain, pan = spatialize(listener, yaw, pos)
            self.mixer.schedule(sound, now - self._t0, gain=gain, pan=pan)
            n += 1
        return n

    def flush(self) -> None:
        self.sink.write(self.mixer.take())
