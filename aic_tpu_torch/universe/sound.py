"""Synthesized sound definitions (reference: all-is-cubes/src/sound/).

Copied unchanged from `aic_tpu/universe/sound.py` (host numpy): the port
carries its own copy because `aic_tpu`'s package imports pull in JAX.

`SoundDef` describes a short synthesized waveform (the reference's
universe members of the same name); `synthesize` renders it to f32 PCM
on host, and `fluff_sound_map` gives frontends the fluff-name → SoundDef
mapping they play back (desktop audio.rs's kira glue is the consumer
role; our frontends receive raw PCM).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SoundDef:
    """A synthesized tone: oscillator + envelope (sound/def)."""

    waveform: str = "sine"  # "sine" | "square" | "saw" | "noise"
    frequency: float = 440.0
    duration: float = 0.08  # seconds
    amplitude: float = 0.3
    decay: float = 30.0  # exponential amplitude decay rate (1/s)


def synthesize(sound: SoundDef, sample_rate: int = 44100) -> np.ndarray:
    """Render to mono f32 PCM in [-1, 1]."""
    n = max(int(sound.duration * sample_rate), 1)
    t = np.arange(n) / sample_rate
    phase = t * sound.frequency
    if sound.waveform == "square":
        osc = np.sign(np.sin(2 * np.pi * phase))
    elif sound.waveform == "saw":
        osc = 2.0 * (phase - np.floor(phase + 0.5))
    elif sound.waveform == "noise":
        osc = np.random.default_rng(0).uniform(-1, 1, n)
    else:
        osc = np.sin(2 * np.pi * phase)
    envelope = np.exp(-sound.decay * t)
    return (sound.amplitude * envelope * osc).astype(np.float32)


#: Default fluff-name → sound mapping (the sounds content installs;
#: fluff.rs's standard effects like BlockPlaced/BlockDestroyed).
DEFAULT_SOUNDS = {
    "Place": SoundDef(waveform="square", frequency=660.0, duration=0.06),
    "Destroy": SoundDef(waveform="noise", frequency=0.0, duration=0.09),
    "Activate": SoundDef(waveform="sine", frequency=880.0, duration=0.05),
    "Step": SoundDef(waveform="noise", frequency=0.0, duration=0.03, amplitude=0.12),
    "Happened": SoundDef(),
}


def fluff_sound_map() -> dict:
    return dict(DEFAULT_SOUNDS)


# --- ambient sound (sound/ambient.rs) ---------------------------------------

#: Number of ambient frequency bands (ambient.rs Band::COUNT).
AMBIENT_BANDS = 20
#: Center frequency of the lowest band / octave spacing (ambient.rs:25-27).
FIRST_BAND_HZ = 20.0
BAND_STEP_OCT = 0.5


def band_frequency(index: int) -> float:
    """Center frequency of band `index` (20 Hz .. ~14.5 kHz)."""
    return FIRST_BAND_HZ * 2.0 ** (BAND_STEP_OCT * index)


def band_from_frequency(hz: float) -> int:
    """ambient.rs Band::from_frequency: nearest band index."""
    return min(
        max(int(round(np.log2(max(hz, 1e-6) / FIRST_BAND_HZ) / BAND_STEP_OCT)), 0),
        AMBIENT_BANDS - 1,
    )


def synthesize_ambient(
    noise_bands, duration: float = 1.0, sample_rate: int = 44100, seed: int = 0
) -> np.ndarray:
    """Render an ambient noise spectrum (f32[20] per-band gains) to mono
    PCM: band-filtered noise built as sinusoids with random phase walk —
    the listener-side role of the reference's ambient sound processing
    (ambient.rs; the block-attribute gains come from
    `BlockAttributes.ambient_sound`)."""
    gains = np.asarray(noise_bands, np.float32)
    n = max(int(duration * sample_rate), 1)
    t = np.arange(n) / sample_rate
    rng = np.random.default_rng(seed)
    out = np.zeros(n, np.float32)
    for i in range(min(len(gains), AMBIENT_BANDS)):
        g = float(gains[i])
        if g <= 0.0:
            continue
        f = band_frequency(i)
        # A few detuned partials per band approximate narrowband noise.
        for _ in range(3):
            fj = f * (1.0 + rng.uniform(-0.15, 0.15))
            phase = rng.uniform(0, 2 * np.pi)
            out += (g / 3.0) * np.sin(2 * np.pi * fj * t + phase).astype(np.float32)
    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    return out
