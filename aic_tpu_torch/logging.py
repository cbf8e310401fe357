"""Logging & telemetry (reference: all-is-cubes-desktop/src/logging.rs).

Port of `aic_tpu/logging.py`, copied but for the application prefix
(`aic_tpu_torch`) and the foreign libraries clamped to ERROR (torch in
place of jax).

The reference installs a stderr logger with an application-focused
module filter (logging.rs:121 AicLogger: aic crates at the requested
verbosity, everything else at error), a progress-bar facility that
cooperates with log output on the same stderr (logging.rs:187), and an
optional Rerun recording stream for structured telemetry of the
renderer/universe (logging.rs:248 LateLogging).

Equivalents here:
- `install()` configures Python logging the same way: `aic_tpu_torch.*`
  loggers at the chosen level, foreign libraries (torch, PIL, pygame)
  clamped to ERROR so kernel-build chatter never buries session logs.
- `ProgressBar` writes a single self-rewriting stderr line and suspends
  itself around log records emitted through the installed handler
  (the indicatif cooperation analog, logging.rs:180).
- `Telemetry` is the Rerun-stream analog in device-friendly form: one
  JSON line per record (step phases, light-queue depth, frame timings)
  to a file or stderr, consumable by any tooling without a viewer
  dependency.
"""

from __future__ import annotations

import json
import logging as _pylog
import sys
import time
from typing import Optional

#: Module prefixes treated as "application" (logging.rs standard_filter
#: keeps `all_is_cubes*` at the user level, others at error).
APP_PREFIX = "aic_tpu_torch"
_FOREIGN_ERROR_ONLY = ("torch", "PIL", "pygame", "matplotlib", "asyncio")


def get_logger(name: str) -> _pylog.Logger:
    return _pylog.getLogger(name)


class _CooperativeHandler(_pylog.StreamHandler):
    """stderr handler that clears any active ProgressBar line before a
    record prints, then redraws it (suspend_indicatif_in analog)."""

    def emit(self, record):
        bar = ProgressBar._active
        if bar is not None:
            bar._clear()
        super().emit(record)
        if bar is not None:
            bar._draw()


def install(
    verbose: bool = False,
    simplify_log_format: bool = False,
    stream=None,
) -> None:
    """logging.rs:34 install(): set up the stderr logger + module filter.

    `simplify_log_format` drops timestamps/levels (the reference's
    option for test output and piped logs)."""
    root = _pylog.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = _CooperativeHandler(stream or sys.stderr)
    fmt = (
        "%(message)s"
        if simplify_log_format
        else "[%(asctime)s %(levelname)s %(name)s] %(message)s"
    )
    handler.setFormatter(_pylog.Formatter(fmt, datefmt="%H:%M:%S"))
    root.addHandler(handler)
    root.setLevel(_pylog.WARNING)
    _pylog.getLogger(APP_PREFIX).setLevel(
        _pylog.DEBUG if verbose else _pylog.INFO
    )
    for name in _FOREIGN_ERROR_ONLY:
        _pylog.getLogger(name).setLevel(_pylog.ERROR)


class ProgressBar:
    """Single-line stderr progress (logging.rs:193 new_progress_bar),
    sharing stderr cleanly with log records."""

    _active: Optional["ProgressBar"] = None

    def __init__(self, total: int, label: str = "", stream=None):
        self.total = max(int(total), 1)
        self.n = 0
        self.label = label
        self.stream = stream or sys.stderr
        self._last_draw = 0.0

    def __enter__(self):
        ProgressBar._active = self
        self._draw()
        return self

    def __exit__(self, *exc):
        self._clear()
        ProgressBar._active = None

    def advance(self, k: int = 1):
        self.n = min(self.n + k, self.total)
        now = time.monotonic()
        if now - self._last_draw > 0.05 or self.n == self.total:
            self._draw()
            self._last_draw = now

    def _draw(self):
        frac = self.n / self.total
        width = 24
        filled = int(frac * width)
        self.stream.write(
            f"\r{self.label} [{'#' * filled}{'.' * (width - filled)}] "
            f"{self.n}/{self.total}"
        )
        self.stream.flush()

    def _clear(self):
        self.stream.write("\r\x1b[K")
        self.stream.flush()


class Telemetry:
    """JSONL telemetry stream (the Rerun recording analog,
    logging.rs:248): `record(kind, **fields)` appends one line with a
    monotonic timestamp. Cheap enough to leave on in headless runs."""

    def __init__(self, path: Optional[str] = None, stream=None):
        self._file = open(path, "a") if path else None
        self._stream = stream
        self._t0 = time.monotonic()

    def record(self, kind: str, **fields) -> None:
        out = self._file or self._stream
        if out is None:
            return
        fields["t"] = round(time.monotonic() - self._t0, 6)
        fields["kind"] = kind
        out.write(json.dumps(fields) + "\n")
        out.flush()

    def attach_to_universe(self, universe) -> None:
        """LateLogging::attach analog: step() emits per-phase timings
        and light-queue depth here."""
        universe.telemetry = self

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
