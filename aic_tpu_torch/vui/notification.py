"""Notifications: user-facing progress/status messages shown in the HUD.

Copied unchanged from `aic_tpu/vui/notification.py` (plain Python): the port carries its own
copy because `aic_tpu`'s package imports pull in JAX.

Role of the reference's notification channel
(all-is-cubes-ui/src/ui_content/notification.rs): a `Notification` is a
live handle whose content the producer can update; the `NotificationHub`
collects the receivers, drops dead ones, and exposes the primary (oldest
live) content for the HUD to draw as a progress bar + title row
(notification.rs:24 `NotificationContent::Progress`, :82 `Hub`).

Re-design notes: the reference uses Arc/Weak + listen cells across
threads; our session is single-threaded functional, so the hub holds
weakrefs and a simple dirty flag, and the HUD redraw path polls
`primary()` during `refresh_ui`.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass


@dataclass(frozen=True)
class ProgressContent:
    """NotificationContent::Progress (notification.rs:28-38)."""

    title: str
    fraction: float  # 0..1
    part: str = ""


class Notification:
    """A live notification handle (notification.rs:55). The message shows
    until the handle is dropped (garbage-collected) or dismissed."""

    def __init__(self, content: ProgressContent):
        self._content = content
        self._dismissed = False

    @property
    def content(self) -> ProgressContent:
        return self._content

    def set_content(self, content: ProgressContent) -> None:
        """notification.rs:111 set_content."""
        self._content = content

    def dismiss(self) -> None:
        self._dismissed = True


class NotificationHub:
    """notification.rs:82 Hub: retains weak receivers, primary = oldest
    live notification's content."""

    #: Hub capacity (Error::Overflow above this).
    LIMIT = 16

    def __init__(self):
        self._receivers: list[weakref.ref[Notification]] = []

    def show(self, content: ProgressContent) -> Notification:
        """Session::show_notification: create, register, return the live
        handle. Raises OverflowError at capacity (notification.rs Error::
        Overflow)."""
        self.sweep()
        if len(self._receivers) >= self.LIMIT:
            raise OverflowError("too many notifications")
        n = Notification(content)
        self._receivers.append(weakref.ref(n))
        return n

    def sweep(self) -> None:
        """Hub::update retain pass: drop dropped/dismissed notifications."""
        self._receivers = [
            r
            for r in self._receivers
            if (n := r()) is not None and not n._dismissed
        ]

    def primary(self) -> ProgressContent | None:
        """The content the HUD displays (Hub primary_content)."""
        self.sweep()
        for r in self._receivers:
            n = r()
            if n is not None:
                return n.content
        return None

    def count(self) -> int:
        self.sweep()
        return len(self._receivers)
