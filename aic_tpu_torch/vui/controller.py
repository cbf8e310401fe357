"""Widget controllers: incremental VUI updates.

Port of `aic_tpu/vui/controller.py`. The HUD's device state lives on the
controller's device; a commit scatters the changed cells into it
(`SpaceTransaction.commit`), and each commit is a new snapshot, whose
trace tables the renderer builds once.

The reference separates a widget (a static description, `Widget`) from
its `WidgetController`, a stateful agent the VUI manager steps every
frame; a controller returns a transaction covering exactly what changed
(all-is-cubes-ui/src/vui/widget_trait.rs:58-89 Widget/WidgetController,
vui_manager.rs install/step loop). A plain VUI would draw widget trees
once and re-snapshot the entire UI space on any change — correct, but
O(space volume) on host and device per update.

This module brings the controller model over in device-friendly form:

- a controller re-renders only its own widget (via a recording shim
  around the widget's existing `draw`, so the drawing logic is written
  once), diffs against the cells it drew last time, and emits a
  `SpaceTransaction` with just the changed cubes;
- the `HudController` merges all widget transactions of a frame and
  commits them through `SpaceTransaction.commit`, which scatters the few
  changed cells into the existing device `SpaceState` — no host-side
  space redraw, no full re-snapshot (commit only signals a re-snapshot
  when the palette outgrows its padding, e.g. a never-seen icon block).

Controllers fire only when their `fingerprint` of session state changes,
so a HUD step with nothing to do costs a few tuple comparisons. Animated
widgets fit the same protocol by including a clock phase in their
fingerprint (widget_trait.rs step(Tick) analog).
"""

from __future__ import annotations

from typing import Callable, Optional

from .. import block as _block
from ..universe.transaction import SpaceTransaction


class _Recorder:
    """Duck-typed draw target capturing a widget's cell writes.

    Widgets draw through `set`/`fill` (and may register `ui_actions`);
    recording those calls gives the exact cell->Block map of one widget
    without touching the real space.
    """

    def __init__(self):
        self.cells: dict[tuple, object] = {}
        self.ui_actions: list = []

    def set(self, cube, blk):
        self.cells[tuple(int(c) for c in cube)] = blk

    def fill(self, region, blk):
        for c in region.interior_iter():
            self.cells[tuple(int(x) for x in c)] = blk


class WidgetController:
    """Generic diff-based controller (widget_trait.rs:89 step()).

    `fingerprint(session)` captures everything the widget's appearance
    depends on; when it changes, the widget is re-recorded and the cell
    diff (including cells that must revert to AIR) becomes the step's
    transaction.
    """

    def __init__(self, widget, origin, fingerprint: Callable):
        self.widget = widget
        self.origin = tuple(int(c) for c in origin)
        self._fingerprint = fingerprint
        self._last_fp: object = object()  # never equal -> first step draws
        self._last_cells: dict[tuple, object] = {}

    def step(self, session) -> Optional[SpaceTransaction]:
        fp = self._fingerprint(session)
        if fp == self._last_fp:
            return None
        self._last_fp = fp
        rec = _Recorder()
        self.widget.draw(rec, self.origin)
        txn: Optional[SpaceTransaction] = None

        def emit(cube, blk):
            nonlocal txn
            t = SpaceTransaction.set_cube(cube, new=blk, conserved=False)
            txn = t if txn is None else txn.merge(t)

        for cube in self._last_cells:
            if cube not in rec.cells:
                emit(cube, _block.AIR)
        for cube, blk in rec.cells.items():
            if self._last_cells.get(cube) != blk:
                emit(cube, blk)
        self._last_cells = rec.cells
        return txn

    def prime(self, cells: dict):
        """Mark `cells` (from the initial whole-HUD draw) as already
        current so the first step() doesn't redraw them."""
        self._last_cells = dict(cells)


class NotificationRow:
    """The HUD's primary-notification readout as a widget: progress bar
    plus title text (ui_content/notification.rs display role)."""

    def __init__(self, hub, width: int):
        self.hub = hub
        self.width = width

    def size(self):
        return self.width, 1

    def draw(self, space, lower):
        from .widgets import ProgressBar, text_blocks

        x, y, z = lower
        content = self.hub.primary()
        if content is None:
            return  # no cells -> diff reverts previous row to AIR
        ProgressBar(fraction=content.fraction, width=6).draw(space, (x + 1, y, z))
        label = (
            content.title
            if not content.part
            else f"{content.title}: {content.part}"
        )
        for i, b in enumerate(text_blocks(label)[: self.width - 9]):
            space.set((x + 8 + i, y, z), b)


def _toolbar_fingerprint(toolbar):
    def fp(_session):
        inv = toolbar.inventory
        return (inv.selected, tuple(repr(s) for s in inv.slots))

    return fp


def _tooltip_fingerprint(tooltip):
    def fp(_session):
        return tooltip.current_text()

    return fp


def _notification_fingerprint(hub):
    def fp(_session):
        c = hub.primary()
        return None if c is None else (c.title, c.fraction, c.part)

    return fp


class HudController:
    """The VUI manager (vui_manager.rs): owns the HUD space, its device
    state, and one controller per dynamic widget. `step()` is cheap when
    nothing changed and O(changed cells) otherwise."""

    def __init__(self, inventory, notifications, width: int = 24, height: int = 14, device="cuda"):
        from .hud import build_hud

        self.device = device
        self.space, self.widgets = build_hud(inventory, width, height)
        self.state = self.space.snapshot(device=device)
        tx = self.widgets["tx"]
        note_row = NotificationRow(notifications, self.space.bounds.size[0])
        self.controllers = [
            WidgetController(
                self.widgets["toolbar"],
                (tx, 0, 0),
                _toolbar_fingerprint(self.widgets["toolbar"]),
            ),
            WidgetController(
                self.widgets["tooltip"],
                (tx, 1, 0),
                _tooltip_fingerprint(self.widgets["tooltip"]),
            ),
            WidgetController(
                note_row,
                (0, self.space.bounds.size[1] - 2, 0),
                _notification_fingerprint(notifications),
            ),
        ]
        # Prime from the initial draw so the first step is a no-op: the
        # build_hud draw already rendered toolbar + tooltip.
        for c in self.controllers[:2]:
            rec = _Recorder()
            c.widget.draw(rec, c.origin)
            c.prime(rec.cells)
            c._last_fp = c._fingerprint(None)
        self.controllers[2].prime({})
        self.controllers[2]._last_fp = None

    def add_controller(self, widget, origin, fingerprint) -> WidgetController:
        c = WidgetController(widget, origin, fingerprint)
        self.controllers.append(c)
        return c

    def step(self, session=None) -> bool:
        """Step all controllers; commit the merged diff to the device
        state. Returns True when anything changed."""
        txn: Optional[SpaceTransaction] = None
        for c in self.controllers:
            t = c.step(session)
            if t is not None:
                txn = t if txn is None else txn.merge(t)
        if txn is None:
            return False
        new_state = txn.commit(self.space, self.state)
        if new_state is None:
            # Palette outgrew its padded device tables (a new icon block
            # etc.) — the one case that still needs a full snapshot.
            new_state = self.space.snapshot(device=self.device)
        self.state = new_state
        return True
