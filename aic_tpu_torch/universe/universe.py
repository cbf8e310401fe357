"""Universe: the container of all game state, and the step loop.

Port of `aic_tpu/universe/universe.py` (the reference's `Universe`,
all-is-cubes/src/universe.rs:128, and its step schedule, time.rs:313-345
and space/step.rs). The Universe is a host orchestrator; each named
Space owns a `SpaceState` on the universe's device (the card unless the
caller asks for the CPU). One `step()` runs the reference's phases:

  Synchronize   palette re-evaluation for changed BlockDefs (host; rare)
  Step:
    tick actions  a space whose actions are palette remaps takes the
                  device tick (device_step.py: remap, dirty marks, cell
                  rebuild and the tick's light rounds, no read-back);
                  the others run the per-cube host loop and commit a
                  merged SpaceTransaction (space/step.rs:114)
    behaviors     host Behavior objects emit transactions (behavior.rs:198)
    body physics  `step_bodies` over the body batch (physics/body.py)
    light         `light_rounds_per_tick` queue rounds of
                  `light_batch_size` cubes (space/step.rs:338) for the
                  spaces the device tick did not relight

`Universe.whence` is its storage origin (io/whence.py); an attached
`telemetry` (logging.py `Telemetry`) gets one record a step.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..io.whence import NoWhence
from ..light.update import light_update_round
from ..physics import Body, step_bodies
from ..profiling import Profiler
from ..space import Space
from .op import OperationFailed
from .transaction import SpaceTransaction, TransactionConflict, UniverseTransaction

TICKS_PER_SECOND = 60  # time.rs:183 TickSchedule default divisor


@dataclass
class Tick:
    """time.rs:27: dt + schedule phase."""

    ticks: int
    dt: float = 1.0 / TICKS_PER_SECOND
    paused: bool = False


@dataclass
class Clock:
    """time.rs:230 Clock: fixed-schedule tick counter."""

    ticks: int = 0

    def advance(self, paused: bool = False) -> Tick:
        t = Tick(ticks=self.ticks, paused=paused)
        if not paused:
            self.ticks += 1
        return t


#: Registry of persistable Behavior types (save/schema.rs
#: BehaviorSetEntryV1Ser's typed behavior payloads): type tag ->
#: constructor taking the schema dict. Behaviors register via
#: `Behavior.register` (a subclass defining `SCHEMA_TYPE` + `to_schema`
#: + `from_schema`); unregistered behaviors are dropped on save, like
#: the reference drops behaviors it can't serialize.
BEHAVIOR_REGISTRY: dict = {}


class Behavior:
    """behavior.rs:28: attachable per-member logic. step() returns
    (UniverseTransaction | None, then) where then is "step" to continue,
    "drop" to detach, or an integer tick count to sleep.

    Persistence: subclasses that define `SCHEMA_TYPE` and implement
    `to_schema()` / `from_schema(d)` (classmethod) survive
    save_universe/load_universe round-trips (schema.rs behavior
    serialization role)."""

    SCHEMA_TYPE: str | None = None

    def step(self, universe: "Universe", host_name: str, tick: Tick):
        return None, "drop"

    def to_schema(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_schema(cls, d: dict) -> "Behavior":
        raise NotImplementedError

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if getattr(cls, "SCHEMA_TYPE", None):
            BEHAVIOR_REGISTRY[cls.SCHEMA_TYPE] = cls


@dataclass
class Character:
    """Player avatar (character.rs:66): a Body plus input intents.
    Lives in the universe's body batch at `body_index`."""

    name: str
    space_name: str
    body_index: int
    # Input state (set by InputProcessor / UI layer):
    velocity_input: tuple = (0.0, 0.0, 0.0)
    selected_slot: int = 0
    inventory: list = field(default_factory=list)


@dataclass
class UniverseStepInfo:
    """universe.rs:863: per-step structured diagnostics.

    Stats produced by the device tick (universe/device_step.py) stay on
    the device inside this object; reading `space_edits` /
    `light_updates` / `light_queue` drains them with one blocking
    read-back. A step loop that never reads them never syncs for them."""

    tick: int = 0
    bodies: int = 0
    behaviors_run: int = 0
    wall_time_s: float = 0.0

    def __post_init__(self):
        self._space_edits = 0
        self._light_updates = 0
        self._light_queue = 0
        self._device_stats: list = []

    def add_device_stats(self, stats: dict):
        self._device_stats.append(stats)

    def _drain(self):
        for s in self._device_stats:
            self._space_edits += int(s["edits"])
            self._light_updates += int(s["updated"])
            self._light_queue += int(s["queue_remaining"])
        self._device_stats = []

    @property
    def space_edits(self) -> int:
        self._drain()
        return self._space_edits

    @space_edits.setter
    def space_edits(self, v: int):
        self._space_edits = v

    @property
    def light_updates(self) -> int:
        self._drain()
        return self._light_updates

    @light_updates.setter
    def light_updates(self, v: int):
        self._light_updates = v

    @property
    def light_queue(self) -> int:
        self._drain()
        return self._light_queue

    @light_queue.setter
    def light_queue(self, v: int):
        self._light_queue = v


class Universe:
    def __init__(self, device="cuda"):
        #: Device of every space's state and of the body batch (the card
        #: unless the caller asks for the CPU).
        self.device = device
        #: Storage provenance (save/whence.rs:20): a fresh universe has none.
        self.whence = NoWhence()
        self.spaces: dict[str, Space] = {}
        self.states: dict[str, object] = {}  # name -> SpaceState (device)
        self.block_defs: dict[str, object] = {}
        #: Named SoundDef members (universe sound members, sound.rs role).
        self.sounds: dict[str, object] = {}
        self.characters: dict[str, Character] = {}
        self.behaviors: list[tuple[str, Behavior, int]] = []  # (host, behavior, wake_tick)
        self.bodies: Optional[Body] = None  # the body batch, on the device
        #: bool[n_bodies] from the last physics step (body.rs:309
        #: is_on_ground input); None before the first step.
        self.on_ground = None
        self.body_space: list[str] = []  # space per body row
        self.clock = Clock()
        #: Per-phase step timings (profiling.py); `profiler.report()` is
        #: the info-text payload.
        self.profiler = Profiler()
        # Per-tick light budget: `aic_tpu`'s, one round of 16 cubes (the
        # reference's deadline-bounded queue, updater.rs:175-196, defers
        # what the frame budget leaves). Convergence work (scene loads,
        # big edits) goes through evaluate_light's dense passes instead.
        self.light_rounds_per_tick = 1
        self.light_batch_size = 16
        self._tick_action_index: dict[str, list] = {}
        #: Per-space compiled tick plans (universe/device_step.py): key ->
        #: (cache_token, TickPlan|None). None = the space's actions need
        #: the host path this epoch.
        self._tick_plan_cache: dict[str, tuple] = {}
        self._tick_closure_epoch: dict[str, int] = {}
        #: Momentary effects emitted this tick (fluff.rs); drained by the
        #: frontend (sound playback, particles).
        self.fluff_buffer: list = []  # [(seq, fluff)] shared log
        self._fluff_seq = 0
        self._fluff_floor = 0
        self._fluff_cursors: dict = {}
        #: Tag definitions (tag.rs TagDef universe members).
        self.tags: dict[str, object] = {}

    # -- membership (universe.rs:419 insert) --------------------------------

    def _member_dicts(self):
        return (self.spaces, self.block_defs, self.sounds, self.tags, self.characters)

    def member_names(self) -> set:
        out = set()
        for d in self._member_dicts():
            out.update(d.keys())
        return out

    def _check_insert_name(self, name: str):
        """Names are universe-global across member types
        (universe/tests.rs insert_duplicate_name_*), and the anonymous
        format is reserved (insert_anonym_prohibited_direct)."""
        if name in self.member_names():
            raise ValueError(f"member {name!r} already exists")
        if name.startswith("[anonymous"):
            raise ValueError("anonymous names may only come from insert_anonymous")

    def insert_space(self, name: str, space: Space, _anonymous: bool = False) -> str:
        if not _anonymous:
            self._check_insert_name(name)
        self.spaces[name] = space
        self.states[name] = space.snapshot(device=self.device)
        self._reindex_tick_actions(name)
        return name

    def insert_block_def(self, name: str, block_def) -> str:
        self._check_insert_name(name)
        self.block_defs[name] = block_def
        return name

    def insert_anonymous(self, member) -> str:
        """universe.rs insert_anonymous: a distinct reserved name; such
        members are garbage-collected when unreferenced and cannot be
        deleted by name."""
        n = getattr(self, "_anonym_counter", 0)
        self._anonym_counter = n + 1
        name = f"[anonymous #{n}]"
        if isinstance(member, Space):
            self.insert_space(name, member, _anonymous=True)
        else:
            self.block_defs[name] = member
        return name

    @staticmethod
    def is_anonymous(name: str) -> bool:
        return name.startswith("[anonymous")

    def delete(self, name: str) -> None:
        """UniverseTransaction::delete semantics (universe/tests.rs
        delete_*): deleting twice fails; anonymous members are strictly
        garbage-collected and cannot be deleted."""
        if self.is_anonymous(name):
            raise ValueError(f"anonymous member {name!r} cannot be deleted")
        for d in self._member_dicts():
            if name in d:
                del d[name]
                self.states.pop(name, None)
                self._tick_action_index.pop(name, None)
                return
        raise KeyError(f"no member {name!r}")

    def gc(self) -> int:
        """universe/gc.rs:55: delete anonymous members unreachable from
        named (root) members. References are object identity: Indirect
        primitives → BlockDefs, **Recur primitives → Spaces** (gc.rs
        traces every handle a member holds, and anonymous voxel-source
        spaces are the reference's standard Recur pattern),
        Character.space_name → Spaces. Transitive: a live anonymous
        space's palette keeps what IT references. Returns the number of
        members collected."""
        from ..block.model import Indirect, Recur

        live_defs: set[int] = set()  # id(BlockDef)
        live_space_objs: set[int] = set()  # id(Space)
        pending_spaces: list = []  # Space objects whose palettes to scan

        def scan_block(block) -> None:
            stack = [block]
            while stack:
                b = stack.pop()
                p = b.primitive
                if isinstance(p, Indirect):
                    if id(p.block_def) not in live_defs:
                        live_defs.add(id(p.block_def))
                        stack.append(p.block_def.block)
                elif isinstance(p, Recur):
                    if id(p.space) not in live_space_objs:
                        live_space_objs.add(id(p.space))
                        pending_spaces.append(p.space)
                for m in b.modifiers:
                    src = getattr(m, "source", None)
                    if src is not None:
                        stack.append(src)

        live_spaces = set()  # names rooted directly
        for name, sp in self.spaces.items():
            if not self.is_anonymous(name):
                live_spaces.add(name)
        for ch in self.characters.values():
            live_spaces.add(ch.space_name)
        live_spaces.update(host for host, _, _ in self.behaviors)
        for name in live_spaces:
            sp = self.spaces.get(name)
            if sp is not None and id(sp) not in live_space_objs:
                live_space_objs.add(id(sp))
                pending_spaces.append(sp)
        for name, bd in self.block_defs.items():
            if not self.is_anonymous(name):
                live_defs.add(id(bd))
                scan_block(bd.block)
        while pending_spaces:
            sp = pending_spaces.pop()
            for blk in sp.palette:
                scan_block(blk)

        collected = 0
        for name in [
            n
            for n, bd in self.block_defs.items()
            if self.is_anonymous(n) and id(bd) not in live_defs
        ]:
            del self.block_defs[name]
            collected += 1
        for name in [
            n
            for n, sp in self.spaces.items()
            if self.is_anonymous(n)
            and n not in live_spaces
            and id(sp) not in live_space_objs
        ]:
            del self.spaces[name]
            self.states.pop(name, None)
            self._tick_action_index.pop(name, None)
            collected += 1
        return collected

    def insert_character(self, name: str, space_name: str, position) -> Character:
        if name in self.characters:
            # Duplicate member names are an insertion error in the
            # reference (universe.rs UniverseTransaction::insert →
            # InsertError::AlreadyExists); silently shadowing the old
            # Character would leave its body row orphaned in the batch.
            raise ValueError(
                f"character {name!r} already exists in this universe"
            )
        body = Body.stack([Body.make(position=position, device=self.device)])
        idx = len(self.body_space)
        # Append a row to the batch (content-time; rare).
        self.bodies = body if self.bodies is None else Body.cat([self.bodies, body])
        self.body_space.append(space_name)
        ch = Character(name=name, space_name=space_name, body_index=idx)
        self.characters[name] = ch
        return ch

    def add_behavior(self, host_name: str, behavior: Behavior):
        self.behaviors.append([host_name, behavior, 0])

    def get_state(self, name: str):
        return self.states[name]

    def resnapshot(self, name: str):
        """Rebuild device tables after palette growth (content-time)."""
        self.states[name] = self.spaces[name].snapshot(device=self.device)
        self._reindex_tick_actions(name)

    def _intern_tick_closure(self, name: str) -> bool:
        """Eagerly intern every Become/DestroyTo tick-action target (and
        the targets of the targets: a Become animation chain) into the
        palette. Without this, each chain frame interns only when its
        action first fires, so the palette keeps growing for a whole
        animation cycle: every growth resnapshots the space and keeps
        `compile_tick_plan` returning None (host per-cube path). Gated on
        the palette epoch so steady-state ticks pay one dict lookup."""
        from .op import Become, DestroyTo

        sp = self.spaces[name]
        if self._tick_closure_epoch.get(name) == sp.epoch:
            return False
        grew = False
        i = 0
        while i < sp.palette_len():
            att = sp.evaluated(i).attributes
            op = att.tick_action
            if isinstance(op, (Become, DestroyTo)):
                before = sp.palette_len()
                sp.ensure_block(op.block)
                grew = grew or sp.palette_len() != before
            i += 1
        self._tick_closure_epoch[name] = sp.epoch
        return grew

    def _tick_plan(self, name: str):
        """Cached device tick plan for one space (device_step.py). The
        cache token is the palette length — palette growth or re-eval
        goes through resnapshot/_reindex_tick_actions, which rebuild the
        index this keys off."""
        from .device_step import compile_tick_plan

        sp = self.spaces[name]
        st = self.states.get(name)
        if st is None:
            return None
        if (
            self._intern_tick_closure(name)
            or sp.palette_len() > st.tables.padded_palette_size
        ):
            # The second arm enforces the invariant palette_len ≤ padded
            # size even when growth arrived through a path that did not
            # resnapshot.
            self.resnapshot(name)
            st = self.states[name]
        token = (sp.palette_len(), st.tables.padded_palette_size)
        cached = self._tick_plan_cache.get(name)
        if cached is not None and cached[0] == token:
            return cached[1]
        plan = compile_tick_plan(sp, st.tables.padded_palette_size)
        self._tick_plan_cache[name] = (token, plan)
        return plan

    def _reindex_tick_actions(self, name: str):
        """Index tick actions from EVALUATED attributes (space/step.rs
        reads EvaluatedBlock attributes — modifiers like Composite
        compose actions during evaluation, composite.rs:285)."""
        sp = self.spaces[name]
        acts = []
        for i in range(sp.palette_len()):
            att = sp.evaluated(i).attributes
            if att.tick_action is not None:
                acts.append((i, att.tick_action, att.tick_period))
        self._tick_action_index[name] = acts
        self._tick_plan_cache.pop(name, None)

    # -- stepping (universe.rs:314) ------------------------------------------

    def step(self, paused: bool = False) -> UniverseStepInfo:
        t0 = _time.perf_counter()
        tick = self.clock.advance(paused)
        info = UniverseStepInfo(tick=tick.ticks, bodies=len(self.body_space))
        if paused:
            return info
        prof = self.profiler

        # Implicit GC of unreferenced anonymous members each step
        # (universe/tests.rs gc_implicit; gc.rs:55).
        if any(self.is_anonymous(n) for n in self.member_names()):
            self.gc()

        # Synchronize: palette re-evaluation for changed BlockDefs
        # (space/step.rs:76). BlockDef.touch() bumps epoch; spaces
        # referencing stale defs re-evaluate + re-snapshot. Staleness is
        # decided ONCE before the loop: the first reevaluate_palette()
        # refreshes the shared BlockDef caches (eval marks _cache_epoch
        # fresh), which would otherwise hide the staleness from every
        # subsequent space.
        any_stale = any(
            bd._cache_epoch != bd.epoch
            for bd in self.block_defs.values()
            if bd._cache is not None
        )
        if any_stale:
            for name, sp in self.spaces.items():
                sp.reevaluate_palette()
                if name in self.states:  # stateless recur content spaces
                    self.resnapshot(name)

        # Step: tick actions (space/step.rs:114). A space whose actions
        # compile to a palette remap takes the device tick
        # (device_step.py): the remap, light-dirty marks, traversal-cell
        # rebuild and this tick's light rounds, with no host reads. The
        # host `Space.contents` mirror gets the same numpy remap so
        # host-side reads stay exact. Other spaces take the per-cube host
        # loop (Neighbors/StartMove/custom operations).
        device_ticked: set = set()
        with prof.span("tick_actions"):
            for name in self.spaces:
                # _tick_plan may intern tick-closure blocks, grow the
                # palette and resnapshot the device state: read the state
                # only afterwards, or device_tick gets the stale
                # pre-growth tables and clobbers the resnapshot.
                plan = self._tick_plan(name)
                st = self.states.get(name)
                if plan is not None and st is not None and st.light_enabled:
                    from .device_step import device_tick

                    new_st, stats = device_tick(
                        st,
                        plan,
                        tick.ticks,
                        light_rounds=self.light_rounds_per_tick,
                        light_batch=self.light_batch_size,
                    )
                    self.states[name] = new_st
                    self._apply_plan_host(name, plan, tick.ticks)
                    info.add_device_stats(stats)
                    device_ticked.add(name)
                else:
                    info.space_edits += self._run_tick_actions(name, tick)

        # Behaviors (space/step.rs:367,405).
        prof_behaviors = prof.span("behaviors")
        prof_behaviors.__enter__()
        pending = UniverseTransaction()
        still = []
        for entry in self.behaviors:
            host, behavior, wake = entry
            if tick.ticks < wake:
                still.append(entry)
                continue
            txn, then = behavior.step(self, host, tick)
            info.behaviors_run += 1
            if txn is not None:
                try:
                    pending = pending.merge(txn)
                except TransactionConflict:
                    pass  # conflicting behavior transactions are dropped
            if then == "step":
                still.append(entry)
            elif isinstance(then, int):
                entry[2] = tick.ticks + then
                still.append(entry)
            # "drop": not re-added
        self.behaviors = still
        for name, txn in pending.spaces.items():
            info.space_edits += self._commit(name, txn)
        prof_behaviors.__exit__(None, None, None)

        # Body physics (space/step.rs:68 body_physics_step_system).
        with prof.span("physics"):
            if self.bodies is not None and self.body_space:
                # All bodies collide against the first space they belong
                # to (per-space batching arrives with multi-space worlds).
                # A body's space may have been deleted — handles dangle
                # rather than block deletion (universe.rs delete + the
                # error_space_gone renderer contract); such bodies are
                # frozen by skipping physics when no host space remains.
                name = next((n for n in self.body_space if n in self.states), None)
                if name is not None:
                    state = self.states[name]
                    gravity = self.spaces[name].physics.gravity
                    self.bodies, phys_info = step_bodies(
                        state, self.bodies, tick.dt, gravity
                    )
                    # Ground contacts feed next step's jump gating
                    # (body.rs:309 is_on_ground reads the PREVIOUS
                    # step's collision output).
                    self.on_ground = phys_info["on_ground"]

        # Light updates (space/step.rs:338): fixed rounds per tick.
        # Device-ticked spaces already ran their rounds inside the device
        # tick (their edits from behaviors relight next tick via the
        # persistent dirty field).
        with prof.span("light"):
            for name in self.spaces:
                if name in device_ticked:
                    continue
                # Recur content spaces loaded from saves carry no device
                # state (io/save.py load_universe) — nothing to relight.
                st = self.states.get(name)
                if st is None or not st.light_enabled:
                    continue
                for _ in range(self.light_rounds_per_tick):
                    st, stats = light_update_round(st, batch_size=self.light_batch_size)
                    info.light_updates += int(stats["updated"])
                    info.light_queue = int(stats["queue_remaining"])
                self.states[name] = st

        info.wall_time_s = _time.perf_counter() - t0
        tele = getattr(self, "telemetry", None)
        if tele is not None:
            # One structured record per step with phase timings (logging.py
            # Telemetry); reading the device stats syncs, so only when on.
            tele.record(
                "universe_step",
                tick=info.tick,
                wall_ms=round(info.wall_time_s * 1000, 3),
                space_edits=info.space_edits,
                light_updates=info.light_updates,
                light_queue=info.light_queue,
                behaviors=info.behaviors_run,
                phases={k: round(v.total_s * 1000, 3) for k, v in self.profiler.spans.items()},
            )
        return info

    def _apply_plan_host(self, name: str, plan, ticks: int) -> None:
        """Mirror the device tick's palette remap onto the host
        `Space.contents` (one numpy take) so host-side consumers —
        cursor raycast, save/export, meshing — keep seeing the same
        world the device state holds."""
        sp = self.spaces[name]
        period = np.asarray(plan.period)
        if not period.any():
            return
        remap = np.asarray(plan.remap)
        fire = (period > 0) & (ticks % np.maximum(period, 1) == 0)
        if not fire.any():
            return
        eff = np.where(fire, remap, np.arange(remap.shape[0], dtype=remap.dtype))
        sp.contents = eff[sp.contents].astype(sp.contents.dtype)

    def _run_tick_actions(self, name: str, tick: Tick) -> int:
        """execute_tick_actions_system (space/step.rs:114): for each cube
        whose block has a tick_action whose schedule fires this tick,
        instantiate the Operation and merge-commit."""
        acts = self._tick_action_index.get(name, [])
        if not acts:
            return 0
        sp = self.spaces[name]
        contents = sp.contents
        merged: Optional[SpaceTransaction] = None
        for idx, op, period in acts:
            if tick.ticks % max(period, 1) != 0:
                continue
            positions = np.argwhere(contents == idx)
            for rel in positions:
                cube = tuple(int(r + l) for r, l in zip(rel, sp.bounds.lower))
                try:
                    txn = op.apply(sp, cube)
                except OperationFailed:
                    continue
                try:
                    merged = txn if merged is None else merged.merge(txn)
                except TransactionConflict:
                    continue  # conflicting actions are skipped (step.rs merge-or-conflict)
        if merged is None:
            return 0
        return self._commit(name, merged)

    def _commit(self, name: str, txn: SpaceTransaction) -> int:
        sp = self.spaces[name]
        try:
            txn.check(sp)
        except Exception:
            return 0
        pal_before = sp.palette_len()
        new_state = txn.commit(sp, self.states[name])
        if new_state is None:
            self.resnapshot(name)
        else:
            self.states[name] = new_state
            if sp.palette_len() != pal_before:
                # New palette entries may carry tick actions (a Become
                # chain interning its next frame) — the action index
                # must cover them even when the device state was
                # updated in place.
                self._reindex_tick_actions(name)
        self._emit_fluff(txn.fluff)
        return len(txn.cubes)

    def drain_fluff(self, consumer: str = "default") -> list:
        """Take momentary effects since this consumer's last drain
        (fluff.rs broadcast). The reference fans fluff out through
        `listen` notifiers to EVERY subscriber (sound playback AND the
        renderer's particle sets, gpu/in_wgpu/space.rs:1104); the cursor
        model here gives each named consumer (audio, particles, tests)
        its own independent drain of one shared log."""
        log = self.fluff_buffer
        cur = self._fluff_cursors.get(consumer, self._fluff_floor)
        out = [f for seq, f in log if seq >= cur]
        self._fluff_cursors[consumer] = self._fluff_seq
        # Bounded retention: keep the most recent 4096 entries so a
        # consumer appearing late (or draining slowly) still sees recent
        # events, while nothing pins unbounded history (fluff is
        # momentary — losing ancient entries is correct behavior).
        if len(log) > 4096:
            self.fluff_buffer = log[-4096:]
            self._fluff_floor = self.fluff_buffer[0][0]
        return out

    def _emit_fluff(self, items) -> None:
        for f in items:
            self.fluff_buffer.append((self._fluff_seq, f))
            self._fluff_seq += 1

    # -- garbage collection (universe/gc.rs:55) -----------------------------

