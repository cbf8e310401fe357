"""Traffic: edit and settle. Each event commits a seeded edit to the world
as a transaction through the program's own API (`UniverseTransaction`),
then relights it with `light/update.py::evaluate_light` to convergence,
the card synchronized; the next event reverts it, so the world stays the
template's. Edits, by share (`mix`, exact in every block of
`block_events`): one cube set to a lamp or an opaque
block of the world's own palette (`lamp_blocks`, `opaque_blocks`: saved
palette indices) or cleared to air; a 4x4x1 slab of an opaque block; a
12x12x1 wall section. An edit that marks more cubes dirty than the
program's dense threshold takes its dense passes, the others its queue
rounds; in the atrium every edit of this mix takes the queue.

The check replays each sampled event by the reference
(`reference/light.py`, written apart from the program): a seeded sample
of `sample_events` of the window's events is captured on the card (the
cubes, the light and its queue before the edit, and the cubes and light
after it settled; clones, no read-back). After the window the reference
applies each sampled edit to the cubes before it (which the program's
cubes after it have to equal exactly), marks the edited cubes and their
neighbours, and runs the light queue to empty from the program's light
before the event by its own pass. The share of cubes whose light differs
from the program's by more than `light_code_delta` codes and the largest
difference are compared. The start (the load relight) is compared with
the converged light `aic_tpu` computed for the same world, where the
configuration names that file.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from voxbench import harness, world
from voxbench.reference import light as ref_light
from voxbench.reference import world as ref_world

#: The control's relight and queue replay, whose 4-bit codes need not
#: settle, stop after at most these many passes and rounds; what they
#: hold then is the control's answer.
CONTROL_PASSES = 32
CONTROL_ROUNDS = 150


def edit_script(world_path, params: dict, seed: int, n: int):
    """[(cubes i64[k,3] world coordinates, kind, palette index)] of the
    first n edits; kind "single", "slab" or "wall"; palette index -1
    clears to air. The driver follows every edit by its revert. Every
    seed makes the same edits in blocks of `block_events`, each holding
    every kind in its share of `mix`; the seed orders each block and
    draws the places and blocks."""
    rng = harness.seed_rng(seed, "relight.edits")
    lower, contents, air = world.cube_grid(world_path)
    size = np.asarray(contents.shape)
    solid = np.argwhere(~air[contents]) + lower
    free = np.argwhere(air[contents]) + lower
    block_n = int(params["block_events"])
    block = [k for k, share in params["mix"].items() for _ in range(int(round(share * block_n)))]
    lamps, opaque = params["lamp_blocks"], params["opaque_blocks"]
    out = []
    while len(out) < n:
        for kind in (block[j] for j in rng.permutation(len(block))):
            out.append(_edit(kind, rng, params, lower, size, solid, free, lamps, opaque))
    return out[:n]


def _edit(kind, rng, params, lower, size, solid, free, lamps, opaque):
    if kind == "single":
        if rng.random() < 0.5:
            cube = free[rng.integers(len(free))]
            block = int(rng.choice(lamps if rng.random() < 0.5 else opaque))
        else:
            cube = solid[rng.integers(len(solid))]
            block = -1
        return cube[None, :], kind, block
    w = int(params["sizes"][kind])
    axis = int(rng.integers(0, 2)) * 2  # the plane's normal: x or z
    extent = np.array([w, w, w])
    extent[axis] = 1
    extent[1] = min(w, int(size[1]))
    origin = lower + np.array([rng.integers(0, max(int(size[a] - extent[a]), 0) + 1) for a in range(3)])
    grid = np.stack(np.meshgrid(*[np.arange(e) for e in extent], indexing="ij"), -1).reshape(-1, 3)
    return origin + grid, kind, int(rng.choice(opaque))


class Driver:
    def __init__(self, run: harness.Run, light_hook=None):
        self.run = run
        self.failed = 0
        #: A test's fault planted under the timed path: (event, state
        #: before it, settled state) -> state.
        self.light_hook = light_hook

    def setup(self) -> None:
        from aic_tpu_torch.io.save import load_universe
        from aic_tpu_torch.light.dense import evaluate_light_dense
        from aic_tpu_torch.light.update import evaluate_light
        from aic_tpu_torch.universe.transaction import SpaceTransaction, UniverseTransaction

        run = self.run
        path = run.world_path()
        if "world" not in run.overrides:
            world.verify(path, run.cell.config["world"])
        self.evaluate_light = evaluate_light
        self.txn = (SpaceTransaction, UniverseTransaction)
        self.name = run.param("space", "world")
        u = load_universe(str(path), device=run.device)
        u.states[self.name], _ = evaluate_light_dense(u.states[self.name])
        self.lit = u.states[self.name].light.clone()
        self.u = u
        self.sp = u.spaces[self.name]
        self.lower = np.asarray(self.sp.bounds.lower)
        self.edits = edit_script(path, run.cell.traffic | run.overrides, run.seed, int(run.param("script_events")))
        self.revert = None  # (cubes, blocks) that undo the last edit
        self.k = 0
        self.event_ms: list = []
        self.kinds: list = []
        self.updates: list = []
        self.sample = harness.Reservoir(int(run.param("sample_events")), harness.seed_rng(run.seed, "relight.sample"))
        air = world.cube_grid(path, self.name)[2]
        if self.sp.palette_len() != len(air):
            raise ValueError("the loaded palette is not the saved one: the edits' block indices would be wrong")
        self.air_index = int(np.flatnonzero(air)[0])
        # Warm: one edit of each kind and its revert.
        for kind in (k for k, share in run.param("mix").items() if share > 0):
            cubes, _, block = next(e for e in self.edits if e[1] == kind)
            _, old = self._apply(cubes, np.full(len(cubes), block))
            self._apply(cubes, old)
        if run.device == "cuda":
            torch.cuda.synchronize()

    def _apply(self, cubes, blocks):
        """Commit cubes := blocks (palette indices, -1 air) as one
        transaction and relight to convergence; returns (cube updates,
        the blocks that were there)."""
        from aic_tpu_torch.block import AIR

        SpaceTransaction, UniverseTransaction = self.txn
        sp = self.sp
        rel = cubes - self.lower
        old = sp.contents[rel[:, 0], rel[:, 1], rel[:, 2]].astype(np.int64)
        palette = sp.palette
        txn = SpaceTransaction()
        for c, b in zip(cubes, blocks):
            txn = txn.merge(SpaceTransaction.set_cube(c, new=AIR if b < 0 else palette[int(b)], conserved=False))
        UniverseTransaction(spaces={self.name: txn}).execute(self.u)
        st, updates = self.evaluate_light(self.u.states[self.name])
        self.u.states[self.name] = st
        return int(updates), old

    def tracing(self, on: bool) -> None:
        pass

    def unit(self, i: int) -> None:
        if self.revert is not None:
            cubes, blocks = self.revert
            kind = "revert"
        else:
            cubes, kind, block = self.edits[self.k % len(self.edits)]
            blocks = np.full(len(cubes), block)
            self.k += 1
        slot = self.sample.wants()
        prev = st = self.u.states[self.name]
        before = None if slot is None else (st.contents.clone(), st.light.clone(), st.light_dirty.clone())
        t0 = time.perf_counter()
        updates, old = self._apply(cubes, blocks)
        self.revert = None if self.revert is not None else (cubes, old)
        st = self.u.states[self.name]
        if self.light_hook is not None:
            st = self.light_hook(i, prev, st)
            self.u.states[self.name] = st
        if self.run.device == "cuda":
            torch.cuda.synchronize()
        self.event_ms.append((time.perf_counter() - t0) * 1e3)
        self.kinds.append(kind)
        self.updates.append(updates)
        if slot is not None:
            edit = (cubes - self.lower, np.where(np.asarray(blocks) < 0, self.air_index, blocks))
            self.sample.put(slot, (before, edit, (st.contents.clone(), st.light.clone()), self.sp.palette_len()))

    def window_closed(self) -> None:
        self.run.counters["relight_cube_updates"] = float(np.mean(self.updates)) if self.updates else None

    def diagnostics(self) -> dict:
        """Where the window's time went, for reading a run's spread: mean
        ms and count of each kind of event, in the window's first and
        second half."""
        half = len(self.event_ms) // 2
        out = {}
        for part, sl in (("first", slice(0, half)), ("second", slice(half, None))):
            ms, kinds = self.event_ms[sl], self.kinds[sl]
            for k in sorted(set(kinds)):
                v = [m for m, kk in zip(ms, kinds) if kk == k]
                out[f"{part}.{k}"] = [len(v), float(np.mean(v))]
        return out

    def attempted(self) -> int:
        return self.run.units

    def end_to_end(self) -> dict:
        return {"relight_ms": self.run.window_s * 1e3 / max(self.run.units, 1)}

    def check(self) -> dict:
        run = self.run
        del self.u, self.sp
        gc.collect()
        if run.device == "cuda":
            torch.cuda.empty_cache()
        self.world = ref_world.load(run.world_path(), self.name)
        delta = int(run.param("light_code_delta"))
        self.wants = [self._replay(s, "float32") for s in self.sample.items]
        edit_off, pct, codes = [], 0.0, 0.0
        for s, want in zip(self.sample.items, self.wants):
            edit_off.append(self._edit_off(s))
            p_, c_ = light_off(s[2][1], want, delta)
            pct, codes = max(pct, p_), max(codes, c_)
        if not self.sample.items:
            self.failed = 1
        p = run.param
        checks = {
            "edit_cubes_off": {"value": max(edit_off, default=float("inf")),
                               "limit": float(p("limit_edit_cubes_off"))},
            "light_cubes_off_pct": {"value": pct, "limit": float(p("limit_cubes_off_pct"))},
            "light_codes_off": {"value": codes, "limit": float(p("limit_light_codes"))},
        }
        golden = self._golden()
        if golden is not None:
            pct, codes = light_off(self.lit, golden, delta)
            checks["start_cubes_off_pct"] = {"value": pct, "limit": float(p("limit_start_cubes_off_pct"))}
            checks["start_codes_off"] = {"value": codes, "limit": float(p("limit_start_codes"))}
        return checks

    def _golden(self):
        """`aic_tpu`'s converged light of the configured world, packed
        u8[X,Y,Z,4] on the run's device, or None (a rehearsal's world)."""
        cfg = self.run.cell.config.get("light_golden")
        if cfg is None or "world" in self.run.overrides:
            return None
        path = harness.ROOT / cfg["file"]
        world.verify(path, cfg)
        with np.load(path) as f:
            return torch.as_tensor(f["light"], device=self.run.device)

    def _expected(self, sample):
        """The reference's edit of the sampled event's state before it: the
        cubes, and the queue with the edited cubes and their neighbours
        marked; None where the palette is not the reference's."""
        (contents, _, dirty), (rel, blocks), _, palette_len = sample
        if palette_len != self.world.palette_len:
            return None
        dev = contents.device
        cubes = contents.long().clone()
        r = torch.as_tensor(np.asarray(rel), dtype=torch.int64, device=dev)
        cubes[r[:, 0], r[:, 1], r[:, 2]] = torch.as_tensor(np.asarray(blocks), dtype=torch.int64, device=dev)
        marked = dirty.clone()
        size = torch.as_tensor(cubes.shape, device=dev)
        for d in [(0, 0, 0)] + [tuple(n) for n in ref_light.NORMALS]:
            q = r + torch.as_tensor(d, device=dev)
            q = q[((q >= 0) & (q < size)).all(-1)]
            marked[q[:, 0], q[:, 1], q[:, 2]] = 255
        return cubes, marked

    def _edit_off(self, sample) -> float:
        exp = self._expected(sample)
        if exp is None:
            return float("inf")
        got = sample[2][0].to(exp[0].device).long()  # the program's cubes after the event
        return float((got != exp[0]).sum())

    def _replay(self, sample, precision: str):
        """The reference's settled light after a sampled event, from the
        program's state before it; None where it cannot follow."""
        exp = self._expected(sample)
        if exp is None:
            return None
        cubes, marked = exp
        rounds = CONTROL_ROUNDS if precision == "lower" else 100000
        light, _ = ref_light.settle(self.world.with_contents(cubes), sample[0][1], marked, precision, rounds)
        return light

    def control(self) -> dict:
        """The check's numbers with the reference one precision step down
        put in the program's place (after `check`): its own relight of
        the world from nothing, and its replay of each sampled event."""
        dev = self.run.device
        delta = int(self.run.param("light_code_delta"))
        pct, codes = 0.0, 0.0
        for s, want in zip(self.sample.items, self.wants):
            p_, c_ = light_off(self._replay(s, "lower"), want, delta)
            pct, codes = max(pct, p_), max(codes, c_)
        out = {"edit_cubes_off": 0.0, "light_cubes_off_pct": pct, "light_codes_off": codes}
        golden = self._golden()
        if golden is not None:
            w = self.world
            dark = torch.zeros(tuple(w.contents.shape) + (4,), dtype=torch.uint8, device=dev)
            start, _ = ref_light.relight(w.with_contents(w.contents.to(dev)), dark, "lower", CONTROL_PASSES)
            out["start_cubes_off_pct"], out["start_codes_off"] = light_off(start, golden, delta)
        return out


def light_off(got, want, delta: int):
    """(share % of cubes whose packed light differs by more than `delta`
    codes in some channel or in status, the largest difference)."""
    if got is None or want is None:
        return float("inf"), float("inf")
    diff = ref_light.codes_apart(got, want.to(got.device))
    return float((diff > delta).float().mean()) * 100.0, float(diff.max())
