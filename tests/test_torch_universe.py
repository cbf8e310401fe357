"""The port's step loop (aic_tpu_torch.universe, content.build_universe,
main --graphics headless) against `aic_tpu`, mirroring
tests/test_device_step.py and tests/test_physics_universe.py::TestUniverse.

A small world with a ticking block (a Become cycle), a behavior that
places and removes a block, and a player steps N ticks in both packages
from the same relit state (`aic_tpu`'s, handed to the port's universe):
contents equal every tick, bodies within tests/test_torch_physics.py's
tolerance and `on_ground` equal, light within one packed step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import aic_tpu.universe as jU
import aic_tpu_torch.universe as tU
from aic_tpu.content.exhibits import _become_cycle as j_become_cycle
from aic_tpu.light import evaluate_light as j_evaluate_light
from aic_tpu_torch.content.exhibits import _become_cycle as t_become_cycle
from aic_tpu_torch.universe.device_step import compile_tick_plan, device_tick
from test_torch_physics import ATOL, RTOL
from test_torch_state import PKGS, to_port

PK = {"jax": (PKGS["jax"], jU, j_become_cycle), "torch": (PKGS["torch"], tU, t_become_cycle)}


def _world(pkg, period=2, size=(10, 8, 10)):
    """Floor, two walls, an emissive block and a two-frame Become cycle
    (period `period`) on two cubes, under a sky."""
    p, _U, cycle = PK[pkg]
    b = p.block
    sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), size),
                 physics=p.SpacePhysics(sky=p.Sky.uniform((0.5, 0.6, 0.8)), light_max_distance=8))
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (size[0], 1, size[2])), b.from_color((0.5, 0.5, 0.5, 1.0), "floor"))
    sp.fill(p.GridAab.from_lower_size((7, 1, 1), (1, 4, 6)), b.from_color((0.8, 0.3, 0.2, 1.0), "wall"))
    sp.set((2, 3, 2), b.from_color((1.0, 1.0, 1.0, 1.0), "lamp", emission=(3.0, 3.0, 2.5)))
    red = b.from_color((0.9, 0.1, 0.1, 1.0), "red")
    green = b.from_color((0.1, 0.9, 0.1, 1.0), "green")
    frames = cycle([red, green], period)
    sp.set((4, 2, 4), frames[0])
    sp.set((5, 2, 4), frames[1])
    sp.spawn_position = np.array([3.5, 4.0, 6.5])
    return sp


def _placer(pkg, every=3):
    """A behavior that places a floor block at (3, 1, 3) and removes it
    again, every `every` ticks: blocks the palette holds, so its commits
    scatter onto the device state."""
    p, U, _ = PK[pkg]

    class Placer(U.Behavior):
        def step(self, universe, host, tick):
            sp = universe.spaces[host]
            cube = (3, 1, 3)
            cur = sp.block_at(cube)
            new = p.block.AIR if cur != p.block.AIR else sp.block_at((3, 0, 3))
            txn = U.SpaceTransaction.set_cube(cube, old=cur, new=new)
            return U.UniverseTransaction(spaces={host: txn}), every

    return Placer()


@functools.lru_cache(maxsize=None)
def _lit_world(period):
    """`aic_tpu`'s relight of the world's snapshot, computed once per
    period and shared by every `_universes` call of the module (a state
    is immutable: each universe replaces it, never writes into it)."""
    lit, _ = j_evaluate_light(_world("jax", period).snapshot())
    return lit


def _universes(period=2, behavior=True):
    """Both packages' universes over the same relit world state."""
    out = {}
    for pkg in ("jax", "torch"):
        p, U, _ = PK[pkg]
        u = U.Universe(device="cpu") if pkg == "torch" else U.Universe()
        u.insert_space("world", _world(pkg, period))
        u.insert_character("player", "world", (3.5, 4.0, 6.5))
        if behavior:
            u.add_behavior("world", _placer(pkg))
        out[pkg] = u
    lit = _lit_world(period)
    out["jax"].states["world"] = lit
    out["torch"].states["world"] = to_port(lit)
    return out["jax"], out["torch"]


def _assert_same(uj, ut, what):
    sj, st = uj.states["world"], ut.states["world"]
    np.testing.assert_array_equal(st.contents.numpy(), np.asarray(sj.contents).astype(np.int32), err_msg=what)
    np.testing.assert_array_equal(ut.spaces["world"].contents, uj.spaces["world"].contents, err_msg=what)
    a, b = st.light.numpy().astype(np.int32), np.asarray(sj.light).astype(np.int32)
    assert int(np.abs(a[..., :3] - b[..., :3]).max()) <= 1, what
    np.testing.assert_array_equal(a[..., 3], b[..., 3], err_msg=what)
    np.testing.assert_allclose(ut.bodies.position.numpy(), np.asarray(uj.bodies.position), atol=ATOL, rtol=RTOL,
                               err_msg=what)
    np.testing.assert_allclose(ut.bodies.velocity.numpy(), np.asarray(uj.bodies.velocity), atol=ATOL, rtol=RTOL,
                               err_msg=what)
    np.testing.assert_array_equal(ut.on_ground.numpy(), np.asarray(uj.on_ground), err_msg=what)


def test_ticks_match_aic_tpu():
    """10 ticks: the Become cycle fires on the device path, the behavior
    commits, the player falls and lands, the light queue runs."""
    uj, ut = _universes()
    for i in range(10):
        ij = uj.step()
        it = ut.step()
        _assert_same(uj, ut, f"tick {i}")
        assert it.space_edits == ij.space_edits, i
        assert it.light_updates == ij.light_updates, i
    assert ut.spaces["world"].palette_len() == uj.spaces["world"].palette_len()
    # The host mirror of the device universe matches its device state.
    np.testing.assert_array_equal(ut.spaces["world"].contents.astype(np.int32), ut.states["world"].contents.numpy())


def test_host_path_ticks_match_aic_tpu():
    """The same 10 ticks with both packages forced onto the per-cube host
    path for the tick actions."""
    uj, ut = _universes()
    uj._tick_plan = ut._tick_plan = lambda name: None
    for i in range(10):
        uj.step()
        ut.step()
        _assert_same(uj, ut, f"tick {i}")


@pytest.mark.parametrize("path", ["device", "host"])
def test_rounds_stop_where_the_queue_is_known_empty(path, monkeypatch):
    """The device tick and the host path run no light round on a queue
    known to be empty (`queue_known_empty`: `evaluate_light` or the round
    that emptied it counted 0), and leave the states that a round on
    every tick leaves, bit for bit."""
    from aic_tpu_torch.light import update
    from aic_tpu_torch.universe import device_step
    from aic_tpu_torch.universe import universe as tuniverse

    def run(known_empty):
        u = _universes(period=16, behavior=False)[1]
        if path == "host":
            u._tick_plan = lambda name: None
        u.states["world"], _ = update.evaluate_light(u.states["world"])
        rounds = []

        def counted(st, batch_size):
            rounds.append(1)
            return update.light_update_round(st, batch_size=batch_size)

        monkeypatch.setattr(device_step, "light_update_round", counted)
        monkeypatch.setattr(tuniverse, "light_update_round", counted)
        monkeypatch.setattr(device_step, "queue_known_empty", known_empty)
        monkeypatch.setattr(tuniverse, "queue_known_empty", known_empty)
        updates = [u.step().light_updates for _ in range(20)]
        return u.states["world"], updates, len(rounds)

    skipped, updates, n = run(update.queue_known_empty)
    every, updates_every, n_every = run(lambda state: False)
    assert n_every == 20 and 0 < n < n_every
    assert updates == updates_every
    for name in ("contents", "light", "light_dirty", "cells"):
        assert torch.equal(getattr(skipped, name), getattr(every, name)), name


class TestDeviceHostEquivalence:
    def _step_both(self, steps=4, period=1):
        ud = _universes(period, behavior=False)[1]
        uh = _universes(period, behavior=False)[1]
        uh._tick_plan = lambda name: None
        for _ in range(steps):
            ud.step()
            uh.step()
        return ud, uh

    def test_contents_and_light_match_after_steps(self):
        """Device tick and host path: contents equal, light within one
        packed step, the host mirror equal to the device contents."""
        ud, uh = self._step_both(steps=4)
        dev, host = ud.states["world"], uh.states["world"]
        assert torch.equal(dev.contents, host.contents)
        assert torch.equal(dev.cells, host.cells)
        d = (dev.light.to(torch.int32) - host.light.to(torch.int32)).abs()
        assert int(d[..., :3].max()) <= 1 and int(d[..., 3].max()) == 0
        np.testing.assert_array_equal(ud.spaces["world"].contents.astype(np.int32), dev.contents.numpy())

    def test_period_respected(self):
        u = _universes(period=3, behavior=False)[1]
        u.step()  # tick 0: every schedule fires
        fired0 = u.states["world"].contents.clone()
        u.step()
        u.step()
        assert torch.equal(fired0, u.states["world"].contents)
        u.step()  # tick 3 fires
        assert not torch.equal(fired0, u.states["world"].contents)

    def test_stats_are_lazy_but_correct(self):
        u = _universes(period=1, behavior=False)[1]
        info = u.step()
        assert info._device_stats  # held as tensors until read
        assert info.space_edits == 2  # the two cycle cubes swap
        assert info.light_updates >= 0

    def test_dirty_marks_cover_neighbors(self):
        u = _universes(period=1, behavior=False)[1]
        st0 = dataclasses.replace(u.states["world"], light_dirty=torch.zeros_like(u.states["world"].light_dirty))
        plan = u._tick_plan("world")
        st1, stats = device_tick(st0, plan, 1, light_rounds=0, light_batch=16)
        dirty = st1.light_dirty > 0
        assert dirty[4, 2, 4] and dirty[5, 2, 4] and dirty[3, 2, 4] and dirty[4, 1, 4] and dirty[4, 2, 3]
        assert int(stats["edits"]) == 2


class TestPlans:
    def test_become_cycle_compiles_and_matches_aic_tpu(self):
        plans = {}
        for pkg in ("jax", "torch"):
            sp = _world(pkg)
            st = sp.snapshot(device="cpu") if pkg == "torch" else sp.snapshot()
            mod = compile_tick_plan if pkg == "torch" else __import__(
                "aic_tpu.universe.device_step", fromlist=["compile_tick_plan"]).compile_tick_plan
            plans[pkg] = mod(sp, st.tables.padded_palette_size)
        np.testing.assert_array_equal(plans["torch"].remap, np.asarray(plans["jax"].remap))
        np.testing.assert_array_equal(plans["torch"].period, np.asarray(plans["jax"].period))
        assert plans["torch"].actions == plans["jax"].actions and plans["torch"].actions

    def test_custom_operation_falls_back(self):
        p, U, _ = PK["torch"]

        @dataclasses.dataclass(frozen=True)
        class Weird(U.Operation):
            def apply(self, space, cube):
                raise U.OperationFailed("nope")

        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (4, 4, 4)))
        sp.set((1, 1, 1), p.block.from_color((0.2, 0.2, 0.9, 1.0), "w").with_attributes(tick_action=Weird()))
        u = U.Universe(device="cpu")
        u.insert_space("w", sp)
        assert u._tick_plan("w") is None
        u.step()  # the host path runs the failing operation: no edit

    def test_palette_growth_past_padding_resnapshots(self):
        """A Become chain whose frames are not interned yet grows the
        palette past the device tables' padding: the invariant
        palette_len <= padded size holds after every step."""
        p, U, _ = PK["torch"]
        b = p.block
        sp = p.Space(p.GridAab.from_lower_size((0, 0, 0), (6, 6, 6)))
        for i in range(7):
            sp.set((i % 6, 0, 0), b.from_color((0.1 + i * 0.1, 0.2, 0.3, 1.0), f"fill{i}"))
        pal0 = sp.palette_len()
        frames = [b.from_color((0.9, 0.05 * i, 0.1, 1.0), f"f{i}") for i in range(6)]
        chain = [f.with_attributes(tick_action=U.Become(frames[(i + 1) % 6])) for i, f in enumerate(frames)]
        for i in range(len(chain) - 1):
            chain[i] = chain[i].with_attributes(tick_action=U.Become(chain[i + 1]))
        sp.set((5, 5, 5), chain[0])
        u = U.Universe(device="cpu")
        u.insert_space("w", sp)
        for _ in range(8):
            u.step()
            assert u.spaces["w"].palette_len() <= u.states["w"].tables.padded_palette_size
        assert u.spaces["w"].palette_len() > pal0

    def test_behavior_commit_growth_resnapshots(self):
        """A behavior interning a new block every tick: the commit returns
        None and the universe resnapshots, so the new palette rows are
        live on the device."""
        p, U, _ = PK["torch"]
        u = U.Universe(device="cpu")
        u.insert_space("w", p.Space(p.GridAab.from_lower_size((0, 0, 0), (6, 6, 6))))

        class Grower(U.Behavior):
            n = 0

            def step(self, universe, host, tick):
                blk = p.block.from_color((0.2, 0.3, 0.1 + 0.05 * Grower.n, 1.0), f"grown{Grower.n}")
                txn = U.SpaceTransaction.set_cube((Grower.n % 6, 1, 1), new=blk)
                Grower.n += 1
                return U.UniverseTransaction(spaces={host: txn}), "step"

        u.add_behavior("w", Grower())
        for i in range(6):
            u.step()
            st = u.states["w"]
            idx = int(st.contents[i % 6, 1, 1])
            assert float(st.tables.face_colors[idx, 6, 3]) > 0.0


def test_universe_members_and_gc():
    """Membership, names and the implicit collection of anonymous members."""
    p, U, _ = PK["torch"]
    u = U.Universe(device="cpu")
    u.insert_space("a", p.Space(p.GridAab.cube(2)))
    with pytest.raises(ValueError):
        u.insert_space("a", p.Space(p.GridAab.cube(2)))
    anon = u.insert_anonymous(p.Space(p.GridAab.cube(2)))
    assert U.Universe.is_anonymous(anon)
    with pytest.raises(ValueError):
        u.delete(anon)
    u.step()  # gc: nothing refers to the anonymous space
    assert anon not in u.spaces and "a" in u.spaces
    u.delete("a")
    with pytest.raises(KeyError):
        u.delete("a")


def test_stale_blockdef_reevaluates_every_space():
    p, U, _ = PK["torch"]
    b = p.block
    bd = b.BlockDef(b.from_color((1, 0, 0, 1)))
    indirect = b.Block(b.Indirect(bd))
    u = U.Universe(device="cpu")
    u.light_rounds_per_tick = 0
    for name in ("a", "b"):
        sp = p.Space(p.GridAab.cube(4))
        sp.set((1, 1, 1), indirect)
        u.insert_space(name, sp)
    u.block_defs["bd"] = bd
    u.step()
    bd.redefine(b.from_color((0, 1, 0, 1)))
    u.step()
    for name in ("a", "b"):
        sp = u.spaces[name]
        np.testing.assert_allclose(sp.evaluated(sp.index_at((1, 1, 1))).color[:3], [0, 1, 0], atol=1e-5)


def test_build_universe_matches_aic_tpu():
    """`build_universe` makes the template's world and a player at its
    spawn point, as `aic_tpu`'s does."""
    from aic_tpu.content import TemplateParameters as JParams
    from aic_tpu.content import build_universe as j_build
    from aic_tpu_torch.content import TemplateParameters, build_universe

    uj = j_build("cornell-box", JParams(size=12))
    ut = build_universe("cornell-box", TemplateParameters(size=12), device="cpu")
    np.testing.assert_array_equal(ut.spaces["world"].contents, uj.spaces["world"].contents)
    np.testing.assert_array_equal(ut.states["world"].contents.numpy(), np.asarray(uj.states["world"].contents))
    np.testing.assert_allclose(ut.bodies.position.numpy(), np.asarray(uj.bodies.position))
    assert list(ut.characters) == list(uj.characters) == ["player"]


def test_main_headless_steps_on_the_cpu(capsys):
    """`main --graphics headless --device cpu` relights through
    `evaluate_light` (dense: the fresh world is all dirty) and steps
    int(duration * 60) ticks."""
    from aic_tpu_torch import main

    main.main(["--template", "cornell-box", "--size", "12", "--graphics", "headless", "--duration", "0.1",
               "--device", "cpu"])
    err = capsys.readouterr().err
    assert "[light]" in err and "cube updates" in err
    assert "[headless] 6 ticks" in err


def test_main_refuses_cuda_without_a_card(monkeypatch):
    from aic_tpu_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main.main(["--graphics", "headless", "--duration", "0.1"])


def test_step_loop_modules_leave_out_jax():
    """The step loop's modules, the content, text, tools and widgets
    modules that demo-city pulls in, the session, voxel UI, save/load
    and frontends, and the mesher, exports, record script and audio,
    import no JAX, not even through `aic_tpu`."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys; import aic_tpu_torch.universe, aic_tpu_torch.physics, aic_tpu_torch.light.update, "
        "aic_tpu_torch.content.template, aic_tpu_torch.content.exhibits, aic_tpu_torch.io.whence, "
        "aic_tpu_torch.profiling, aic_tpu_torch.universe.device_step, aic_tpu_torch.universe.cursor, "
        "aic_tpu_torch.content, aic_tpu_torch.content.city, aic_tpu_torch.content.alg, "
        "aic_tpu_torch.content.landscape, aic_tpu_torch.content.testing, aic_tpu_torch.content.fractal, "
        "aic_tpu_torch.content.linking, aic_tpu_torch.text, aic_tpu_torch.text.font, aic_tpu_torch.text.layout, "
        "aic_tpu_torch.text.sysfont, aic_tpu_torch.math.octant, aic_tpu_torch.math.chunking, "
        "aic_tpu_torch.space.drawing, aic_tpu_torch.vui, aic_tpu_torch.vui.widgets, aic_tpu_torch.vui.layout, "
        "aic_tpu_torch.vui.hud, aic_tpu_torch.vui.page, aic_tpu_torch.vui.controller, aic_tpu_torch.vui.notification, "
        "aic_tpu_torch.apps, aic_tpu_torch.apps.session, aic_tpu_torch.apps.settings, aic_tpu_torch.apps.server, "
        "aic_tpu_torch.apps.terminal, aic_tpu_torch.apps.window, aic_tpu_torch.io, aic_tpu_torch.io.save, "
        "aic_tpu_torch.io.vox, aic_tpu_torch.universe.sound, aic_tpu_torch.debug, aic_tpu_torch.logging, "
        "aic_tpu_torch.main, aic_tpu_torch.mesh, aic_tpu_torch.mesh.mesher, aic_tpu_torch.mesh.atlas, "
        "aic_tpu_torch.mesh.dynamic, aic_tpu_torch.native, aic_tpu_torch.io.export, "
        "aic_tpu_torch.apps.record_script, aic_tpu_torch.apps.audio; "
        "from aic_tpu_torch.content import build_template_space, TemplateParameters; "
        "build_template_space('menger-sponge', TemplateParameters()); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'aic_tpu.')) or m == 'aic_tpu']; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
