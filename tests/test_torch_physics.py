"""The port's body physics (aic_tpu_torch.physics) against `aic_tpu`,
mirroring tests/test_physics_universe.py::TestBodyStep and TestJumping.

The same bodies step in both packages' worlds, on the port's CPU
tensors. Both work in f32 with the same operations, in another
framework's kernels: positions and velocities are held to ATOL after
every step, or to RTOL (two f32 ulps) for a body thousands of cubes
away, and `on_ground` exactly.
"""

import numpy as np
import pytest
import torch

from aic_tpu.physics import Body as JBody
from aic_tpu.physics import body as jbody
from aic_tpu.physics import step_bodies as jstep
from aic_tpu_torch.physics import Body as TBody
from aic_tpu_torch.physics import body as tbody
from aic_tpu_torch.physics import body_from_numpy, body_to_numpy
from aic_tpu_torch.physics import step_bodies as tstep
from test_torch_state import PKGS, to_port

#: Positions (cubes) and velocities (cubes/s) after each step.
ATOL = 1e-4
RTOL = 2.4e-7
GRAVITY = (0.0, -20.0, 0.0)
DT = 1 / 60


def floor_space(p, size=8):
    sp = p.Space(p.GridAab.cube(size), physics=p.SpacePhysics(sky=p.Sky.uniform((1, 1, 1))))
    sp.fill(p.GridAab.from_lower_size((0, 0, 0), (size, 1, size)), p.block.from_color((0.5, 0.5, 0.5, 1.0)))
    return sp


def wall_space(p):
    sp = floor_space(p)
    sp.fill(p.GridAab.from_lower_size((6, 1, 0), (1, 7, 8)), p.block.from_color((1, 0, 0, 1)))
    return sp


def voxel_step_space(p):
    """A floor with an R4 voxel step (its lower half solid) to walk onto."""
    sp = floor_space(p)
    r = 4
    inner = p.Space(p.GridAab.cube(r))
    inner.fill(p.GridAab.from_lower_size((0, 0, 0), (r, r // 2, r)), p.block.from_color((0.2, 0.6, 0.9, 1.0)))
    sp.set((5, 1, 4), p.block.Block(p.block.Recur(space=inner, resolution=r)))
    return sp


WORLDS = {"floor": floor_space, "wall": wall_space, "voxel_step": voxel_step_space}

#: Bodies as Body.make keyword arguments.
BODIES = {
    "falling": dict(position=(4.0, 4.0, 4.0)),
    "walking": dict(position=(2.0, 1.0, 4.0), velocity=(4.0, 0.0, 0.0)),
    "diagonal": dict(position=(3.0, 2.5, 3.0), velocity=(3.0, 1.0, 2.0)),
    "flying": dict(position=(4.0, 4.0, 4.0), flying=True, velocity=(0.5, 0.0, -0.25)),
    "noclip": dict(position=(4.0, 2.0, 4.0), velocity=(0.0, -8.0, 0.0), noclip=True, flying=True),
}


def _states(world):
    jsp = WORLDS[world](PKGS["jax"])
    jst = jsp.snapshot()
    return jst, to_port(jst)


def _batches(names):
    j = JBody.stack([JBody.make(**BODIES[n]) for n in names])
    t = TBody.stack([TBody.make(**BODIES[n], device="cpu") for n in names])
    return j, t


def _assert_close(tb, jb, info_t, info_j, what):
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position), atol=ATOL, rtol=RTOL, err_msg=what)
    np.testing.assert_allclose(tb.velocity.numpy(), np.asarray(jb.velocity), atol=ATOL, rtol=RTOL, err_msg=what)
    np.testing.assert_array_equal(info_t["on_ground"].numpy(), np.asarray(info_j["on_ground"]), err_msg=what)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_step_bodies_matches_aic_tpu(world):
    """All bodies batched, 60 steps: positions, velocities and on_ground
    after every step (falling and landing, sliding into a wall and along
    a voxel step, flying, noclip)."""
    jst, tst = _states(world)
    names = sorted(BODIES)
    jb, tb = _batches(names)
    for i in range(60):
        jb, ij = jstep(jst, jb, DT, GRAVITY)
        tb, it = tstep(tst, tb, DT, GRAVITY)
        _assert_close(tb, jb, it, ij, f"step {i}")
    pos = tb.position.numpy()
    assert pos[names.index("falling"), 1] == pytest.approx(1.0, abs=0.01)
    assert pos[names.index("noclip"), 1] < 0.0


def test_velocity_clamp_matches_aic_tpu():
    """A body at 3e4 cubes/s is clamped to 1e4 and moves 167 one-cube
    segments a step beside a resting one, in both packages."""
    jst, tst = _states("floor")
    fast = dict(position=(4.0, 6.0, 4.0), velocity=(0.0, 0.0, 3e4), flying=True)
    jb = JBody.stack([JBody.make(**fast), JBody.make(**BODIES["falling"])])
    tb = TBody.stack([TBody.make(**fast, device="cpu"), TBody.make(**BODIES["falling"], device="cpu")])
    for i in range(2):
        jb, ij = jstep(jst, jb, DT, GRAVITY)
        tb, it = tstep(tst, tb, DT, GRAVITY)
        _assert_close(tb, jb, it, ij, f"step {i}")
    assert np.linalg.norm(tb.velocity.numpy()[0]) <= 1e4 + 1.0


def test_jump_only_from_ground():
    """TestJumping: a body settled on the floor jumps (upward velocity set
    while on_ground), rises, falls back and lands in both packages."""
    jst, tst = _states("floor")
    jb, tb = _batches(["falling"])
    for _ in range(60):
        jb, ij = jstep(jst, jb, DT, GRAVITY)
        tb, it = tstep(tst, tb, DT, GRAVITY)
    assert bool(it["on_ground"][0]) and bool(np.asarray(ij["on_ground"])[0])
    jb = jb.set_velocity(np.asarray([[0.0, 8.0, 0.0]], np.float32))
    tb = tb.set_velocity([[0.0, 8.0, 0.0]])
    landed = False
    for i in range(90):
        jb, ij = jstep(jst, jb, DT, GRAVITY)
        tb, it = tstep(tst, tb, DT, GRAVITY)
        _assert_close(tb, jb, it, ij, f"jump step {i}")
        if i == 0:
            assert not bool(it["on_ground"][0]) and float(tb.velocity[0, 1]) > 0.0
        landed = landed or (i > 0 and bool(it["on_ground"][0]))
    assert landed


def test_recovery_matches_aic_tpu():
    """A body stuck inside the floor is pushed out and a squeezed body's
    occupying box crushed and regrown: push_out, crush_if_colliding,
    uncrush and the step's recovery pass against `aic_tpu`'s."""
    jst, tst = _states("wall")
    kw = dict(position=(5.9, 0.5, 4.0), velocity=(0.0, -1.0, 0.0))
    crushed = dict(position=(3.0, 1.0, 3.0), occ_lo=(-0.1, 0.0, -0.1), occ_hi=(0.1, 1.0, 0.1))
    jb = JBody.stack([JBody.make(**kw), JBody.make(**crushed)])
    tb = TBody.stack([TBody.make(**kw, device="cpu"), TBody.make(**crushed, device="cpu")])
    for jfn, tfn in ((jbody.push_out, tbody.push_out), (jbody.crush_if_colliding, tbody.crush_if_colliding),
                     (jbody.uncrush, tbody.uncrush)):
        jr, tr = jfn(jst, jb), tfn(tst, tb)
        for k in ("position", "occ_lo", "occ_hi"):
            np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                       err_msg=f"{jfn.__name__} {k}")
    assert float(tbody.push_out(tst, tb).position[0, 1]) > 0.99  # out of the floor
    for i in range(3):
        jb, ij = jstep(jst, jb, DT, GRAVITY)
        tb, it = tstep(tst, tb, DT, GRAVITY)
        _assert_close(tb, jb, it, ij, f"recovery step {i}")
        np.testing.assert_allclose(tb.occ_hi.numpy(), np.asarray(jb.occ_hi), atol=ATOL, rtol=0)


def test_body_from_numpy_round_trip():
    """An `aic_tpu` Body's numpy arrays make the port's Body, field for
    field and dtype for dtype, and come back unchanged."""
    jb = JBody.stack([JBody.make(position=(1.5, 2.0, -3.0), velocity=(0.1, 0.2, 0.3), flying=True, yaw=30.0),
                      JBody.make(position=(0.0, 0.0, 0.0), noclip=True, occ_lo=(-0.1, 0, -0.1))])
    fields = {k: np.asarray(getattr(jb, k)) for k in tbody.BODY_DTYPES}
    tb = body_from_numpy(fields, device="cpu")
    back = body_to_numpy(tb)
    for k, v in fields.items():
        assert getattr(tb, k).dtype == tbody.BODY_DTYPES[k], k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    made = TBody.stack([TBody.make(position=(1.5, 2.0, -3.0), velocity=(0.1, 0.2, 0.3), flying=True, yaw=30.0,
                                   device="cpu")])
    for k in tbody.BODY_DTYPES:
        assert torch.equal(getattr(made, k), getattr(tb, k)[:1]), k


def test_nonfinite_setters_are_ignored():
    b = TBody.make(position=(1.0, 2.0, 3.0), device="cpu")
    assert torch.equal(b.set_position((float("nan"), 0.0, 0.0)).position, b.position)
    assert torch.equal(b.set_velocity((0.0, float("inf"), 0.0)).velocity, b.velocity)
    assert b.set_position((4.0, 5.0, 6.0)).position.tolist() == [4.0, 5.0, 6.0]
