"""The port's v1 surface finder (aic_tpu_torch.raytrace.trace_kernel_v1)
and the v1 trace path against `aic_tpu`'s v1 Pallas kernel.

On the CPU the port runs the kernel's plain PyTorch twin
(`surface_finder_plain`). Its 15 output fields are held against
`pallas_trace._run_kernel(..., interpret=True)` on 1024 rays (one Pallas
group): integer fields equal, float fields within 1e-5 relative. The
Pallas kernel advances its group one domain at a time and the twin every
ray at once, so both run until no ray walks. Images of the whole path
(`trace_rays_kernel(megakernel=False)`: launches, the round glue through
the packed cells, shading) are held against `trace_rays_pallas(
megakernel=False, interpret=True)` at atol=2e-3
(tests/test_pallas_trace.py:30). The 640×8×640 plaza, where the auto
dispatch of both packages picks v1, is in tests/test_torch_plaza.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aic_tpu.raytrace import pallas_trace
from aic_tpu_torch.raytrace import trace_kernel, trace_kernel_v1 as v1
from test_pallas_trace import OPTS_PLAIN, grid_rays, scene_atoms, scene_r32, scene_voxels
from test_torch_state import PKGS, SCENES, to_port, fresh_pallas_caches  # noqa: F401 (autouse)
from test_torch_trace import CORNELL, _cornell_rays, random_rays, torch_options

# -- the kernel's 15 fields against the Pallas v1 kernel -------------------------

FIELD_CASES = {
    "atoms": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07))),
    "voxels": (scene_voxels, lambda: random_rays(1024, -4.0, 24.0, seed=3)),
}


def _launch_state(build, rays):
    """(aic_tpu state, port state, v1 ctx, ray constants, 9-field launch
    state) for space-local rays from the initial state."""
    st = build()
    tst = to_port(st)
    ctx = v1.build_bitmask_ctx(tst)
    o, d = rays()
    r, s2, entry = trace_kernel.initial_state(
        tst, torch.as_tensor(o.reshape(-1, 3)), torch.as_tensor(d.reshape(-1, 3)), ctx
    )
    return st, tst, ctx, r, v1.initial_state_v1(s2), entry


def _pallas_fields(st, r, s):
    jctx = pallas_trace.build_bitmask_ctx(st)
    return pallas_trace._run_kernel(
        {k: jnp.asarray(v.numpy()) for k, v in r.items()},
        {k: jnp.asarray(v.numpy()) for k, v in s.items()},
        jctx.l1, jctx.rows, jctx.rdims, jctx.size, jctx.n_regions, v1.ITERS, v1.SUBSTEPS, True,
    )


def _assert_fields_equal(got, want):
    assert not (np.asarray(want["walking"]) == 1).any()
    for k in v1.OUT_FIELDS:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in v1.FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_surface_finder_fields_match_pallas(name):
    """One launch from the phase-1 state until no ray walks."""
    st, _tst, ctx, r, s, _entry = _launch_state(*FIELD_CASES[name])
    before = v1.LAUNCHES
    got = v1.run_surface_finder(r, s, ctx)
    assert v1.LAUNCHES == before  # CPU tensors: plain version
    assert (got["hit"].numpy() == v1.HIT_OUTER).any()
    _assert_fields_equal(got, _pallas_fields(st, r, s))


def test_surface_finder_inner_round_matches_pallas():
    """The second launch on the voxel scene, after the round glue pushed
    the rays that hit a voxel block into its grid: inner hits and inner
    exits, with inner steps of |1/d|/2^resl."""
    st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES["voxels"])
    saved, hb = v1.empty_buffers(s["dom"].shape[0], "cpu")
    out = v1.run_surface_finder(r, s, ctx)
    s2, _saved, _hb = v1.advance(tst, ctx, r, entry["d_len"], s, saved, hb, out)
    assert (s2["resl"].numpy() > 0).any()
    got = v1.run_surface_finder(r, s2, ctx)
    hits = set(got["hit"].numpy().tolist())
    assert {v1.HIT_INNER, v1.INNER_EXIT} <= hits
    _assert_fields_equal(got, _pallas_fields(st, r, s2))


# -- tables -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["atoms", "atrium_small", "cornell16", "voxels"])
def test_bitmask_ctx_equal(name):
    """v1 tables (region rows, then one row per voxel entry at its native
    edge; the L1 row) equal `aic_tpu`'s."""
    st = SCENES[name](PKGS["jax"]).snapshot()
    want = pallas_trace.build_bitmask_ctx(st)
    got = v1.build_bitmask_ctx(to_port(st))
    for k in ("rdims", "size", "n_regions", "n_ventries"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("rows", "l1"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_array_equal(getattr(got, k).numpy().view(w.dtype), w, err_msg=k)


def test_v1_refuses_r32_like_aic_tpu():
    """R32 blocks: both packages' v1 tables refuse them; with the
    megakernel forced off the port raises, naming the general tracer
    that holds them."""
    st = scene_r32()
    with pytest.raises(ValueError):
        pallas_trace.build_bitmask_ctx(st)
    o, d = random_rays(8, -4.0, 24.0, seed=1)
    with pytest.raises(ValueError, match="general tracer"):
        trace_kernel.trace_rays_kernel(
            to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN),
            megakernel=False,
        )


def test_auto_dispatch_follows_megakernel_fits(monkeypatch):
    """Auto dispatch takes the megakernel where its tables fit and v1
    where `megakernel_fits` says no, with no other change."""
    tst = to_port(scene_voxels())
    o, d = random_rays(64, -4.0, 24.0, seed=2)
    calls = []
    real = v1.trace_phases_v1
    monkeypatch.setattr(v1, "trace_phases_v1", lambda *a: calls.append(1) or real(*a))
    args = (tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN))
    assert trace_kernel.megakernel_fits(tst)
    want = trace_kernel.trace_rays_kernel(*args)
    assert calls == []
    monkeypatch.setattr(trace_kernel, "megakernel_fits", lambda state: False)
    got = trace_kernel.trace_rays_kernel(*args)
    assert calls == [1]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-3)


def test_round_budget_reports_unfinished(monkeypatch):
    """Too few rounds for the voxel grids is reported, not hidden."""
    tst = to_port(scene_voxels())
    o, d = grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05))
    monkeypatch.setattr(v1, "ROUNDS", 1)
    _l, _t, unfinished = trace_kernel.trace_rays_kernel(
        tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN), megakernel=False
    )
    assert unfinished


# -- images against trace_rays_pallas(megakernel=False) ---------------------------

IMAGE_CASES = {
    "atoms": (scene_atoms, lambda: grid_rays(32, 32, -3.0, (0.1, 23.9), (0.1, 23.9), (1.0, 0.12, 0.07)), OPTS_PLAIN, {}),
    "voxels": (scene_voxels, lambda: grid_rays(32, 32, -2.0, (0.05, 19.95), (0.05, 19.95), (1.0, 0.08, 0.05)), OPTS_PLAIN, {}),
    "rays_from_inside": (scene_atoms, lambda: random_rays(256, 1.0, 23.0, seed=11), OPTS_PLAIN, {}),
    "incoherent": (scene_voxels, lambda: random_rays(512, -4.0, 24.0, seed=3), OPTS_PLAIN, {"max_rounds": 96}),
    "cornell_smoothstep": (lambda: PKGS["jax"].cornell_box(26).snapshot(), _cornell_rays, CORNELL, {}),
}


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_image_matches_pallas_v1(name):
    build, rays, opts, pallas_kw = IMAGE_CASES[name]
    st = build()
    o, d = rays()
    want_l, want_t, stats = pallas_trace.trace_rays_pallas(
        st, jnp.asarray(o), jnp.asarray(d), opts, interpret=True, return_stats=True,
        megakernel=False, **pallas_kw,
    )
    assert not bool(stats["unfinished"])
    before = v1.LAUNCHES
    got_l, got_t, unfinished = trace_kernel.trace_rays_kernel(
        to_port(st), torch.as_tensor(o), torch.as_tensor(d), torch_options(opts), megakernel=False
    )
    assert v1.LAUNCHES == before  # CPU tensors: plain version
    assert not unfinished
    assert tuple(got_l.shape) == np.asarray(want_l).shape
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)


# -- the round loop over walking rays against the all-ray loop --------------------


def _frame_both_ways(tst, o, d, opts, monkeypatch, halve=False):
    """One v1 frame through `trace_phases_v1` (walking lists) and through
    `trace_phases_all_rays`: (light, transmittance, unfinished, each
    phase's hit buffers) of each. `halve` shades with a stand-in that
    halves every hit ray's transmittance, so that hits resume phase after
    phase."""
    results = []
    real_shader = trace_kernel.make_phase_shader
    for loop in (v1.trace_phases_v1, v1.trace_phases_all_rays):
        hits = []

        def recording_shader(*args, hits=hits):
            shade = real_shader(*args)

            def f(hb, la, ta):
                hits.append({k: v.clone() for k, v in hb.items()})
                if halve:
                    hit = hb["hit_kind"] != 0
                    return la + hb["hit_t"][:, None] * hit[:, None], torch.where(hit, ta * 0.5, ta)
                return shade(hb, la, ta)
            return f

        monkeypatch.setattr(trace_kernel, "make_phase_shader", recording_shader)
        monkeypatch.setattr(v1, "trace_phases_v1", loop)
        before = v1.LAUNCHES
        light, trans, unfinished = trace_kernel.trace_rays_kernel(
            tst, torch.as_tensor(o), torch.as_tensor(d), opts, megakernel=False
        )
        assert v1.LAUNCHES == before  # CPU tensors: plain version
        results.append((light, trans, unfinished, hits))
    return results


def _assert_bit_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert len(got[3]) == len(want[3]) >= 1
    for a, b in zip(got[3], want[3]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _plaza_96x54():
    from aic_tpu_torch.content import plaza
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import GraphicsOptions as TorchGraphicsOptions

    opts = TorchGraphicsOptions(lighting_display="smoothstep", fog="none")
    sp = plaza()
    o, d = default_camera(sp, 96, 54, opts).pixel_rays(device="cpu")
    return sp.snapshot(device="cpu"), o.numpy(), d.numpy(), opts


@pytest.mark.parametrize("halve", [False, True], ids=["shaded", "resuming"])
@pytest.mark.parametrize("name", sorted(FIELD_CASES) + ["plaza640_96x54"])
def test_walking_list_loop_matches_all_ray_loop(name, halve, monkeypatch):
    """The round loop over walking rays (each round's list, the twin on the
    listed rays, `advance` on them, scattered into the full buffers) equals
    the all-ray loop bit for bit: every phase's hit buffers, the light, the
    transmittance and `unfinished`."""
    if name == "plaza640_96x54":
        tst, o, d, opts = _plaza_96x54()
    else:
        build, rays = FIELD_CASES[name]
        tst = to_port(build())
        o, d = rays()
        opts = torch_options(OPTS_PLAIN)
    got, want = _frame_both_ways(tst, o.reshape(-1, 3), d.reshape(-1, 3), opts, monkeypatch, halve)
    _assert_bit_equal(got, want)
    if halve and name != "atoms":  # (the atoms' grid rays seldom meet a second atom)
        assert len(got[3]) > 1  # hits resumed into later phases


def test_packed_rays_and_state_round_trip():
    """Ray constants, launch state, kernel output, saved registers and hit
    buffers survive packing into the kernels' i32/f32 buffers and back."""
    _st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES["voxels"])
    packed = trace_kernel.PackedRays.pack(r)
    assert packed.f.dtype == torch.float32 and tuple(packed.f.shape) == (9, r["ox"].shape[0])
    assert packed.i.dtype == torch.int32 and tuple(packed.i.shape) == (3, r["ox"].shape[0])
    for k, v in packed.fields().items():
        assert torch.equal(v, r[k]), k
    idx = torch.tensor([5, 0, 77])
    for k, v in packed.take(idx).fields().items():
        assert torch.equal(v, r[k][idx]), k
    out = v1.surface_finder_plain(r, s, ctx)
    saved, hb = v1.empty_buffers(s["dom"].shape[0], "cpu")
    s2, saved, hb = v1.advance(tst, ctx, r, entry["d_len"], s, saved, hb, out)
    assert (hb["hit_kind"] != 0).any() and (saved["sdom"] != 0).any()
    buf = trace_kernel.pack_fields(out, v1.OUT_FIELDS, v1.FLOAT_FIELDS)
    back = trace_kernel.unpack_fields(buf, v1.OUT_FIELDS, v1.FLOAT_FIELDS)
    for k in v1.OUT_FIELDS:
        assert back[k].dtype == out[k].dtype and torch.equal(back[k], out[k]), k
    buf = v1.pack_round(s2, saved, hb)
    assert buf.dtype == torch.int32 and buf.shape[0] == v1.ROUND_ROWS
    for want, got in zip((s2, saved, hb), v1.unpack_round(buf)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    buf = v1.pack_round(s, *v1.empty_buffers(s["dom"].shape[0], "cpu"))
    n_st = len(v1.STATE_FIELDS)
    assert torch.equal(buf[:n_st], trace_kernel.pack_fields(s, v1.STATE_FIELDS, v1.FLOAT_FIELDS))
    assert buf[:n_st].is_contiguous() and not buf[n_st:].any()
    assert torch.equal(buf[v1.WALKING_ROW], s["walking"])
    assert torch.equal(buf[v1.HIT_KIND_ROW], v1.hit_buffers(buf)["hit_kind"])


def test_empty_walking_list_changes_nothing():
    """A round over no ray leaves every buffer as it was and launches
    nothing; a frame whose rays all miss the volume runs no round."""
    _st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES["voxels"])
    packed = trace_kernel.PackedRays.pack(r)
    n_st = len(v1.STATE_FIELDS)
    buf = v1.pack_round(s, *v1.empty_buffers(s["dom"].shape[0], "cpu"))
    buf[n_st:].random_(0, 1000)
    before = buf.clone()
    empty = torch.zeros(0, dtype=torch.int64)
    launches = v1.LAUNCHES
    out = v1.launch(packed, buf[:n_st], ctx, empty)
    assert tuple(out.shape) == (len(v1.OUT_FIELDS), 0) and v1.LAUNCHES == launches
    nxt = v1.walk_round(tst, ctx, packed, entry["d_len"], buf, empty)
    assert nxt.numel() == 0
    assert torch.equal(buf, before)
    # Rays from outside the volume pointing away from it: nothing walks.
    o = np.full((8, 3), -5.0, np.float32)
    d = np.tile(np.asarray([[-1.0, 0.0, 0.0]], np.float32), (8, 1))
    calls = []
    real = v1.walk_round
    v1.walk_round = lambda *a: calls.append(1) or real(*a)
    try:
        light, trans, unfinished = trace_kernel.trace_rays_kernel(
            tst, torch.as_tensor(o), torch.as_tensor(d), torch_options(OPTS_PLAIN), megakernel=False
        )
    finally:
        v1.walk_round = real
    assert calls == [] and not unfinished
    assert torch.equal(trans, torch.zeros(8))


def test_twin_counts_walking_rays_and_attempts_per_ray():
    """The twin's work counts the rays walking at launch, those in a voxel
    grid and those that take a macro step, and each ray's cube-step
    attempts, whose sum is the attempts' count."""
    _st, _tst, ctx, r, s, _entry = _launch_state(*FIELD_CASES["voxels"])
    work: dict = {}
    v1.surface_finder_plain(r, s, ctx, work=work)
    assert work["walking"] == int((s["walking"] == 1).sum()) > 0
    assert work["inner"] == 0 and 0 < work["macro_rays"] < min(work["walking"], work["macro_steps"])
    per_ray = work["ray_steps"]
    assert tuple(per_ray.shape) == (r["ox"].shape[0],)
    assert int(per_ray.sum()) == work["steps"] and int(per_ray.max()) > 0
    assert not per_ray[s["walking"] != 1].any()


def test_twin_counts_inner_rays():
    """On the voxel scene's inner round, the rays pushed into a voxel grid
    are the walking rays the twin counts as inner."""
    _st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES["voxels"])
    saved, hb = v1.empty_buffers(s["dom"].shape[0], "cpu")
    s2, _saved, _hb = v1.advance(tst, ctx, r, entry["d_len"], s, saved, hb, v1.surface_finder_plain(r, s, ctx))
    work: dict = {}
    v1.surface_finder_plain(r, s2, ctx, work=work)
    inner = (s2["walking"] == 1) & (s2["dom"] >= ctx.n_regions)
    assert work["inner"] == int(inner.sum()) > 0


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_packed_glue_matches_per_field_glue(name):
    """`advance_packed` on the packed round buffer equals the per-field
    glue `advance` (`aic_tpu`'s layout, the all-ray loop's) bit for bit,
    field by field, in every round of a frame's first phase: the next
    state, saved registers, hit buffers and the walking flags."""
    _st, tst, ctx, r, s, entry = _launch_state(*FIELD_CASES[name])
    packed = trace_kernel.PackedRays.pack(r)
    saved, hb = v1.empty_buffers(s["dom"].shape[0], "cpu")
    rounds = 0
    while bool((s["walking"] == 1).any()):
        out = v1.surface_finder_plain(r, s, ctx)
        buf, walking = v1.advance_packed(
            tst, ctx, packed, entry["d_len"], v1.pack_round(s, saved, hb),
            trace_kernel.pack_fields(out, v1.OUT_FIELDS, v1.FLOAT_FIELDS),
        )
        s, saved, hb = v1.advance(tst, ctx, r, entry["d_len"], s, saved, hb, out)
        assert torch.equal(walking, s["walking"] == 1)
        for want, got in zip((s, saved, hb), v1.unpack_round(buf)):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        rounds += 1
    assert (hb["hit_kind"] != 0).any()
    assert rounds >= (3 if name == "voxels" else 1)  # voxels: block entry, inner walk, exit


def test_v1_bound_counts_the_bytes_each_ray_needs():
    """chip_smoke's K3 bound: 116 B per walking ray (step and inverse
    direction, the state but the grid resolution, the 15 outputs), 4 B more
    per ray in a voxel grid, 24 B more per ray that takes a macro step,
    plus the tables; nothing for rays that do not walk."""
    import chip_smoke

    _st, _tst, ctx, r, s, _entry = _launch_state(*FIELD_CASES["voxels"])
    tables = chip_smoke.nbytes(ctx.rows, ctx.l1)
    work = {"rays": 10**6, "walking": 1000, "inner": 10, "macro_rays": 100}
    want = (1000 * 116 + 10 * 4 + 100 * 24 + tables) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert chip_smoke.v1_bound(ctx, {**work, "rays": 0, "walking": 0, "inner": 0, "macro_rays": 0})[0] == (
        tables / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = chip_smoke.v1_bound(ctx, work)
    ops_ms = sum(n * work.get(k, 0) for k, n in chip_smoke.OPS["trace_v1"].items()) / chip_smoke.F32_OPS_PER_S * 1e3
    assert (ms, by) == ((want, "bytes") if want >= ops_ms else (ops_ms, "operations"))


def test_trace_v1_variants_apply_to_the_kernel_source():
    """Every design alternative that tools/trace_v1_variants.py times is a
    substitution that still finds its text, once, in the committed
    `csrc/trace_v1.cu`, and changes it."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "trace_v1_variants", root / "aic_tpu_torch" / "tools" / "trace_v1_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "aic_tpu_torch" / "csrc" / "trace_v1.cu").read_text()
    assert mod.variant_source("committed", src) == src
    for name in mod.VARIANTS:
        if name != "committed":
            assert mod.variant_source(name, src) != src, name
