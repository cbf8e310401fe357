#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aic_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, nothing is caught):

1. device  — the card's name; `nvidia-smi` name and power limit.
2. build   — nvcc builds the three kernels from `aic_tpu_torch/csrc/`,
   one process per source, all started together, and g++ the native
   mesher and reference relight from `aic_tpu_torch/native/`.
3. kernels — each CUDA kernel against its plain PyTorch twin on the
   card: the relight pass (K2) in both variants on a small mixed scene,
   cornell-box 16, the atrium and `plaza640` (two launches bit-equal,
   full(ring only) + light-only against the full pass, the time beside
   the one-thread-per-cube kernel's and the bound, the critical path of
   both designs), on a state with no listed cube (zeros, no launch), and
   the over-relaxed loop to convergence on each (on cornell-box 16 it
   falls back to plain Jacobi, which is printed; anywhere else in the run
   a fall-back is a failure); the traversal
   megakernel (K1) on small atom, voxel and R32 scenes and on the atrium
   and `plaza640` at 1920×1080 (plaza640's frame takes v1: K1 there is
   timed for comparison); the v1 surface
   finder (K3) on the atom and voxel scenes (first launch, and the inner
   round) and on the atrium and `plaza640` 1920×1080 launch states. Then
   both trace paths on the same 1920×1080 rays, atrium and `plaza640`.
   Times at the main paths' shapes; K1 and K3 by their launch alone on
   packed inputs (`launch_ms`; K1 launches in place, so each repetition
   starts from a fresh copy of its state), the packing apart, beside the
   kernels' earlier times (`K1_EARLIER_MS`, `K3_EARLIER_MS`); bounds from
   the twins' work counts (`k1_bound`, `v1_bound`: the bytes the rays
   walking in the launch need).
4. slice   — the first main path at full size: atrium snapshot on the
   card, `evaluate_light_dense`, `render` at 1920×1080 with smooth
   lighting (megakernel); launch counters, flaws, image checks; every K1
   launch of a warm frame held against the twin on its listed rays and
   timed alone (`k1_frame_launches`), the listed phase loop against the
   all-ray loop bit for bit and the trace stage through both; the
   relight one stage at a time.
5. slice   — the second main path: `plaza640` (640×8×640, megakernel
   tables over budget) the same way, traced by the v1 kernel; PNGs of
   both frames under `aic_tpu_torch/_build/`. Then a plaza frame and the
   snapshot and relight one stage at a time, and every K3 launch of one
   warm frame: its walking rays, held against the twin field for field,
   timed alone, its bound and its longest ray; the walking-list frame
   against the all-ray frame (`aic_tpu`'s loop and per-field glue) bit
   for bit, an empty list, and the trace stage through both loops,
   alternated.
   After each slice, K2's listed kernel over a queue round's batch (one
   launch, `relight_batch_cuda`) against the plain `relight_batch` walk
   on the same batch: a first round's 16 cubes after an edit, seeded
   random batches of 16 and 1024 and a one-row batch, each with two
   launches bit-equal and timed launch only, beside the earlier design's
   time (`K2_LISTED_EARLIER_MS`), the whole card call with and without
   the volume decode the call made before, the plain walk, the bound and
   the chains of both designs; and a batch of padding only (zeros, no
   launch).
6. step    — the step loop: the atrium stepped 30 ticks through the
   device tick and through the per-cube host path (contents and cells
   equal, light within one step); then the atrium (120 ticks) and
   plaza640 (60 ticks) through `Universe.step` from `build_universe` on
   the card, relit by `evaluate_light`, with a Become cycle of period 6
   and a behavior that places and removes blocks every 10 ticks, after
   36 ticks of warm-up: the median ms a step, its phases, the card's
   busy share, light updates and queue, the rows K2 walked per listed
   launch, K2 held against the plain walk on the timed ticks' batch
   that walked the most rows, then a 1920x1080 frame of the
   stepped world (K1, K3) held against a fresh snapshot's, the host
   contents against the device's, and a palette-growing commit timed
   apart; the launch counters read around the ticks and the frame.
   After the checks, as many ticks again with each listed launch timed
   by CUDA events (mean, max), and queue rounds in a row with and
   without the round's valid-row read-back, alternated.
7. city    — demo-city (96x28x96, its exhibits, R32 blocks and wide
   classify pages) from `build_universe("demo-city")` on the card, the
   content build and the snapshot timed apart: K2 (both variants) and K1
   (1920x1080, every field) against their twins on its state; then, with
   the counters set to 0, `evaluate_light` (the fall-back to w = 1
   printed, not an error), a 1920x1080 frame, 35 + 60 steps as bench.py's
   `step_demo_city_ms` steps it (each synchronized; palette-growing steps
   apart) and a frame of the stepped world; the counters read. Then
   every K1 launch of the first and the stepped frames against the twin,
   timed alone, and the listed phase loop against the all-ray loop; the
   busiest timed batch against the plain walk, the phases' spans, 60
   more steps with each listed launch timed by CUDA events, and a
   palette-growing commit.
8. render  — the render API and the general tracer, the counters set to
   0 before and read after: the atrium at 1920x1080, the general tracer
   (`tracer.trace_rays`) against K1's frame on the same rays (pixels over
   2e-3 at most 0.01%), then `render` (K1), the pixel-cost and depth
   images, `render_scaled(0.5)`, a bounce frame and `RtRenderer.draw`
   (a UI space, the atrium, a cursor, info text); "Smallest" (R128,
   built standalone: neither kernel holds it) and plaza(1280) (6,400
   regions: more than the kernels' 4,096) through the general tracer;
   plaza(1536) (over `render.AUTO_WINDOW_VOLUME`) relit by K2, windowed
   to the view and traced by K1 or K3, held against the whole state's
   general-tracer frame over the near view. Each render asserts the
   tracer that `render.pick_tracer` names (`render.TRACES`) and prints
   its host-clock time after a synchronization beside the card's name
   and power limit; the general tracer's iterations per phase.
9. session — the interactive layer: demo-city (seed 0, size 96) from
   `build_universe`, relit by `evaluate_light`, played by a `Session` at
   1920x1080 with its HUD: 35 warm-up steps, then 10 frames of
   `maybe_step` + `render_with_ui` (a clock advancing 1/60 s a frame),
   each synchronized, the counters set to 0 before the build and read
   after; the median and max frame, its stages (step, world layer, UI
   layer, composite, post-process, copy to host), the UI snapshots and
   K1 table builds, the tracer of each layer against `pick_tracer`.
   Every K1 launch of one session frame (world and UI) against the twin,
   timed alone. On the card: a toolbar click selects its slot, the
   composite equals `composite_over` of the layers rendered apart, `p`
   opens the paused page (rendered), `cycle_setting` reaches the
   options; text made at run time, composed from the vendored glyph
   table (a notification titled "Saved <seeded name>.json", then a
   seeded three-line Latin-1 message page), each in a 1920x1080 frame
   with its text voxels counted. The WebSocket server on port 0: 8 inputs carrying `t`, each
   timed to the frame echoing it (`echo_t`), render_ms, the PNG's encode
   time and bytes, a pushed PNG decoded (1920x1080 RGBA), `/info` and
   `/frame.png`. The stepped universe saved through `FileWhence` and
   reopened by `python3 -m aic_tpu_torch.main FILE --graphics print` and
   `--graphics terminal` (no tty) as subprocesses: both exit 0 and load
   the saved space.
10. record — `main --graphics record` as a user runs it, each command a
   subprocess on the card whose launch counters are added to the
   phase's (`run_main`): demo-city (seed 0, size 96) to `.gltf` (the
   accessor counts against an in-process `mesh_space_textured` of the
   same world, the atlas decoded equal to its texture, bytes and
   seconds); the session phase's demo-city stepped 60 ticks (a placing
   behavior every 10) with a `ChunkedSpaceMesh` updated each tick
   (budget 8): the chunks re-meshed a tick, the cubes and chunks the
   device tick's remap changed with no journal entry, and after a full
   update every other chunk equal to a fresh chunked mesh's; a
   `SessionAudio` over the session's steps and these (a scripted tool
   use where they raise no fluff), written as WAV: sounds and PCM peak;
   the atrium at 1920x1080 to `.stl` (84 + 50 T bytes, T the
   voxel-detail triangles; the file deleted), to an 8-frame APNG along
   a two-keyframe camera script (8 `fcTL` chunks; frame 0 equal to an
   in-process render at the script's t = 0 camera; ms a frame) and to
   a 4-frame animated `.gltf` (4 frame nodes, 4 scale channels); the
   C++ reference relight (`ref_relight_state` on light_bench and
   cornell-box 32, one run each) on the host's CPU beside the card's `evaluate_light_dense` of the same
   scenes.
11. multi-GPU — the multi-GPU paths (`aic_tpu_torch.parallel`), ranks
   started by `parallel.spawn` after the kernels are built, each world's
   states built once here and handed to the ranks as CPU tensors. (a)
   one NCCL rank per card (`torch.cuda.device_count()`, one on a one-card
   machine): the dry run (`graft_entry._dryrun_multichip_impl`) and a
   demo-city slab pass held to the one-process K2 pass bit for bit. (b)
   four ranks on card 0 over gloo, staged through the host (every line
   says "gloo (host-staged)"): plaza640 (slabs of 160, one hop)
   relit by `evaluate_light_slab` to convergence and demo-city (seed 0,
   size 96, slabs of 24, pad 31: two hops) by three slab passes, each
   pass's gathered light held to the one-process K2 pass from the same
   light bit for bit, plaza640's pass count to a loop of one-process
   passes'; demo-city's slab frame at 1920x1080 from bench.py's camera
   against the one-process `trace_rays` (`SLAB_ATOL`); the atrium's
   ray-split pass (within one step) and row-sharded frame (bit for bit);
   K2's ms a pass by rank, each pass's exchanges (ms, bytes), the
   frames' ms; then `graft_entry.dryrun_multichip(4)` over it. (c) the
   session's demo-city saved as `.alliscubesjson`, loaded back (contents
   equal up to the importer's palette renumbering, packed light equal)
   and opened by `main FILE --graphics print` as a subprocess. The ranks' launches (and main's) are summed and
   must include K2's full and listed kernels.
12. reference — the reference-procedure relight
   (`refproc.evaluate_light_reference`, each bucket one K2 listed launch
   over 64 rows) and one whole-volume round (`dense.relight_all`, K2's
   full pass), the counters set to 0 before and read after: cornell-box
   10 against the C++ `ref_relight_state` (statuses equal, packed light
   within 4 steps, mean decoded difference under 0.01,
   tests/test_ref_relight.py's criteria); cornell-box 32 timed (seconds,
   rounds, listed launches and the share of the run inside them by CUDA
   events) beside the card's `evaluate_light_dense` and the C++ relight;
   one round's launch against the plain walk and `relight_all` against
   the plain pass.
13. goldens — the port held to what `aic_tpu` made, the counters set to
   0 before and read after, any miss a failure and a missing reference
   file too: (a) tests/test_render_goldens.py's six self-goldens
   (`golden_case` builds each scene as that file does), rendered by
   `render` on the card and compared with tests/goldens/<case>.png at
   that file's threshold (the tracer `pick_tracer` took, differing
   fraction, max and mean delta, launches); (b) the atrium, plaza640
   and demo-city (seed 0, size 96) snapshotted on the card with the
   packed light `aic_tpu` traced them with in place of theirs, rendered
   at 1920x1080 (K1, K3, K1) from the main paths' cameras and held to
   `aic_tpu`'s frames (tests/goldens/aic_tpu_1080p/, written by
   tests/torch_references.py) at TRACE_THRESHOLD, and the slice phase's
   atrium frame of the card's own relight held to `aic_tpu`'s converged
   atrium at END_TO_END_THRESHOLD; (c) the smooth-light functions on the
   card (the phase shader's interp rows and the direct fetch) against
   the f64 oracle (`testing.refmath`) on ORACLE_SAMPLES seeded surface
   samples of the lit cornell-box 16, linear and smoothstep, within
   ORACLE_BOUND; (d) the transaction laws (`testing.TransactionTester`
   over tests/test_txn_laws.py's SpaceTransaction cases) on targets
   whose contents live on the card, each commit scattered there by
   `scatter_set_cubes`. The phase's seconds and launches.
14. the kernels line (JSON; K1's row from demo-city's frame, its phases'
   launches summed; K2's listed mode as `relight_batch`, from the atrium
   step's batch that walked the most rows; launches summed over every
   main path, demo-city's, the render phase's, the session's, the
   record phase's, the multi-GPU ranks', the reference phase's and the
   goldens phase's included), the `nvidia-smi` line, and the last line
   {"ok": true, "device": {...}}. PIL must not have been imported by
   then.

Needs CUDA and the `aic_tpu_torch` package beside this file; imports no
JAX and no PIL.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Tolerances. K2: packed light within one log step (the codec's unit;
#: kernel and twin sum the same f32 terms in another order), status
#: equal. K1, K3: integer fields equal, t-like fields within
#: 1e-5·max(1,|t|). Trace paths: pixels further apart than 2e-3
#: (tests/test_pallas_trace.py:30) at most 0.01% of the frame (knife
#: edges, ROADMAP §C).
RELIGHT_MAX_STEP = 1
TRACE_RTOL = 1e-5
PIXEL_ATOL = 2e-3
PIXEL_MAX_SHARE = 1e-4

#: Bounds: one H100 SXM's HBM rate and float32 rate outside the tensor
#: cores (NVIDIA's data sheet), and each kernel's operations per unit of
#: the work its plain twin counts on the same inputs (the twins' `work`),
#: counted from each kernel's SASS along each branch: one per arithmetic,
#: comparison, logic, shift, min/max, conversion, select or special-function
#: instruction, table index arithmetic included; none for loads and stores
#: (the bytes' side), register moves, a branch on a computed flag, a
#: division's slow path, or loop-invariant set-up on the uniform datapath.
#: Where one branch of a count runs one of two paths (K1: an inner or an
#: outer step, a narrow or a wide page, an R32 octant hop or not), the
#: shorter path counts. All count at the f32 rate, the card's highest
#: outside the tensor cores, so the bound stays a least time. PERF.md
#: ("Operation counts") gives the derivation.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS = {
    "trace_megakernel": {
        "walking": 48, "iters": 2, "outer_iters": 4, "macro_steps": 102, "steps": 23,
        "outer_steps": 6, "tests": 13, "hits": 18, "restores": 18, "classify": 21, "pushes": 172,
    },
    "trace_v1": {
        "rays": 35, "walking": 20, "outer_iters": 6, "macro_steps": 86, "steps": 23,
        "outer_steps": 6, "tests": 11, "hits": 8,
    },
    "relight_pass": {
        "weights": 19, "rays": 12, "steps": 2, "inside": 10, "visible": 14, "struck": 25, "through": 15,
    },
    "relight_pass_dyn": {
        "weights": 19, "rays": 2, "steps": 2, "inside": 10, "visible": 14, "struck": 22, "through": 12,
    },
}

#: K2's time per pass in the one-thread-per-cube design that the current
#: kernel replaced (PERF.md's kernel table, "earlier" column; NVIDIA H100
#: 80GB HBM3, 700.00 W), printed beside this run's time as a constant.
K2_EARLIER_MS = {
    ("atrium", False): 8.560, ("atrium", True): 7.904,
    ("plaza640", False): 8.255, ("plaza640", True): 7.787,
}

#: K1 and K3 as they were before their redesigns (K1: the all-ray phase
#: loop and the one-walk `trace.cu` that read and wrote all 28 fields of
#: every ray; K3: the all-ray round loop and the one-walk `trace_v1.cu`),
#: timed launch only on packed inputs as this script times them (PERF.md's
#: kernel table, "earlier" column; NVIDIA H100 80GB HBM3, 700.00 W),
#: printed beside this run's times as constants. Keys: `compare_trace` /
#: `compare_v1` labels, the phases of the atrium's, demo-city's and the
#: stepped demo-city's 1080p frames and the rounds of a warm plaza640
#: frame (each an all-ray launch then).
K1_EARLIER_MS = {
    "atoms": 0.022, "voxels": 0.021, "r32": 0.034, "atrium 1920x1080": 0.262,
    "demo-city 1920x1080": 0.514, "plaza640 1920x1080": 0.685,
    "atrium phase 1": 0.2619, "demo-city phase 1": 0.5096, "demo-city phase 2": 0.1747,
    "demo-city stepped phase 1": 0.5126, "demo-city stepped phase 2": 0.1746,
}
K3_EARLIER_MS = {
    "atoms": 0.029, "voxels": 0.025, "atrium 1920x1080": 0.188, "plaza640 1920x1080": 0.635,
    "plaza640 round 1": 0.6308, "plaza640 round 2": 0.0886, "plaza640 round 3": 0.1027,
    "plaza640 round 4": 0.0703,
}

#: K2 over a queue round's batch as it was before the listed kernel: the
#: volume pass's tile of 32 listed cubes x 16 warps with per-row inputs,
#: over light decoded to f32 by a pass over the whole volume (PERF.md's
#: kernel table, "earlier" column; NVIDIA H100 80GB HBM3, 700.00 W),
#: printed beside this run's times as constants: (the launch alone, the
#: whole `relight_batch_cuda` call) in ms, by (world, batch case).
K2_LISTED_EARLIER_MS = {
    ("atrium", "first round"): (0.2792, 1.656), ("atrium", "random 16"): (0.1926, 1.211),
    ("atrium", "random 1024"): (0.4672, 1.468), ("atrium", "busiest step round"): (0.3886, 1.500),
    ("plaza640", "first round"): (0.0509, 1.415), ("plaza640", "random 16"): (0.1141, 1.394),
    ("plaza640", "random 1024"): (0.1220, 1.820), ("plaza640", "busiest step round"): (0.1299, 2.018),
    ("demo-city", "busiest step round"): (0.1705, 1.800),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


# -- scenes (built with the port's own content code) ------------------------


def relight_scene(pkg, size=(12, 12, 12), md=8, seed=0):
    """Emissive, opaque and transparent blocks over a floor, under a sky."""
    block, GridAab, Space, Sky, SpacePhysics = pkg
    sp = Space(
        GridAab.from_lower_size((0, 0, 0), size),
        physics=SpacePhysics(sky=Sky.uniform((0.6, 0.7, 0.9)), light_max_distance=md),
    )
    rng = np.random.RandomState(seed)
    blocks = [
        block.from_color((0.8, 0.3, 0.2, 1.0)),
        block.from_color((0.2, 0.8, 0.3, 0.5)),
        block.from_color((0.9, 0.9, 0.9, 1.0), emission=(2.0, 1.5, 1.0)),
    ]
    for _ in range(max(6, int(np.prod(size) * 0.02))):
        sp.set(tuple(int(rng.randint(0, s)) for s in size), blocks[rng.randint(3)])
    sp.fill(GridAab.from_lower_size((0, 0, 0), (size[0], 1, size[2])),
            block.from_color((0.5, 0.5, 0.5, 1.0)))
    return sp


def trace_scenes(pkg):
    """Atoms across region corners; R8/R4 voxel blocks; R32 blocks."""
    block, GridAab, Space, Sky, SpacePhysics = pkg
    atoms = Space(GridAab.cube(24), physics=SpacePhysics(sky=Sky.uniform((0.4, 0.5, 0.6))))
    rng = np.random.RandomState(7)
    colors = [(1.0, 0.1, 0.1, 1.0), (0.1, 1.0, 0.1, 0.45), (0.2, 0.2, 1.0, 1.0)]
    for i in range(40):
        atoms.set(tuple(int(v) for v in rng.randint(0, 24, 3)), block.from_color(colors[i % 3]))

    inner8 = Space(GridAab.cube(8))
    inner8.fill(GridAab.from_lower_size((0, 0, 0), (8, 4, 8)), block.from_color((1.0, 1.0, 0.0, 1.0)))
    inner8.set((3, 6, 3), block.from_color((1.0, 0.0, 1.0, 0.5)))
    inner4 = Space(GridAab.cube(4))
    for x in range(4):
        for z in range(4):
            if (x + z) % 2 == 0:
                inner4.set((x, 0, z), block.from_color((0.0, 0.8, 0.8, 1.0)))
    voxels = Space(GridAab.cube(20), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.3, 0.35))))
    for c in [(2, 2, 2), (9, 2, 9), (17, 3, 5), (5, 10, 15)]:
        voxels.set(c, block.Block(block.Recur(space=inner8, resolution=8)))
    for c in [(4, 2, 7), (12, 5, 12), (16, 16, 16)]:
        voxels.set(c, block.Block(block.Recur(space=inner4, resolution=4)))

    inner32 = Space(GridAab.cube(32))
    inner32.fill(GridAab.from_lower_size((0, 0, 0), (32, 6, 32)), block.from_color((0.9, 0.7, 0.2, 1.0)))
    for i in range(32):
        inner32.set((i, i, i), block.from_color((0.2, 0.4, 0.9, 1.0)))
    r32 = Space(GridAab.cube(20), physics=SpacePhysics(sky=Sky.uniform((0.3, 0.32, 0.4))))
    for c in [(3, 2, 3), (10, 2, 12), (16, 8, 6)]:
        r32.set(c, block.Block(block.Recur(space=inner32, resolution=32)))
    r32.set((8, 2, 5), block.Block(block.Recur(space=inner8, resolution=8)))
    return {"atoms": atoms, "voxels": voxels, "r32": r32}


def random_rays(n, lo, hi, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# -- measurement --------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` calls, after one warm-up call (the
    twins' large allocations otherwise land in the kernel's window)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Cycles of the spin kernel (`torch.cuda._sleep`) queued ahead of a timed
#: window: it keeps the card busy while the host enqueues the launches, so
#: the events bracket device work only, not the host's time in a wrapper.
SPIN_CYCLES = 4_000_000
SPIN_CYCLES_ONE = 400_000


def launch_ms(fn, reps: int, fresh=None) -> float:
    """Mean device ms of `fn` over `reps` back-to-back calls (one warm-up
    first), a spin kernel queued ahead so that no host time enters. Where
    the host took longer to queue the calls than the spin ran (a wrapper
    whose host work outlasts a short kernel), the window would time the
    host: it is measured again behind a spin four times as long. With
    `fresh`, each call is `fn(x)` on its own `x = fresh()`, all of them
    made before the window opens (an in-place launch leaves its rays done:
    a second launch on the same state would time no work)."""
    import torch

    def inputs(n):
        return [(fresh(),) for _ in range(n)] if fresh else [()] * n

    fn(*inputs(1)[0])
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        args = inputs(reps)
        before = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for a in args:
            fn(*a)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if before.elapsed_time(start) > host_ms or spin >= 64 * SPIN_CYCLES:
            return start.elapsed_time(end) / reps
        spin *= 4


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(kernel: str, nbytes_moved: int, work: dict) -> tuple[float, str]:
    """The least time of the card for this work, in ms, and what bounds
    it: the bytes moved once at the HBM rate, or the operations of the
    branches these inputs take (`OPS[kernel]` times the twin's `work`)
    at the f32 rate. Only the branch counts that `OPS[kernel]` names
    enter the sum."""
    ops = sum(n * work.get(k, 0) for k, n in OPS[kernel].items())
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fields_agree(out_k, out_p, fields, float_fields, label):
    """Integer fields equal, float fields within TRACE_RTOL; the max abs
    error of the float fields."""
    import torch

    err = 0.0
    for k in fields:
        a, b = out_k[k], out_p[k]
        if k in float_fields:
            both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
            diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
            lim = TRACE_RTOL * torch.clamp(b.abs(), min=1.0)
            if bool((diff > lim).any()):
                fail(f"{label}: field {k} differs in {int((diff > lim).sum())} rays")
            err = max(err, float(diff.max()))
        elif not torch.equal(a, b):
            fail(f"{label}: field {k} differs in {int((a != b).sum())} rays")
    return err


def critical_path(ctx, lengths, listed=None) -> tuple[int, int]:
    """The longest serial chain of pair steps in each K2 design, from the
    pair steps of each live (cube, chart ray) of the twin's walk (its
    `lengths` list): one thread per cube walks all of its cube's steps
    (max_cube_steps); a warp of the current kernel walks its share of the
    rays for the 32 listed cubes of its block in step, each ray as long as
    its longest lane (max_warp_steps). `listed` is the kernel's list of
    cubes where it is not `ctx.kernel.cubes` (a queue round's batch)."""
    import torch
    from aic_tpu_torch.light import relight_kernel as rk

    if not lengths:
        return 0, 0
    cube, ray, steps = (torch.cat(col) for col in zip(*lengths))
    steps = steps.long()
    dev = cube.device
    V = ctx.alpha0.numel()
    cubes = ctx.kernel.cubes if listed is None else listed
    p = ctx.pairs
    R = p.cosines.shape[0]
    per_cube = torch.zeros(V, dtype=torch.long, device=dev).index_add_(0, cube, steps)
    tiles = -(-cubes.numel() // rk.TILE)
    tile = torch.zeros(V, dtype=torch.long, device=dev)
    tile[cubes.long()] = torch.arange(cubes.numel(), device=dev) // rk.TILE
    tile_ray = torch.zeros(tiles * R, dtype=torch.long, device=dev)
    tile_ray.scatter_reduce_(0, tile[cube] * R + ray, steps, "amax")
    warp = torch.empty(R, dtype=torch.long, device=dev)
    warp[p.ray_id.long()] = torch.repeat_interleave(
        torch.arange(rk.WARPS, device=dev), torch.diff(p.warp_start).long())
    per_warp = torch.zeros((tiles, rk.WARPS), dtype=torch.long, device=dev)
    per_warp.index_add_(1, warp, tile_ray.reshape(tiles, R))
    return int(per_cube.max()), int(per_warp.max())


def compare_relight(state, label):
    """K2 against its plain twin on one state (seeded light), both
    variants: within one packed step, two launches bit-equal; then
    full(ring only) + light-only(light) against the full pass. Prints the
    kernel's time beside the one-thread-per-cube kernel's
    (`K2_EARLIER_MS`) and the bound, and the critical path of both
    designs from the twin's walk. Returns {kernel name: (max abs err,
    kernel ms, plain ms, bound ms, bound by)}."""
    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light.refproc import fast_evaluate_seed
    from aic_tpu_torch.math import lightpack

    state, _ = fast_evaluate_seed(state)
    ctx = dense.build_relight_ctx(state)
    light_rgb = lightpack.decode_rgb(state.light).contiguous()
    zero = torch.zeros_like(light_rgb)
    rows = state.tables.light_face_rows
    p = ctx.pairs

    def packed(inc, tot):
        return dense._finish(ctx, inc + ctx.incoming0, tot).cpu().numpy().astype(np.int32)

    def within_step(a, b, what):
        step = int(np.abs(a[..., :3] - b[..., :3]).max())
        if step > RELIGHT_MAX_STEP or not np.array_equal(a[..., 3], b[..., 3]):
            fail(f"relight {what} on {label}: {step} packed steps, "
                 f"status equal {np.array_equal(a[..., 3], b[..., 3])}")
        return step

    # Inputs read once; outputs incoming f32[V,3] and total f32[V].
    kt = ctx.kernel
    moved = nbytes(state.contents, light_rgb, rows, ctx.dir_weights, ctx.alpha0, kt.face_mask,
                   kt.cubes, p.cosines, p.sky_ray, p.ray_start, p.ray_id,
                   p.words, p.warp_start) + state.contents.numel() * 16
    out = {}
    for dyn in (False, True):
        variant = " light-only" if dyn else ""
        args = (state.contents, light_rgb, rows, ctx)
        inc_k, tot_k = rk.relight_pass_cuda(*args, dyn=dyn)
        inc_k2, tot_k2 = rk.relight_pass_cuda(*args, dyn=dyn)
        work: dict = {}
        lengths: list = []
        inc_p, tot_p = rk.relight_pass_plain(*args, dyn=dyn, work=work, lengths=lengths)
        max_cube, max_warp = critical_path(ctx, lengths)
        del lengths
        torch.cuda.synchronize()
        if not (torch.equal(inc_k, inc_k2) and torch.equal(tot_k, tot_k2)):
            fail(f"relight{variant} on {label}: two launches on the same inputs differ")
        step = within_step(packed(inc_k, tot_k), packed(inc_p, tot_p), f"kernel vs plain{variant}")
        err = max(float((inc_k - inc_p).abs().max()), float((tot_k - tot_p).abs().max()))
        ms_k = cuda_ms(lambda: rk.relight_pass_cuda(*args, dyn=dyn), 20)
        ms_p = cuda_ms(lambda: rk.relight_pass_plain(*args, dyn=dyn), 2)
        name = "relight_pass_dyn" if dyn else "relight_pass"
        b_ms, b_by = bound(name, moved, work)
        out[name] = (err, ms_k, ms_p, b_ms, b_by)
        earlier = K2_EARLIER_MS.get((label, dyn))
        earlier = f"{earlier:.3f} ms (constant, PERF.md)" if earlier else "not measured"
        phase("kernels", f"relight{variant} {label} {tuple(state.contents.shape)}: packed diff {step}, "
              f"max abs err {err:.3e}, two launches bit-equal; kernel {ms_k:.3f} ms "
              f"(one thread per cube: {earlier}) plain {ms_p:.3f} ms; bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms_k:.1%} of it; {kt.cubes.numel()} listed cubes in "
              f"{-(-kt.cubes.numel() // rk.TILE)} blocks; critical path: "
              f"max_cube_steps {max_cube}, max_warp_steps {max_warp}; "
              f"work {work}")
    full_inc, full_tot = rk.relight_pass_cuda(state.contents, light_rgb, rows, ctx)
    st_inc, st_tot = rk.relight_pass_cuda(state.contents, zero, rows, ctx)
    dyn_inc, _ = rk.relight_pass_cuda(state.contents, light_rgb, rows, ctx, dyn=True)
    if not torch.equal(st_tot, full_tot):
        fail(f"relight on {label}: total weights of the ring-only pass differ from the full pass")
    step = within_step(packed(st_inc + dyn_inc, st_tot), packed(full_inc, full_tot),
                       "full(ring) + light-only vs full")
    phase("kernels", f"relight {label}: full(ring only) + light-only vs full pass: packed diff "
          f"{step}, max abs err {float((st_inc + dyn_inc - full_inc).abs().max()):.3e}")
    return out


def check_empty_work_list(pkg, dev):
    """A state whose every cube is opaque lists no cube: both variants
    give zeros, launch nothing, and nothing faults."""
    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.math import lightpack

    block, GridAab, Space, _Sky, _SpacePhysics = pkg
    box = GridAab.from_lower_size((0, 0, 0), (9, 7, 5))
    sp = Space(box)
    sp.fill(box, block.from_color((0.5, 0.5, 0.5, 1.0)))
    state = sp.snapshot(device=dev)
    ctx = dense.build_relight_ctx(state)
    if ctx.kernel.cubes.numel() != 0:
        fail(f"all-opaque state: {ctx.kernel.cubes.numel()} listed cubes")
    light_rgb = lightpack.decode_rgb(state.light).contiguous()
    before = (rk.LAUNCHES, rk.LAUNCHES_DYN)
    for dyn in (False, True):
        inc, tot = rk.relight_pass_cuda(state.contents, light_rgb, state.tables.light_face_rows, ctx, dyn=dyn)
        torch.cuda.synchronize()
        if bool(inc.any()) or bool(tot.any()):
            fail(f"all-opaque state: the{' light-only' if dyn else ''} pass is not zero")
    if (rk.LAUNCHES, rk.LAUNCHES_DYN) != before:
        fail("all-opaque state: the relight kernel was launched with an empty work list")
    phase("kernels", f"relight all-opaque {tuple(state.contents.shape)}: empty work list, both variants zero, "
          "no launch")


def compare_converge(space, label, dev):
    """The main path's relight on the card (`evaluate_light_dense`: the
    seed, the full pass once over ring-only light, then light-only
    passes over-relaxed with w = OVERRELAX until the plain pass moves no
    cube by more than one step) against the same loop with the kernel's
    plain twin as the pass: passes within one, packed light within one
    step, statuses equal."""
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", dense.OverrelaxFellBack)
        got, passes = dense.evaluate_light_dense(space.snapshot(device=dev))
        kernel_pass = dense.relight_pass
        dense.relight_pass = rk.relight_pass_plain
        try:
            want, want_passes = dense.evaluate_light_dense(space.snapshot(device=dev))
        finally:
            dense.relight_pass = kernel_pass
    fell = [str(w.message) for w in caught if issubclass(w.category, dense.OverrelaxFellBack)]
    for w in caught:
        if not issubclass(w.category, dense.OverrelaxFellBack):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    if fell and label in ("atrium", "plaza640"):
        fail(f"converged relight on {label}: the over-relaxed loop fell back to plain Jacobi: {fell}")
    a = got.light.cpu().numpy().astype(np.int32)
    b = want.light.cpu().numpy().astype(np.int32)
    step = int(np.abs(a[..., :3] - b[..., :3]).max())
    status_equal = np.array_equal(a[..., 3], b[..., 3])
    if abs(passes - want_passes) > 1 or step > RELIGHT_MAX_STEP or not status_equal:
        fail(f"converged relight on {label}: {passes} passes vs plain {want_passes}, "
             f"{step} packed steps, status equal {status_equal}")
    phase("kernels", f"relight converged {label} (w={dense.OVERRELAX}): {passes} passes "
          f"(plain {want_passes}), packed diff {step}, status equal; fall-back to w = 1: "
          f"{fell[0] if fell else 'none'}")


def _local_rays(state, o, d):
    import torch

    dev = state.device
    lower = torch.as_tensor(state.lower, dtype=torch.float32, device=dev)
    o = torch.as_tensor(o, device=dev).reshape(-1, 3) - lower
    d = torch.as_tensor(d, device=dev).reshape(-1, 3)
    return o.contiguous(), d.contiguous()


def compare_trace(state, o, d, label):
    """K1 against its plain twin from the phase-1 launch state, every ray
    listed. Times the phase-1 launch alone (over the walking rays, in
    place, each repetition from a fresh copy of the packed state made
    outside the events), and the packing apart. Returns (max abs error of
    the float fields, launch ms, plain ms, bound ms, bound by)."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk

    ctx = tk.get_bitmask_ctx2(state)
    o, d = _local_rays(state, o, d)
    rays, st, _ = tk.initial_state(state, o, d, ctx)
    out_k = tk.megakernel_cuda(rays, st, ctx)
    work: dict = {}
    out_p = tk.megakernel_plain(rays, st, ctx, work=work)
    torch.cuda.synchronize()
    if bool((out_p["mode"] != tk.MODE_DONE).any()):
        fail(f"trace {label}: plain megakernel left rays walking after {tk.MAX_ITERS} iterations")
    err = _fields_agree(out_k, out_p, tk.STATE_FIELDS, tk.FLOAT_FIELDS, f"trace {label}")

    def pack():
        return tk.PackedRays.pack(rays), tk.pack_fields(st, tk.STATE_FIELDS, tk.FLOAT_FIELDS)

    packed, st_in = pack()
    ms_pack = launch_ms(pack, 20)
    idx = torch.nonzero(st_in[tk.MODE_ROW] == tk.MODE_WALK).squeeze(1)
    ms_k = launch_ms(lambda x: tk.launch_megakernel(packed, x, ctx, idx), 20, fresh=st_in.clone)
    ms_p = cuda_ms(lambda: tk.megakernel_plain(rays, st, ctx), 2)
    m = o.shape[0]
    b_ms, b_by = k1_bound(ctx, work)
    earlier = K1_EARLIER_MS.get(label)
    earlier = f"{earlier:.3f} ms (constant, PERF.md)" if earlier else "not measured"
    phase("kernels", f"trace {label} {m} rays: 28 fields agree, max abs err {err:.3e}, "
          f"launch {ms_k:.3f} ms (parent, launch only: {earlier}), packing {ms_pack:.3f} ms, "
          f"plain {ms_p:.3f} ms, work {work}, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms_k:.1%} of it")
    return err, ms_k, ms_p, b_ms, b_by


def k1_bound(ctx, work) -> tuple[float, str]:
    """K1's bound for one launch: the bytes that the rays walking at launch
    need -- each its step and inverse direction (24 B), its walk state
    (`dom`, `cx..cz`, `tmx..tmz`: 28 B) in and out and its mode out (4 B);
    a ray that ends on a hit its hit record (`hit`, `pidx`, `face`, `t`,
    `nt`, `hx..hz`: 32 B) out; a ray that takes a macro step or pushes its
    origin and direction (24 B); a ray inside a voxel grid at launch or
    entering one its grid registers (`resl`, `vbase`, `tdx..tdz`) and the
    7 saved registers (48 B), once -- plus the tables; the operations of
    the branches they take. From the twin's `work` and the tables only."""
    moved = (work.get("walking", 0) * (24 + 2 * 28 + 4) + work.get("hit_rays", 0) * 32
             + work.get("macro_rays", 0) * 24 + work.get("grid_rays", 0) * 48)
    return bound("trace_megakernel", moved + nbytes(ctx.rows, ctx.l1, ctx.page_idx, ctx.pages), work)


def v1_bound(ctx, work) -> tuple[float, str]:
    """K3's bound for one launch: the bytes that the rays walking at launch
    need -- each its step and inverse direction (24 B), its state but the
    grid resolution (32 B) and its 15 output fields (60 B); a ray in a
    voxel grid its resolution (4 B) too, a ray that takes a macro step its
    origin and direction (24 B) too -- plus the tables; the operations of
    the branches they take."""
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    walking = work.get("walking", 0)
    moved = (walking * (6 * 4 + (len(v1.STATE_FIELDS) - 1 + len(v1.OUT_FIELDS)) * 4)
             + work.get("inner", 0) * 4 + work.get("macro_rays", 0) * 6 * 4)
    return bound("trace_v1", moved + nbytes(ctx.rows, ctx.l1), work)


def compare_v1(state, o, d, label, inner_round=False):
    """K3 against its plain twin from the phase-1 launch state (and, with
    `inner_round`, from the state the round glue makes of its result).
    Times the first launch alone on packed inputs, and the packing apart.
    Returns (max abs error of the float fields, launch ms, plain ms, bound
    ms, bound by) of the first launch."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    ctx = v1.get_bitmask_ctx(state)
    o, d = _local_rays(state, o, d)
    rays, st2, entry = tk.initial_state(state, o, d, ctx)
    st = v1.initial_state_v1(st2)
    out_k = v1.surface_finder_cuda(rays, st, ctx)
    work: dict = {}
    out_p = v1.surface_finder_plain(rays, st, ctx, work=work)
    torch.cuda.synchronize()
    if bool(out_p["walking"].any()):
        fail(f"trace v1 {label}: plain surface finder left rays walking after {v1.ITERS} iterations")
    err = _fields_agree(out_k, out_p, v1.OUT_FIELDS, v1.FLOAT_FIELDS, f"trace v1 {label}")
    note = ""
    if inner_round:
        saved, hb = v1.empty_buffers(o.shape[0], state.device)
        st_b, _, _ = v1.advance(state, ctx, rays, entry["d_len"], st, saved, hb, out_p)
        out_kb = v1.surface_finder_cuda(rays, st_b, ctx)
        out_pb = v1.surface_finder_plain(rays, st_b, ctx)
        err = max(err, _fields_agree(out_kb, out_pb, v1.OUT_FIELDS, v1.FLOAT_FIELDS,
                                     f"trace v1 {label} inner round"))
        kinds = sorted(set(out_pb["hit"].cpu().numpy().tolist()))
        note = f"; inner round agrees (hit kinds {kinds})"
    def pack():
        return tk.PackedRays.pack(rays), tk.pack_fields(st, v1.STATE_FIELDS, v1.FLOAT_FIELDS)

    packed, st_in = pack()
    ms_pack = launch_ms(pack, 20)
    ms_k = launch_ms(lambda: v1.launch(packed, st_in, ctx), 20)
    ms_p = cuda_ms(lambda: v1.surface_finder_plain(rays, st, ctx), 2)
    m = o.shape[0]
    longest = int(work.pop("ray_steps").max())
    b_ms, b_by = v1_bound(ctx, work)
    earlier = K3_EARLIER_MS.get(label)
    earlier = f"{earlier:.3f} ms (constant, PERF.md)" if earlier else "not measured"
    phase("kernels", f"trace v1 {label} {m} rays: 15 fields agree, max abs err {err:.3e}{note}, "
          f"launch {ms_k:.3f} ms (parent, launch only: {earlier}), packing {ms_pack:.3f} ms, "
          f"plain {ms_p:.3f} ms, work {work}, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms_k:.1%} of it; "
          f"critical path: longest ray {longest} attempts")
    return err, ms_k, ms_p, b_ms, b_by


def compare_paths(state, o, d, opts, label):
    """The same rays traced through the v1 path and the megakernel path:
    pixels further apart than PIXEL_ATOL may be at most PIXEL_MAX_SHARE of
    the frame."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk

    l1, t1, u1 = tk.trace_rays_kernel(state, o, d, opts, megakernel=False)
    l2, t2, u2 = tk.trace_rays_kernel(state, o, d, opts, megakernel=True)
    torch.cuda.synchronize()
    if u1 or u2:
        fail(f"paths {label}: unfinished rays (v1 {u1}, megakernel {u2})")
    n = l1.shape[0] * l1.shape[1]
    far = ((l1 - l2).abs().amax(-1) > PIXEL_ATOL) | ((t1 - t2).abs() > PIXEL_ATOL)
    n_far = int(far.sum())
    if n_far > PIXEL_MAX_SHARE * n:
        fail(f"paths {label}: {n_far} of {n} pixels differ by more than {PIXEL_ATOL}")
    phase("kernels", f"paths {label}: v1 vs megakernel on {n} rays: {n_far} pixels over "
          f"{PIXEL_ATOL} (limit {int(PIXEL_MAX_SHARE * n)}), max abs diff {float((l1 - l2).abs().max()):.3e}")


def profiled_frame(fn) -> str:
    """Wall time of one synchronized call of `fn` under torch.profiler,
    the device time it recorded (the self time of the device events, as
    the profiler's own table sums it: the CPU ops' rows repeat the time
    of the kernels they launch), the busy share, the five kernels that
    took the most device time, and the port's own kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.self_device_time_total / 1e3, e.key, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    device_ms = sum(r[0] for r in rows)
    top = sorted(rows, reverse=True)[:5]
    ours = [r for r in rows if "(anonymous namespace)::" in r[1] and "at::native" not in r[1]]
    return (f"wall {wall_ms:.1f} ms, device {device_ms:.3f} ms (busy {device_ms / wall_ms:.1%}); top: "
            + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, k, n in top)
            + "; the port's kernels: " + ("; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, k, n in ours) or "none"))


def v1_frame_launches(fn) -> list:
    """Every K3 launch made while `fn` runs, timed alone: a short spin
    kernel queued ahead of each keeps the host's time out of its events.
    Returns one dict per launch: its inputs (packed rays, a copy of the
    state, the walking list or None), a copy of its output, and its
    events."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    real = v1.launch
    records = []

    def timed(rays, st_in, ctx, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES_ONE)
        start.record()
        out = real(rays, st_in, ctx, *args, **kwargs)
        end.record()
        idx = kwargs.get("idx", args[0] if args else None)
        records.append(dict(rays=rays, st=st_in.clone(), idx=None if idx is None else idx.clone(),
                            out=out.clone(), ctx=ctx, events=(start, end)))
        return out

    v1.launch = timed
    try:
        fn()
    finally:
        v1.launch = real
    torch.cuda.synchronize()
    return records


def k1_frame_launches(fn) -> list:
    """Every K1 launch made while `fn` runs, timed alone: a short spin
    kernel queued ahead of each keeps the host's time out of its events.
    Returns one dict per launch: its inputs (packed rays, a copy of the
    state before it, the list), a copy of the state after it, and its
    events."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk

    real = tk.launch_megakernel
    records = []

    def timed(rays, st, ctx, idx):
        before = st.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES_ONE)
        start.record()
        real(rays, st, ctx, idx)
        end.record()
        records.append(dict(rays=rays, st=before, idx=idx.clone(), out=st.clone(), ctx=ctx,
                            events=(start, end)))

    tk.launch_megakernel = timed
    try:
        fn()
    finally:
        tk.launch_megakernel = real
    torch.cuda.synchronize()
    return records


def check_k1_launches(records, label) -> list:
    """Each recorded K1 launch of a frame against the plain twin on the
    listed rays: the 28 fields agree, and the columns off the list are
    the state's before the launch, bit for bit.
    Then each launch replayed alone (launch only, mean of 20, each from a
    fresh copy of its input state made outside the events), the twin on
    the same rays, and `k1_bound`. Returns per launch (walking rays,
    in-frame ms, replayed ms, bound ms, bound by, max abs err, plain ms)."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk

    rows = []
    for p, rec in enumerate(records, 1):
        rays, st, idx, ctx, out = rec["rays"], rec["st"], rec["idx"], rec["ctx"], rec["out"]
        fields = rays.take(idx).fields()
        st_d = tk.unpack_fields(st[:, idx], tk.STATE_FIELDS, tk.FLOAT_FIELDS)
        work: dict = {}
        want = tk.megakernel_plain(fields, st_d, ctx, work=work)
        got = tk.unpack_fields(out[:, idx], tk.STATE_FIELDS, tk.FLOAT_FIELDS)
        err = _fields_agree(got, want, tk.STATE_FIELDS, tk.FLOAT_FIELDS, f"trace {label} phase {p}")
        off = torch.ones(st.shape[1], dtype=torch.bool, device=st.device)
        off[idx] = False
        if not torch.equal(out[:, off], st[:, off]):
            fail(f"trace {label} phase {p}: the launch wrote columns off its list")
        ms_frame = rec["events"][0].elapsed_time(rec["events"][1])
        ms = launch_ms(lambda x: tk.launch_megakernel(rays, x, ctx, idx), 20, fresh=st.clone)
        ms_p = cuda_ms(lambda: tk.megakernel_plain(fields, st_d, ctx), 1)
        b_ms, b_by = k1_bound(ctx, work)
        rows.append((int(work["walking"]), ms_frame, ms, b_ms, b_by, err, ms_p))
        earlier = K1_EARLIER_MS.get(f"{label} phase {p}")
        earlier = f"{earlier:.4f} ms (constant, PERF.md)" if earlier else "not measured"
        phase("kernels", f"trace {label} phase {p}: {work['walking']} walking rays of {st.shape[1]}, 28 fields "
              f"agree with the twin (max abs err {err:.3e}), {int(off.sum())} columns off the list untouched; launch {ms:.4f} ms (in the frame "
              f"{ms_frame:.4f} ms; parent: {earlier}), plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.1%} of it; work {work}")
        del rec["out"], rec["st"]
    torch.cuda.synchronize()
    return rows


def k1_frame_summary(rows, label) -> tuple:
    """One line for a frame's K1 launches (`check_k1_launches`' rows);
    returns the frame as a kernels-line entry: (max abs err, summed launch
    ms, summed plain ms, summed bound ms, what bounds the largest)."""
    if not rows:
        fail(f"trace {label}: the frame launched no K1")
    phase("kernels", f"trace {label} frame: {len(rows)} K1 launches, walking rays {[r[0] for r in rows]}; "
          f"launch only (ms) {[round(r[2], 4) for r in rows]}, sum {sum(r[2] for r in rows):.4f} (in the frame "
          f"{sum(r[1] for r in rows):.4f}); bound {sum(r[3] for r in rows):.4f} ms")
    return (max(r[5] for r in rows), sum(r[2] for r in rows), sum(r[6] for r in rows),
            sum(r[3] for r in rows), max(rows, key=lambda r: r[3])[4])


def host_ms(fn, reps: int, setup=None) -> float:
    """Mean host-clock ms of `fn(setup())` between synchronizations, the
    set-up outside the clock."""
    import torch

    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total * 1e3 / reps


def check_v1_rounds(records, label, state) -> list:
    """Each recorded K3 launch of a frame against the plain twin on the
    same rays (the walking list's, where the launch had one): 15 fields
    agree. Then each launch replayed alone (launch only, mean of 20) beside
    the parent's time. Returns per launch (walking rays, in-frame ms, replayed ms, bound ms,
    bound by, longest ray's attempts)."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    rows = []
    for r, rec in enumerate(records, 1):
        rays, st, idx, ctx = rec["rays"], rec["st"], rec["idx"], rec["ctx"]
        fields = rays.fields() if idx is None else rays.take(idx).fields()
        st_d = tk.unpack_fields(st if idx is None else st[:, idx], v1.STATE_FIELDS, v1.FLOAT_FIELDS)
        work: dict = {}
        want = v1.surface_finder_plain(fields, st_d, ctx, work=work)
        got = tk.unpack_fields(rec["out"], v1.OUT_FIELDS, v1.FLOAT_FIELDS)
        _fields_agree(got, want, v1.OUT_FIELDS, v1.FLOAT_FIELDS, f"trace v1 {label} round {r}")
        longest = int(work.pop("ray_steps").max()) if work["rays"] else 0
        b_ms, b_by = v1_bound(ctx, work)
        ms_frame = rec["events"][0].elapsed_time(rec["events"][1])
        ms = launch_ms(lambda: v1.launch(rays, st, ctx, *(() if idx is None else (idx,))), 20)
        rows.append((int(work["walking"]), ms_frame, ms, b_ms, b_by, longest))
        earlier = K3_EARLIER_MS.get(f"{label} round {r}")
        earlier = f"{earlier:.3f} ms (constant, PERF.md)" if earlier else "not measured"
        phase("kernels", f"trace v1 {label} round {r}: {work['walking']} walking rays, 15 fields agree "
              f"with the twin; launch {ms:.4f} ms (in the frame {ms_frame:.4f} ms; parent: {earlier}), "
              f"bound {b_ms:.4f} ms ({b_by}); longest ray {longest} attempts; work {work}")
        del rec["out"], rec["st"]
    torch.cuda.synchronize()
    return rows


def check_listed_frame(state, o, d, opts, label, megakernel) -> None:
    """A trace path's listed loop (K1: `_phases_v2`, each phase over its
    walking rays; K3: `trace_phases_v1`, each round over its walking rays)
    against its all-ray loop (`aic_tpu`'s: every launch over all rays, on
    per-field state) on one frame's rays: every phase's hit buffers, the
    light, the transmittance and `unfinished` bit for bit; a launch over
    an empty list launches nothing. Then the trace stage through each
    loop, host clock, alternated (all rays, listed, listed, all rays; five
    times)."""
    import torch
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1

    owner, name, all_rays = ((tk, "_phases_v2", tk.phases_all_rays) if megakernel
                             else (v1, "trace_phases_v1", v1.trace_phases_all_rays))
    listed = getattr(owner, name)
    kernel = "trace" if megakernel else "trace v1"

    def with_loop(loop, fn):
        setattr(owner, name, loop)
        try:
            return fn()
        finally:
            setattr(owner, name, listed)

    def traced(loop):
        hits = []
        real_shader = tk.make_phase_shader

        def recording_shader(*args):
            shade = real_shader(*args)

            def f(hb, la, ta):
                hits.append({k: v.clone() for k, v in hb.items()})
                return shade(hb, la, ta)
            return f

        tk.make_phase_shader = recording_shader
        try:
            light, trans, unfinished = with_loop(
                loop, lambda: tk.trace_rays_kernel(state, o, d, opts, megakernel=megakernel))
        finally:
            tk.make_phase_shader = real_shader
        return light, trans, unfinished, hits

    a, b = traced(listed), traced(all_rays)
    torch.cuda.synchronize()
    same = (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2] and len(a[3]) == len(b[3])
            and all(torch.equal(x[k], y[k]) for x, y in zip(a[3], b[3]) for k in x))
    if not same:
        fail(f"{kernel} {label}: the listed frame differs from the all-ray frame")
    m = 4
    rays = tk.PackedRays(torch.zeros((9, m), device=o.device), torch.zeros((3, m), dtype=torch.int32, device=o.device))
    empty = torch.zeros(0, dtype=torch.int64, device=o.device)
    if megakernel:
        before = tk.LAUNCHES
        buf = torch.ones((len(tk.STATE_FIELDS), m), dtype=torch.int32, device=o.device)
        tk.launch_megakernel(rays, buf, tk.get_bitmask_ctx2(state), empty)
        torch.cuda.synchronize()
        launched = tk.LAUNCHES != before or bool((buf != 1).any())
    else:
        before = v1.LAUNCHES
        out = v1.launch(rays, torch.zeros((9, m), dtype=torch.int32, device=o.device), v1.get_bitmask_ctx(state),
                        empty)
        launched = v1.LAUNCHES != before or out.shape != (15, 0)
    if launched:
        fail(f"{kernel} {label}: an empty list launched the kernel")
    stage_ms = {listed: [], all_rays: []}
    for loop in [all_rays, listed, listed, all_rays] * 5:
        stage_ms[loop].append(host_ms(lambda _: with_loop(
            loop, lambda: tk.trace_rays_kernel(state, o, d, opts, megakernel=megakernel)), 1))
    ms_list, ms_all = (sum(t) / len(t) for t in stage_ms.values())
    med_list, med_all = (sorted(t)[len(t) // 2] for t in stage_ms.values())
    phase("kernels", f"{kernel} {label}: listed frame equals the all-ray frame bit for bit "
          f"({len(a[3])} phases' hit buffers, light, transmittance, unfinished {a[2]}); an empty list "
          f"launches nothing; trace stage (host clock, synchronized, alternated, 10 each; mean / median): "
          f"listed {ms_list:.3f} / {med_list:.3f} ms, all rays (per-field state) {ms_all:.3f} / "
          f"{med_all:.3f} ms")


def stage(stages: dict, name: str, fn):
    """Run `fn` once between two synchronizations; its host-clock ms go
    into `stages[name]`. Returns what `fn` returns."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def relight_stages(space, lit, dev) -> dict:
    """The main path's relight one stage at a time (ms, one synchronized
    call each, host clock): seed, context, the convergence loop, and one
    pass of each variant over the converged light."""
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light.refproc import fast_evaluate_seed
    from aic_tpu_torch.math import lightpack

    stages: dict = {}
    snap = space.snapshot(device=dev)
    seeded, _ = stage(stages, "relight_seed", lambda: fast_evaluate_seed(snap))
    ctx = stage(stages, "relight_ctx", lambda: dense.build_relight_ctx(seeded))
    _, passes = stage(stages, "relight_passes", lambda: dense.converge(seeded, ctx, overrelax=dense.OVERRELAX))
    stages["passes_run"] = passes
    lrgb = lightpack.decode_rgb(lit.light).contiguous()
    rows = lit.tables.light_face_rows
    stage(stages, "relight_pass_full", lambda: rk.relight_pass_cuda(lit.contents, lrgb, rows, ctx))
    stage(stages, "relight_pass_dyn", lambda: rk.relight_pass_cuda(lit.contents, lrgb, rows, ctx, dyn=True))
    return stages


# -- the step loop -------------------------------------------------------------

#: The step phases: ticks timed after STEP_WARMUP ticks of warm-up (the
#: Become chain interns its frames over its first cycle; bench.py warms
#: demo-city 35 steps), the Become cycle's period, and how often the
#: placing behavior commits.
STEP_TICKS = {"atrium": 120, "plaza640": 60}
STEP_WARMUP = 36
CYCLE_PERIOD = 6
PLACE_EVERY = 10
#: Ticks of the device tick against the per-cube host path.
TICK_VS_HOST = 30


def free_cubes(space, n):
    """n air cubes that rest on a block, nearest the centre of the bounds
    first (world coords)."""
    c = space.contents
    on_block = np.zeros(c.shape, bool)
    on_block[:, 1:, :] = (c[:, 1:, :] == 0) & (c[:, :-1, :] != 0)
    cand = np.argwhere(on_block)
    order = np.argsort(((cand - np.asarray(c.shape) / 2) ** 2).sum(-1), kind="stable")
    return [tuple(int(v + lo) for v, lo in zip(cand[i], space.bounds.lower)) for i in order[:n]]


def make_placer(cubes, every):
    """A behavior standing in for a player who places and removes blocks:
    every `every` ticks it toggles each cube between air and the block
    under it, blocks the palette already holds, so its commits scatter
    onto the device state."""
    from aic_tpu_torch import block
    from aic_tpu_torch import universe as U

    class Placer(U.Behavior):
        def step(self, universe, host, tick):
            sp = universe.spaces[host]
            txn = U.SpaceTransaction()
            for x, y, z in cubes:
                cur = sp.block_at((x, y, z))
                new = block.AIR if cur != block.AIR else sp.block_at((x, y - 1, z))
                txn = txn.merge(U.SpaceTransaction.set_cube((x, y, z), old=cur, new=new))
            return U.UniverseTransaction(spaces={host: txn}), every

    return Placer()


def cycle_world(space, n_cycle=4, n_placed=3):
    """Put a two-frame Become cycle of period CYCLE_PERIOD on n_cycle free
    cubes of the space, as demo-city places its signal; returns the cubes
    left for the placer."""
    from aic_tpu_torch import block
    from aic_tpu_torch.content.exhibits import _become_cycle

    frames = _become_cycle([block.from_color((1.0, 0.1, 0.1, 1.0), "signal-red"),
                            block.from_color((0.1, 1.0, 0.1, 1.0), "signal-green")], period=CYCLE_PERIOD)
    cubes = free_cubes(space, n_cycle + n_placed)
    for i, c in enumerate(cubes[:n_cycle]):
        space.set(c, frames[i % 2])
    return cubes[n_cycle:]


def timed_step(u) -> tuple[float, object]:
    """One synchronized `Universe.step` on the host clock (ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = u.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, info


def step_world(name, camera, dev, reset_counts, read_counts) -> dict:
    """The step loop's main path on one template: `build_universe` on the
    card, the load relight through `evaluate_light`, a Become cycle and
    the placer, STEP_WARMUP ticks, then STEP_TICKS[name] ticks timed one
    by one and a 1920x1080 frame of the stepped world, with the launch
    counters read around them. Checks the host contents against the
    device's, the device cells against a fresh snapshot's, and the frame
    against a frame of a fresh snapshot with the stepped light. Then 12
    ticks with synchronized profiler spans for the phases, one cycle of
    ticks under torch.profiler (the card's busy share), STEP_TICKS[name]
    ticks with each listed K2 launch timed (`listed_launches_over`), a
    round's stages, its eager rounds against graph replays and the cost
    of a round on an empty queue (`round_replay`), and a
    commit that grows the palette (a resnapshot) timed apart."""
    import dataclasses

    import torch
    from aic_tpu_torch import block
    from aic_tpu_torch import universe as U
    from aic_tpu_torch.content import build_universe
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.raytrace import render

    t0 = time.perf_counter()
    u = build_universe(name, device=dev)
    sp = u.spaces["world"]
    placed = cycle_world(sp)
    u.resnapshot("world")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, n = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
    torch.cuda.synchronize()
    relight_s = time.perf_counter() - t0
    u.states["world"] = state
    u.add_behavior("world", make_placer(placed, PLACE_EVERY))

    warm = [timed_step(u)[0] for _ in range(STEP_WARMUP)]
    reset_counts()
    with walked_rows() as batches:
        timed = [timed_step(u) for _ in range(STEP_TICKS[name])]
    t0 = time.perf_counter()
    frame = render(u.states["world"], camera)
    frame_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    ms = [t for t, _ in timed]
    infos = [i for _, i in timed]
    device_ticks = sum(1 for i in infos if i._device_stats)
    updates = sum(i.light_updates for i in infos)
    queue = infos[-1].light_queue
    walked = [int(w) for w, _ in batches]
    busiest = batches[int(np.argmax(walked))][1] if batches else None
    del batches

    st = u.states["world"]
    if not np.array_equal(sp.contents.astype(np.int32), st.contents.cpu().numpy()):
        fail(f"step {name}: the host Space's contents differ from the device contents")
    fresh = dataclasses.replace(sp.snapshot(device=dev), light=st.light)
    if not torch.equal(fresh.cells, st.cells):
        fail(f"step {name}: the stepped cells differ from a fresh snapshot's")
    check_frame(frame, st, f"step {name}")
    ref = render(fresh, camera)
    far = (np.abs(frame.data.astype(np.int32) - ref.data.astype(np.int32)) > 1).any(-1)
    if far.sum() > PIXEL_MAX_SHARE * far.size:
        fail(f"step {name}: {int(far.sum())} pixels of the stepped frame differ from a fresh snapshot's")

    u.profiler.reset()
    u.profiler.sync = torch.cuda.synchronize
    for _ in range(12):
        u.step()
    u.profiler.sync = None
    spans = {k: round(v.total_s * 1e3 / v.calls, 3) for k, v in u.profiler.spans.items()}
    profiled = profiled_frame(lambda: [u.step() for _ in range(CYCLE_PERIOD)])
    tick_launches = listed_launches_over(lambda: [u.step() for _ in range(STEP_TICKS[name])])
    rounds = round_stages(u.states["world"], u.light_batch_size)
    replay = round_replay(u.states["world"], u.light_batch_size)

    grow = U.UniverseTransaction(spaces={"world": U.SpaceTransaction.set_cube(
        placed[0], new=block.from_color((0.3, 0.6, 0.9, 1.0), "grown"))})
    pal = sp.palette_len()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grow.execute(u)
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    if sp.palette_len() != pal + 1 or u.states["world"].tables.face_colors[sp.palette_len() - 1, 6, 3] <= 0:
        fail(f"step {name}: the palette-growing commit did not resnapshot")

    med = float(np.median(ms))
    phase("step", f"{name} {tuple(st.contents.shape)}: built + snapshotted {build_s:.3f} s, load relight "
          f"(evaluate_light) {n} cube updates in {relight_s:.3f} s; warm-up {STEP_WARMUP} ticks: first "
          f"{warm[0]:.1f} ms, median {float(np.median(warm)):.3f} ms; {len(ms)} ticks: median {med:.3f} ms a step "
          f"(mean {float(np.mean(ms)):.3f}, min {min(ms):.3f}, max {max(ms):.3f}), {device_ticks} device-ticked; "
          f"light updates {updates}, queue after {queue}; rows K2 walked per listed launch: "
          f"mean {float(np.mean(walked)) if walked else 0:.2f} of {u.light_batch_size}, max {max(walked, default=0)}, "
          f"{sum(w == 0 for w in walked)} of {len(walked)} launches walked none; "
          f"phases (ms a tick, synchronized spans, 12 ticks) "
          f"{spans}; a light round's stages (ms, median of 5, synchronized) {rounds}; {replay}; "
          f"{CYCLE_PERIOD} ticks under torch.profiler: {profiled}; "
          f"frame {camera.viewport.width}x{camera.viewport.height} {frame_ms:.1f} ms, equal to a fresh snapshot's ({int(far.sum())} pixels "
          f"over 1); host contents = device contents; palette-growing commit (resnapshot) {grow_ms:.1f} ms; "
          f"launches {counts}")
    if busiest is None or max(walked) == 0:
        fail(f"step {name}: no listed K2 launch of the timed ticks walked a row")
    batch = check_batch(*busiest, name, f"busiest step round ({max(walked)} walked)", profile=True)
    phase("step", f"{name}: K2 listed over {STEP_TICKS[name]} ticks after the timed ones: {tick_launches}; "
          f"the busiest batch of the timed ticks {batch[1]:.4f} ms launch only")
    return dict(counts=counts, median_ms=med, ticks=len(ms), spans=spans, batch=batch)


class walked_rows:
    """Within the block, every batch a queue round makes inputs for is
    kept as (walked rows, (state, cubes, valid)), the count a
    tensor on the card, so the ticks read nothing back."""

    def __enter__(self):
        from aic_tpu_torch.light import update

        self.update, self.real, self.batches = update, update.listed_inputs, []

        def counting(state, cubes, valid, *rest):
            args, org = self.real(state, cubes, valid, *rest)
            self.batches.append((args[6].any(-1).sum(), (state, cubes, valid)))
            return args, org

        update.listed_inputs = counting
        return self.batches

    def __exit__(self, *exc):
        self.update.listed_inputs = self.real
        return False


def listed_launches_over(fn) -> str:
    """Every launch of K2's listed kernel while `fn` runs (ticks of their
    own, after the timed ones, which this would slow), timed alone: the C
    call is bracketed by CUDA events, a spin kernel (SPIN_CYCLES)
    queued ahead so that they time the card's work only. Returns the
    launches, the mean and max ms, and how many windows the spin did not
    cover (the host took longer to reach the launch than the spin ran:
    such a window may hold host time)."""
    import torch
    from aic_tpu_torch.light import relight_kernel as rk

    real, events = rk._listed_fn, []

    def timed_fn():
        fn_c = real()

        def call(*args):
            before = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            before.record()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            err = fn_c(*args)
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            events.append((before, start, end, host_ms))
            return err

        return call

    rk._listed_fn = timed_fn
    try:
        fn()
    finally:
        rk._listed_fn = real
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for _b, s, e, _h in events]
    if not ms:
        return "no listed launch"
    short = sum(b.elapsed_time(s) < h for b, s, _e, h in events)
    return (f"{len(ms)} listed launches: mean {float(np.mean(ms)):.4f} ms, max {max(ms):.4f} ms "
            f"(CUDA events around each launch; {short} of {len(ms)} windows not covered by the spin ahead)")


def round_stages(state, batch_size) -> dict:
    """One queue round of the stepped state, a stage at a time (host clock,
    synchronized, median of 5): the selection, the relight the round makes
    (`relight_listed_batch`: the origins, the K2 launch, `finish`), and the
    whole round, whose rest is the scatters and re-enqueue."""
    from aic_tpu_torch.light import update

    runs: dict = {}
    for _ in range(5):
        st: dict = {}
        pos, valid, _ = stage(st, "select", lambda: update.select_batch(state.light_dirty, batch_size))
        stage(st, "relight", lambda: update.relight_listed_batch(state, pos, valid))
        stage(st, "round", lambda: update.light_update_round(state, batch_size))
        st["scatter_and_rest"] = st["round"] - st["select"] - st["relight"]
        for k, v in st.items():
            runs.setdefault(k, []).append(v)
    return {k: round(float(np.median(v)), 3) for k, v in runs.items()}


def round_replay(state, batch_size, rounds=8, reps=4) -> str:
    """`rounds` queue rounds in a row from the stepped state (host clock,
    synchronized before the first and after the last), eager
    (`light_update_round`, as a device tick runs them) and as replays of
    the state's `RoundGraph` (as `evaluate_light` runs them, with its
    copies in and out), and eager rounds on the state with its queue
    emptied (all padding: what the step's callers skip where
    `queue_known_empty`), alternated eager, graph, padding, padding,
    graph, eager, `reps` times: the median ms a round of each. The eager
    rounds and the replays end bit-equal."""
    import dataclasses

    import torch
    from aic_tpu_torch.light import update

    graph = update.round_graph(state, batch_size)
    empty = dataclasses.replace(state, light_dirty=torch.zeros_like(state.light_dirty))
    ms: dict = {"eager": [], "graph": [], "padding": []}

    def run(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode != "graph":
            st = state if mode == "eager" else empty
            for _ in range(rounds):
                st, _stats = update.light_update_round(st, batch_size)
        else:
            graph.load(state)
            for _ in range(rounds):
                graph.replay()
            st = graph.result(state)
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / rounds)
        return st

    a, b = run("eager"), run("graph")
    if not (torch.equal(a.light, b.light) and torch.equal(a.light_dirty, b.light_dirty)):
        fail(f"{rounds} queue rounds: the graph's replays differ from the eager rounds")
    run("padding")
    for v in ms.values():
        v.clear()
    for _ in range(reps):
        for mode in ("eager", "graph", "padding", "padding", "graph", "eager"):
            run(mode)
    return (f"{rounds} rounds in a row, ms a round (median of {2 * reps}, alternated): eager "
            f"{float(np.median(ms['eager'])):.4f}, graph replays {float(np.median(ms['graph'])):.4f}, bit-equal; "
            f"eager on an empty queue (all padding) {float(np.median(ms['padding'])):.4f}")


def batch_cases(state, seed=0) -> dict:
    """K2's batches: a first queue round's 16 cubes after an edit of
    the relit state (the block nearest the centre removed), seeded random
    batches of 16 and 1024 distinct cubes (every fourth row padding), one
    row (a seeded air cube resting on a block, so it has ray weight) and
    16 rows that are all padding."""
    import torch
    from aic_tpu_torch.light.update import select_batch
    from aic_tpu_torch.space.state import scatter_set_cubes

    dev = state.device
    shape = tuple(state.contents.shape)
    contents = state.contents.cpu().numpy()
    solid = np.argwhere(contents != 0)
    mid = solid[np.argmin(((solid - np.asarray(shape) / 2) ** 2).sum(-1))]
    edited = scatter_set_cubes(state, torch.as_tensor(mid[None], device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev))
    pos, valid, _ = select_batch(edited.light_dirty, 16)
    cases = {"first round": (edited, pos, valid)}
    rng = np.random.default_rng(seed)
    for n in (16, 1024):
        flat = rng.choice(int(np.prod(shape)), size=n, replace=False)
        cubes = np.stack(np.unravel_index(flat, shape), -1)
        cases[f"random {n}"] = (state, torch.as_tensor(cubes, device=dev),
                                torch.as_tensor(np.arange(n) % 4 != 3, device=dev))
    resting = np.argwhere((contents[:, 1:, :] == 0) & (contents[:, :-1, :] != 0)) + (0, 1, 0)
    one = resting[rng.integers(len(resting))]
    cases["one row"] = (state, torch.as_tensor(one[None], device=dev), torch.ones(1, dtype=torch.bool, device=dev))
    flat = rng.choice(int(np.prod(shape)), size=16, replace=False)
    cases["all padding"] = (state, torch.as_tensor(np.stack(np.unravel_index(flat, shape), -1), device=dev),
                            torch.zeros(16, dtype=torch.bool, device=dev))
    return cases


def listed_chain(lengths, pairs) -> tuple[int, float]:
    """The listed kernel's chain over a batch, from the pair steps of each
    walked (cube, chart ray) of the twin's walk (its `lengths` list): a
    lane walks one ray, so the launch's longest chain is the batch's
    longest walked ray (max_ray_steps); and how evenly the lanes of a warp
    (32 rays of one row, `pairs.lane_ray`) end: the steps walked over 32
    times each walking warp's longest lane (lane use)."""
    import torch
    from aic_tpu_torch.light import relight_kernel as rk

    if not lengths:
        return 0, 0.0
    cube, ray, steps = (torch.cat(col) for col in zip(*lengths))
    steps = steps.long()
    lanes = pairs.lane_ray.long()
    warp = torch.empty(pairs.cosines.shape[0], dtype=torch.long, device=cube.device)
    slots = torch.arange(lanes.numel(), device=cube.device)
    warp[lanes[lanes >= 0]] = slots[lanes >= 0] // rk.LANES
    _keys, inv = torch.unique(cube * (lanes.numel() // rk.LANES) + warp[ray], return_inverse=True)
    longest = torch.zeros(_keys.numel(), dtype=torch.long, device=cube.device)
    longest.scatter_reduce_(0, inv, steps, "amax")
    return int(steps.max()), float(steps.sum()) / float(rk.LANES * longest.sum())


def listed_work(state, cubes, valid) -> tuple[dict, int, tuple[int, int], tuple[int, float]]:
    """The plain pass's work counts, the bytes the listed kernel needs for
    the batch's walks, the critical path of the volume pass's tile design
    on the batch (`critical_path`, what the listed launch was before) and
    the listed kernel's chain (`listed_chain`): the plain twin over a
    context whose only weighted cubes are the batch's walked rows. Bytes:
    the batch's rows in (cube, ray weights, alpha) and out (incoming,
    total), the pair and lane tables and the decode table once, one mask
    byte a step, and for a visible step its cube's index, face row and
    two packed light texels."""
    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light import update
    from aic_tpu_torch.math import lightpack

    (contents, light, rows, _mask, p, flat_all, dw_rows, a0_rows), _org = update.listed_inputs(state, cubes, valid)
    X, Y, Z = contents.shape
    walked = dw_rows.any(-1)
    flat = flat_all.long()[walked]
    dw = torch.zeros((X * Y * Z, 6), device=state.device)
    dw[flat] = dw_rows[walked]
    alpha0 = torch.ones(X * Y * Z, device=state.device)
    alpha0[flat] = a0_rows[walked]
    ctx = dense.RelightCtx(dir_weights=dw.reshape(X, Y, Z, 6), alpha0=alpha0.reshape(X, Y, Z),
                           incoming0=None, origin_opaque=torch.zeros((X, Y, Z), dtype=torch.bool, device=state.device),
                           origin_emission=None, pairs=p, kernel=None)
    work: dict = {}
    lengths: list = []
    rk.relight_pass_plain(contents, lightpack.decode_rgb(light), rows, ctx, work=work, lengths=lengths)
    path = critical_path(ctx, lengths, listed=flat_all)
    chain = listed_chain(lengths, p)
    n = cubes.shape[0]
    moved = (n * (4 + 24 + 4 + 12 + 4) + nbytes(p.cosines, p.sky_ray, p.lane_ray, p.lane_start, p.words)
             + 256 * 4 + work.get("steps", 0) + work.get("visible", 0) * (4 + 32 + 8))
    return work, moved, path, chain


def compare_batch(state, label) -> dict:
    """K2 over a queue round's batch on each of `batch_cases`
    (`check_batch`; the all-padding batch `check_padding_batch`). Returns
    {batch label: `check_batch`'s tuple}."""
    out = {}
    for blabel, (st, cubes, valid) in batch_cases(state).items():
        if bool(valid.any()):
            out[blabel] = check_batch(st, cubes, valid, label, blabel)
        else:
            check_padding_batch(st, cubes, valid, label, blabel)
    return out


def check_padding_batch(st, cubes, valid, label, blabel) -> None:
    """A batch whose every row is padding: `relight_batch_cuda` gives
    zeros, as the plain walk does, and launches nothing."""
    import torch
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light import update

    before = rk.LAUNCHES_LISTED
    got = update.relight_batch_cuda(st, cubes, valid)
    torch.cuda.synchronize()
    if rk.LAUNCHES_LISTED != before:
        fail(f"relight batch {label} {blabel}: {rk.LAUNCHES_LISTED - before} listed launches, not 0")
    if bool(got.any()) or bool(update.relight_batch_plain(st, cubes, valid).any()):
        fail(f"relight batch {label} {blabel}: a padding row is not 0")
    phase("kernels", f"relight batch {label} {blabel}: {cubes.shape[0]} rows, none valid: zeros as the plain "
          f"walk's, no launch")


def check_batch(st, cubes, valid, label, blabel, profile=False) -> tuple:
    """K2 over one batch (`relight_batch_cuda`: one listed launch) against
    the plain `relight_batch` walk on it: packed light within one step
    and statuses equal on the valid rows, padding rows 0, one launch a
    call, two launches on the same inputs bit-equal, and the kernel's
    decode table looked up on the state's light bit-equal to
    `decode_rgb`. Times the listed launch alone (inputs made first,
    `launch_ms`), the whole card call, the call with the volume decode
    that the call made before the listed kernel read packed light (both
    host-bound), the decode's card time alone (`launch_ms`), and the
    plain walk, beside the earlier design's times
    (`K2_LISTED_EARLIER_MS`), the bound from the batch's own walks and
    the chains of both designs. With `profile`, ten calls with and ten
    without the volume decode under torch.profiler: the call is host
    time, and the profiler shows the card's share of it. Returns (max abs
    err, launch ms, plain ms, bound ms, bound by, call ms)."""
    import torch
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light import update
    from aic_tpu_torch.math import lightpack

    before = rk.LAUNCHES_LISTED
    got = update.relight_batch_cuda(st, cubes, valid)
    torch.cuda.synchronize()
    if rk.LAUNCHES_LISTED != before + 1:
        fail(f"relight batch {label} {blabel}: {rk.LAUNCHES_LISTED - before} listed launches, not 1")
    want = update.relight_batch_plain(st, cubes, valid)
    a, b = got.cpu().numpy().astype(np.int32), want.cpu().numpy().astype(np.int32)
    v = valid.cpu().numpy()
    step = int(np.abs(a[v, :3] - b[v, :3]).max(initial=0))
    if step > RELIGHT_MAX_STEP or not np.array_equal(a[v, 3], b[v, 3]) or a[~v].any():
        fail(f"relight batch {label} {blabel}: {step} packed steps, statuses equal "
             f"{np.array_equal(a[v, 3], b[v, 3])}, padding rows zero {not a[~v].any()}")
    # The launch alone, on the inputs relight_batch_cuda makes for it.
    args, _org = update.listed_inputs(st, cubes, valid)
    walked = args[6].any(-1)
    first, second = rk.relight_listed_cuda(*args), rk.relight_listed_cuda(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        fail(f"relight batch {label} {blabel}: two launches on the same inputs differ")
    looked_up = rk.decode_table(st.device)[st.light[..., :3].long()]
    if not torch.equal(looked_up.view(torch.int32), lightpack.decode_rgb(st.light).view(torch.int32)):
        fail(f"relight batch {label}: the kernel's decode table differs from decode_rgb")
    ms_launch = launch_ms(lambda: rk.relight_listed_cuda(*args), 50)
    ms_call = cuda_ms(lambda: update.relight_batch_cuda(st, cubes, valid), 20)
    ms_decode = launch_ms(lambda: lightpack.decode_rgb(st.light).contiguous(), 20)
    ms_call_decode = cuda_ms(lambda: (lightpack.decode_rgb(st.light).contiguous(),
                                      update.relight_batch_cuda(st, cubes, valid)), 20)
    ms_plain = cuda_ms(lambda: update.relight_batch_plain(st, cubes, valid), 3)
    work, moved, (max_cube, max_warp), (max_ray, lane_use) = listed_work(st, cubes, valid)
    b_ms, b_by = bound("relight_pass", moved, work)
    earlier = K2_LISTED_EARLIER_MS.get((label, blabel.split(" (")[0]))
    earlier = (f"launch {earlier[0]:.4f} ms, whole call {earlier[1]:.3f} ms (constants, PERF.md)"
               if earlier else "not measured")
    n_rows = cubes.shape[0]
    ray_warps = args[4].lane_ray.numel() // rk.LANES
    err = float(step)
    phase("kernels", f"relight batch {label} {blabel}: {int(valid.sum())} valid of {n_rows} rows, "
          f"{int(walked.sum())} walked; packed diff {step}, statuses equal, padding 0, two launches bit-equal, "
          f"decode table = decode_rgb bit for bit; listed launch {ms_launch:.4f} ms (launch only; "
          f"{n_rows} x {ray_warps} warps in {-(-n_rows * ray_warps // rk.LISTED_BLOCK_WARPS)} blocks of "
          f"{rk.LISTED_BLOCK_WARPS}), whole card call {ms_call:.3f} ms (host-bound), with the volume's light "
          f"decode {ms_call_decode:.3f} ms (the decode's card time {ms_decode:.4f} ms); earlier design: {earlier}; plain "
          f"walk {ms_plain:.3f} ms; bound {b_ms:.5f} ms ({b_by}), {b_ms / ms_launch:.1%} of it; chain: "
          f"max_ray_steps {max_ray} (lane use {lane_use:.1%}) against the earlier design's max_warp_steps "
          f"{max_warp} (one thread per cube: max_cube_steps {max_cube}); work {work}")
    if profile:
        phase("kernels", f"relight batch {label} {blabel}: ten whole card calls under torch.profiler: "
              f"{profiled_frame(lambda: [update.relight_batch_cuda(st, cubes, valid) for _ in range(10)])}")
        phase("kernels", f"relight batch {label} {blabel}: ten calls with the volume's light decode under "
              f"torch.profiler: " + profiled_frame(lambda: [(lightpack.decode_rgb(st.light).contiguous(),
                                                            update.relight_batch_cuda(st, cubes, valid))
                                                           for _ in range(10)]))
    return err, ms_launch, ms_plain, b_ms, b_by, ms_call


def check_device_tick_vs_host(dev) -> None:
    """The same atrium world with a Become cycle, stepped TICK_VS_HOST
    ticks through the device tick and through the per-cube host path on
    the card, from one relit state: contents and cells equal, packed
    light within one step, statuses equal."""
    import torch
    from aic_tpu_torch.content import atrium
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.universe import Universe

    us = []
    lit = None
    for host_path in (False, True):
        u = Universe(device=dev)
        sp = atrium()
        cycle_world(sp)
        u.insert_space("world", sp)
        if lit is None:
            lit, _ = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
        u.states["world"] = lit
        if host_path:
            u._tick_plan = lambda name: None
        ms = [timed_step(u)[0] for _ in range(TICK_VS_HOST)]
        us.append((u, float(np.median(ms))))
    (ud, ms_dev), (uh, ms_host) = us
    a, b = ud.states["world"], uh.states["world"]
    if not (torch.equal(a.contents, b.contents) and torch.equal(a.cells, b.cells)):
        fail("device tick vs host path: contents or cells differ")
    la, lb = a.light.cpu().numpy().astype(np.int32), b.light.cpu().numpy().astype(np.int32)
    step = int(np.abs(la[..., :3] - lb[..., :3]).max())
    if step > RELIGHT_MAX_STEP or not np.array_equal(la[..., 3], lb[..., 3]):
        fail(f"device tick vs host path: light {step} packed steps apart")
    phase("kernels", f"device tick vs host path, atrium, {TICK_VS_HOST} ticks: contents and cells equal, "
          f"packed light diff {step}, statuses equal; median step {ms_dev:.3f} ms (device tick) vs "
          f"{ms_host:.3f} ms (host path)")


def check_frame(frame, state, label):
    if frame.flaws:
        fail(f"{label}: render flaws {frame.flaws}")
    img = frame.data
    if img.shape != (1080, 1920, 4):
        fail(f"{label}: image shape {img.shape}")
    if not (state.light.cpu().numpy()[..., 3] == 255).any():
        fail(f"{label}: relight left no visible light")
    if img[..., :3].reshape(-1, 3).std(0).max() == 0:
        fail(f"{label}: the image is constant")
    coverage = float((img[..., 3] > 0).mean())
    if coverage <= 0.5:
        fail(f"{label}: alpha coverage {coverage:.3f} <= 0.5")
    return coverage


# -- demo-city ----------------------------------------------------------------

#: Demo-city's step as bench.py's `step_demo_city_ms` steps it
#: (bench.py:217-238): 35 ticks of warm-up, then 60 timed; each step here
#: is synchronized and timed alone.
CITY_WARMUP = 35
CITY_TICKS = 60


class timed_calls:
    """Within the block, the host-clock seconds spent in `owner.name`
    (a function or method), synchronized at its end where CUDA is up; the
    list holds one entry a call."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        import torch

        real = self.real = getattr(self.owner, self.name)
        calls = self.calls

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)
        return calls

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)
        return False


def city_world(dev, opts, reset_counts, read_counts) -> dict:
    """Demo-city (`aic_tpu`'s showcase world, 96x28x96 with its exhibits)
    through the port's entry points: `build_universe("demo-city")` on the
    card (the host content build and the snapshot timed apart; every text
    mask composed from the vendored glyph table); K2 (full and light-only) held against
    the plain pass and K1 against its twin on the 1920x1080 rays of
    `main.default_camera`, every field, on the built state (its R32 octant
    rows and wide classify pages); then, with the launch counters set to 0,
    the main path: `evaluate_light` (the fall-back to w = 1 recorded, not
    an error), a 1920x1080 frame, CITY_WARMUP + CITY_TICKS steps timed one
    by one (palette-growing steps apart), and a frame of the stepped world;
    the counters read. Then the busiest timed batch against the plain
    walk, the stepped frame against a fresh snapshot's, the phases' spans,
    CITY_TICKS more steps with each listed K2 launch timed
    (`listed_launches_over`) and a palette-growing commit timed apart."""
    import dataclasses

    import torch
    from aic_tpu_torch import block
    from aic_tpu_torch import universe as U
    from aic_tpu_torch.content import TemplateParameters, build_universe
    from aic_tpu_torch.content import exhibits
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import render
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.space import Space
    from aic_tpu_torch.text import font

    font.rasterize_text.cache_clear()
    with timed_calls(Space, "snapshot") as snaps, timed_calls(font, "compose") as composed, \
            timed_calls(exhibits, "place_exhibit") as placed:
        t0 = time.perf_counter()
        u = build_universe("demo-city", TemplateParameters(seed=0, size=96), device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    sp, st = u.spaces["world"], u.states["world"]
    if tuple(st.contents.shape) != (96, 28, 96):
        fail(f"demo-city: contents {tuple(st.contents.shape)}, not 96x28x96")
    if not composed:
        fail("demo-city: no string was composed from the glyph table: its signs have no text")
    if not tk.megakernel_fits(st):
        fail("demo-city: its megakernel tables do not fit: it would not take K1")
    ctx = tk.get_bitmask_ctx2(st)
    if not (ctx.has_r32 and ctx.wide_pages):
        fail(f"demo-city: has_r32 {ctx.has_r32}, wide pages {ctx.wide_pages}: not K1's R32 / wide branches")
    phase("city", f"demo-city {tuple(st.contents.shape)}: build_universe {build_s:.3f} s (host content "
          f"{build_s - sum(snaps):.3f} s, snapshot {sum(snaps):.3f} s); palette {sp.palette_len()}, "
          f"{int((st.tables.voxel_index >= 0).sum())} voxel-block entries, {len(placed)} exhibits placed; "
          f"K1 tables rows {tuple(ctx.rows.shape)} pages {tuple(ctx.pages.shape)} (wide) page_idx "
          f"{tuple(ctx.page_idx.shape)}, R32 octant rows; text masks: {len(composed)} strings composed glyph "
          f"by glyph from the vendored table in {sum(composed) * 1e3:.1f} ms")

    relight = compare_relight(st, "demo-city")
    cam = default_camera(sp, 1920, 1080, opts)
    o, d = cam.pixel_rays(device=dev)
    trace = compare_trace(st, o, d, "demo-city 1920x1080")
    del o, d

    # The main path, counted.
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", dense.OverrelaxFellBack)
        t0 = time.perf_counter()
        lit, n = evaluate_light(st, batch_size=1024, max_rounds=5000)
        torch.cuda.synchronize()
        relight_s = time.perf_counter() - t0
    fell = [str(w.message) for w in caught if issubclass(w.category, dense.OverrelaxFellBack)]
    for w in caught:
        if not issubclass(w.category, dense.OverrelaxFellBack):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    u.states["world"] = lit
    t0 = time.perf_counter()
    frame = render(lit, cam)
    frame_ms = (time.perf_counter() - t0) * 1e3
    coverage = check_frame(frame, lit, "demo-city")

    def city_step():
        pal = sp.palette_len()
        ms, info = timed_step(u)
        return ms, info, sp.palette_len() - pal

    steps = [city_step() for _ in range(CITY_WARMUP)]
    with walked_rows() as batches:
        timed = [city_step() for _ in range(CITY_TICKS)]
    steps += timed
    k1_before = tk.LAUNCHES
    t0 = time.perf_counter()
    stepped = render(u.states["world"], cam)
    stepped_ms = (time.perf_counter() - t0) * 1e3
    k1_stepped = tk.LAUNCHES - k1_before
    counts = read_counts()

    for name in ("relight_pass", "relight_pass_dyn", "relight_batch", "trace_megakernel"):
        if counts[name] <= 0:
            fail(f"demo-city main path: {name} was not launched: {counts}")
    if k1_stepped <= 0:
        fail(f"demo-city: the stepped frame launched no K1: {counts}")
    if counts["trace_v1"] != 0:
        fail(f"demo-city main path went through the v1 kernel: {counts}")
    grew = [(i + 1, round(ms, 3), g) for i, (ms, _, g) in enumerate(steps) if g]
    ms_t = [ms for ms, _, g in timed if not g]
    ms_all = [ms for ms, _, _ in timed]
    infos = [i for _, i, _ in timed]
    walked = [int(w) for w, _ in batches]
    busiest = batches[int(np.argmax(walked))][1] if batches else None
    del batches
    st2 = u.states["world"]
    check_frame(stepped, st2, "demo-city stepped")
    if not np.array_equal(sp.contents.astype(np.int32), st2.contents.cpu().numpy()):
        fail("demo-city: the host Space's contents differ from the device contents after the steps")
    fresh = dataclasses.replace(sp.snapshot(device=dev), light=st2.light)
    if not torch.equal(fresh.cells, st2.cells):
        fail("demo-city: the stepped cells differ from a fresh snapshot's")
    ref = render(fresh, cam)
    far = (np.abs(stepped.data.astype(np.int32) - ref.data.astype(np.int32)) > 1).any(-1)
    if far.sum() > PIXEL_MAX_SHARE * far.size:
        fail(f"demo-city: {int(far.sum())} pixels of the stepped frame differ from a fresh snapshot's")

    k1 = k1_frame_summary(check_k1_launches(k1_frame_launches(lambda: render(lit, cam)), "demo-city"),
                          "demo-city")
    k1_frame_summary(check_k1_launches(k1_frame_launches(lambda: render(st2, cam)), "demo-city stepped"),
                     "demo-city stepped")
    check_listed_frame(lit, *cam.pixel_rays(device=dev), cam.options, "demo-city 1920x1080", megakernel=True)

    u.profiler.reset()
    u.profiler.sync = torch.cuda.synchronize
    for _ in range(12):
        u.step()
    u.profiler.sync = None
    spans = {k: round(v.total_s * 1e3 / v.calls, 3) for k, v in u.profiler.spans.items()}
    profiled = profiled_frame(lambda: [u.step() for _ in range(6)])
    tick_launches = listed_launches_over(lambda: [u.step() for _ in range(CITY_TICKS)])

    grow = U.UniverseTransaction(spaces={"world": U.SpaceTransaction.set_cube(
        free_cubes(sp, 1)[0], new=block.from_color((0.3, 0.6, 0.9, 1.0), "grown"))})
    pal = sp.palette_len()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grow.execute(u)
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    if sp.palette_len() != pal + 1:
        fail("demo-city: the palette-growing commit did not grow the palette")

    per_tick = counts["relight_batch"] / (CITY_WARMUP + CITY_TICKS)
    phase("city", f"demo-city main path: evaluate_light {n // st.light_dirty.numel()} passes "
          f"({n} cube updates) in {relight_s:.3f} s, fall-back to w = 1: {fell[0] if fell else 'none'}; "
          f"first 1920x1080 frame {frame_ms:.1f} ms, alpha coverage {coverage:.3f}; "
          f"{CITY_WARMUP} warm-up steps: first {steps[0][0]:.1f} ms, median "
          f"{float(np.median([m for m, _, _ in steps[:CITY_WARMUP]])):.3f} ms; {len(ms_all)} timed steps "
          f"(synchronized, host clock): median {float(np.median(ms_all)):.3f} ms, mean {float(np.mean(ms_all)):.3f}, "
          f"max {max(ms_all):.3f}, min {min(ms_all):.3f}; without palette growth: median "
          f"{float(np.median(ms_t)):.3f} ms over {len(ms_t)}; steps that grew the palette (tick, ms, entries): "
          f"{grew}; {sum(1 for i in infos if i._device_stats)} device-ticked; light updates "
          f"{sum(i.light_updates for i in infos)}, queue after {infos[-1].light_queue}; K2 listed launches a "
          f"tick {per_tick:.2f}; rows K2 walked per listed launch: mean "
          f"{float(np.mean(walked)) if walked else 0:.2f} of {u.light_batch_size}, max {max(walked, default=0)}, "
          f"{sum(w == 0 for w in walked)} of {len(walked)} walked none; stepped frame {stepped_ms:.1f} ms "
          f"({k1_stepped} K1 launches), equal to "
          f"a fresh snapshot's ({int(far.sum())} pixels over 1); launches {counts}")
    phase("city", f"demo-city phases (ms a tick, synchronized spans, 12 ticks) {spans}; 6 ticks under "
          f"torch.profiler: {profiled}; palette-growing commit (resnapshot) {grow_ms:.1f} ms")
    if per_tick <= 0:
        fail("demo-city: no K2 listed launch on the ticks")
    if busiest is None or max(walked) == 0:
        fail("demo-city: no listed K2 launch of the timed ticks walked a row")
    batch = check_batch(*busiest, "demo-city", f"busiest step round ({max(walked)} walked)", profile=True)
    phase("city", f"demo-city: K2 listed over {CITY_TICKS} steps after the timed ones: {tick_launches}; the "
          f"busiest batch of the timed steps {batch[1]:.4f} ms launch only")
    return dict(counts=counts, relight=relight, trace=trace, k1=k1, batch=batch)


# -- the render API and the general tracer -------------------------------------

#: plaza sizes of the render phase: 1280 is 13.1 M cubes and 6,400 16³
#: regions (over the kernels' 4,096, under the window volume: the general
#: tracer traces it whole); 1536 is 18.9 M cubes (over the window volume:
#: `render` cuts it to the view, and a kernel traces the window).
PLAZA_GENERAL = 1280
PLAZA_WINDOWED = 1536
#: The windowed frame against the whole state's frame over the near view
#: (tests/test_window.py:44-67): the central crop's median difference 0,
#: at most 6% of its pixels more than 8 apart in a channel.
WINDOW_FAR = 8
WINDOW_MAX_SHARE = 0.06
#: A general-tracer frame slower than this is also traced at half size.
GENERAL_SLOW_S = 60.0
#: The render phase's frame size.
RENDER_W, RENDER_H = 1920, 1080


def synced(fn):
    """(fn(), host-clock seconds between two synchronizations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced_by(fn, want: str, label: str):
    """fn() and its host-clock seconds, synchronized; fails unless it
    traced exactly one frame, through `want` (`render.TRACES`)."""
    import importlib

    R = importlib.import_module("aic_tpu_torch.raytrace.render")
    before = dict(R.TRACES)
    out, s = synced(fn)
    ran = {k: R.TRACES[k] - before[k] for k in before if R.TRACES[k] != before[k]}
    if ran != {want: 1}:
        fail(f"render {label}: traced by {ran}, not once by {want}")
    return out, s


def relit(space, dev, label):
    """Snapshot on the card and `evaluate_light_dense` (K2): (state,
    passes, seconds); a fall-back to w = 1 is printed, not an error."""
    import torch
    from aic_tpu_torch.light import dense

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", dense.OverrelaxFellBack)
        t0 = time.perf_counter()
        state, passes = dense.evaluate_light_dense(space.snapshot(device=dev))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    for w in caught:
        if not issubclass(w.category, dense.OverrelaxFellBack):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    if any(issubclass(w.category, dense.OverrelaxFellBack) for w in caught):
        phase("render", f"{label}: the over-relaxed relight fell back to plain Jacobi")
    return state, passes, secs


def check_image(img, shape, label, alpha_min=0.5):
    if img.shape != shape:
        fail(f"render {label}: image shape {img.shape}, not {shape}")
    if img[..., :3].reshape(-1, 3).std(0).max() == 0:
        fail(f"render {label}: the image is constant")
    coverage = float((img[..., 3] > 0).mean())
    if coverage < alpha_min:
        fail(f"render {label}: alpha coverage {coverage:.3f} < {alpha_min}")


def render_world(dev, opts, smi, reset_counts, read_counts) -> dict:
    """The render API and the general tracer on five scenes, with the
    launch counters set to 0 before and read after: the atrium at
    1920x1080 (the general tracer against K1's frame on the same rays;
    pixel cost, depth, a half-scale render, a bounce frame and
    `RtRenderer.draw` with a UI space, a cursor and info text), the
    "Smallest" exhibit (R128, past both kernels), plaza(1280) (past the
    kernels' 4,096 regions) and plaza(1536) (windowed to the view, then a
    kernel; held against the whole state's general-tracer frame). Every
    render asserts the tracer that `render.pick_tracer` names."""
    import importlib

    import torch
    from aic_tpu_torch.content import atrium, plaza
    from aic_tpu_torch.content.exhibits import smallest_exhibit
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import Camera, Viewport, trace_rays
    from aic_tpu_torch.raytrace import renderer as RR
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1
    from aic_tpu_torch import block
    from aic_tpu_torch.math.grid import GridAab
    from aic_tpu_torch.space import Sky, Space, SpacePhysics
    from aic_tpu_torch.universe import Universe
    from aic_tpu_torch.universe.cursor import cursor_raycast

    R = importlib.import_module("aic_tpu_torch.raytrace.render")
    full = (RENDER_H, RENDER_W, 4)
    reset_counts()

    # The atrium: the general tracer against K1 on the same rays.
    atrium_space = atrium()
    st, passes, relight_s = relit(atrium_space, dev, "atrium")
    cam = default_camera(atrium_space, RENDER_W, RENDER_H, opts)
    o, d = cam.pixel_rays(device=dev)
    (lg, tg, stats), gen_first = synced(lambda: trace_rays(st, o, d, cam.options, return_stats=True))
    (lg, tg, stats), gen_s = synced(lambda: trace_rays(st, o, d, cam.options, return_stats=True))
    (lk, tkk, unfinished), k1_s = synced(lambda: tk.trace_rays_kernel(st, o, d, cam.options, megakernel=True))
    if bool(stats["unfinished"]) or unfinished:
        fail(f"render atrium: unfinished rays (general {bool(stats['unfinished'])}, K1 {unfinished})")
    n = lg.shape[0] * lg.shape[1]
    far = ((lg - lk).abs().amax(-1) > PIXEL_ATOL) | ((tg - tkk).abs() > PIXEL_ATOL)
    n_far = int(far.sum())
    if n_far > PIXEL_MAX_SHARE * n:
        fail(f"render atrium: general tracer vs K1: {n_far} of {n} pixels differ by more than {PIXEL_ATOL}")
    phase("render", f"atrium {RENDER_W}x{RENDER_H} ({smi}): general tracer {gen_s * 1e3:.1f} ms (first {gen_first * 1e3:.1f}), "
          f"iterations per phase {stats['iters'].tolist()}, walkers {stats['walkers'].tolist()}; K1's frame "
          f"{k1_s * 1e3:.1f} ms; {n_far} of {n} pixels over {PIXEL_ATOL} (limit {int(PIXEL_MAX_SHARE * n)}), "
          f"max abs diff {float((lg - lk).abs().max()):.3e}")
    del lg, tg, lk, tkk

    frame, frame_s = traced_by(lambda: R.render(st, cam), "megakernel", "atrium")
    check_image(frame.data, full, "atrium")
    cost_opts = dataclasses.replace(cam.options, debug_pixel_cost=True)
    cost_cam = Camera(cost_opts, Viewport(RENDER_W, RENDER_H), eye_to_world=cam.eye_to_world)
    cost, cost_s = synced(lambda: R.render(st, cost_cam))
    if cost.data.shape != full or cost.data[..., 0].max() != 255:
        fail(f"render atrium pixel cost: shape {cost.data.shape}, red max {cost.data[..., 0].max()}")
    depth, depth_s = synced(lambda: R.render_depth(st, cam))
    hit_share = float(torch.isfinite(depth).float().mean())
    if depth.shape != full[:2] or hit_share < 0.5 or bool((depth[torch.isfinite(depth)] <= 0).any()):
        fail(f"render atrium depth: shape {tuple(depth.shape)}, hit share {hit_share:.3f}")
    scaled, scaled_s = traced_by(lambda: R.render_scaled(st, cam, 0.5), "megakernel", "atrium scaled 0.5")
    check_image(scaled.data, full, "atrium scaled 0.5")
    if scaled.flaws:
        fail(f"render atrium scaled 0.5: flaws {scaled.flaws}")
    bounce_opts = dataclasses.replace(cam.options, lighting_display="bounce")
    bounce_cam = Camera(bounce_opts, Viewport(RENDER_W, RENDER_H), eye_to_world=cam.eye_to_world)
    bounce, bounce_s = traced_by(lambda: R.render(st, bounce_cam), "bounce", "atrium bounce")
    check_image(bounce.data, full, "atrium bounce")
    phase("render", f"atrium {RENDER_W}x{RENDER_H} ({smi}): render (K1) {frame_s * 1e3:.1f} ms; pixel cost (general) "
          f"{cost_s * 1e3:.1f} ms; depth (general) {depth_s * 1e3:.1f} ms, {hit_share:.3f} of pixels hit; "
          f"render_scaled(0.5) (K1 at {RENDER_W // 2}x{RENDER_H // 2}) {scaled_s * 1e3:.1f} ms; bounce ({bounce_opts.bounce_samples} "
          f"samples, general) {bounce_s * 1e3:.1f} ms")

    # RtRenderer: a small UI space in front, the atrium's player, a cursor.
    ui = Space(GridAab.from_lower_size((-3, -3, -4), (2, 1, 1)),
               physics=SpacePhysics(sky=Sky.uniform((1.0, 1.0, 0.5)), light_enabled=False))
    ui.set((-3, -3, -4), block.from_color((0.0, 1.0, 0.0, 1.0)))
    ui.set((-2, -3, -4), block.from_color((1.0, 0.0, 0.0, 0.5)))
    u = Universe(device=dev)
    eye = cam.eye_to_world[:3, 3]
    atrium_space.spawn_eye_position = tuple(eye)
    atrium_space.spawn_look_direction = tuple(-cam.eye_to_world[:3, 2])
    u.insert_space("world", atrium_space)
    u.states["world"] = st
    u.insert_character("player", "world", tuple(eye))
    cams = RR.StandardCameras(cam.options, Viewport(RENDER_W, RENDER_H), RR.CharacterSource(u, "player"),
                              RR.UiViewState(state=ui.snapshot(device=dev), graphics_options=cam.options))
    renderer = RR.RtRenderer(cams)
    origin, direction = cams.cameras().world.project_ndc_into_world(np.zeros(2))
    cursor = cursor_raycast(atrium_space, origin, direction, 1e4)
    if cursor is None:
        fail("render RtRenderer: no cursor at the centre of the atrium's view")
    renderer.update(cursor=cursor)
    before = dict(R.TRACES)
    drawn, draw_s = synced(lambda: renderer.draw("aic_tpu_torch\nrender phase"))
    ran = {k: R.TRACES[k] - before[k] for k in before if R.TRACES[k] != before[k]}
    if ran != {"megakernel": 2}:  # the UI layer and the world
        fail(f"render RtRenderer: traced by {ran}")
    check_image(drawn.data, full, "RtRenderer", alpha_min=1.0)
    white = int((drawn.data[..., :3] == 255).all(-1).sum())
    if drawn.flaws or white == 0:
        fail(f"render RtRenderer: flaws {drawn.flaws}, {white} white text pixels")
    phase("render", f"RtRenderer.draw {RENDER_W}x{RENDER_H} ({smi}): UI layer + atrium + NO_WORLD fill + cursor at "
          f"{cursor.cube} + info text: {draw_s * 1e3:.1f} ms, traced by {ran}")
    del st, depth, renderer, u

    # "Smallest" (R128): past both kernels, through the general tracer.
    sp = smallest_exhibit()
    st, _, _ = relit(sp, dev, "smallest")
    if tk.megakernel_fits(st) or v1.v1_fits(st) or st.tables.padded_voxel_resolution != 128:
        fail(f"render smallest: voxel resolution {st.tables.padded_voxel_resolution}: a kernel would hold it")
    scam = Camera(opts, Viewport(RENDER_W, RENDER_H))
    scam.look_at((0.504, 0.04, 0.55), (0.5039, 0.0039, 0.5039))  # the eye inside the R128 block's cube
    frame, s_first = traced_by(lambda: R.render(st, scam), "general", "smallest")
    frame, s_warm = traced_by(lambda: R.render(st, scam), "general", "smallest")
    hits = int(torch.isfinite(R.render_depth(st, scam)).sum())
    if frame.data.shape != full or frame.flaws or hits == 0:
        fail(f"render smallest: shape {frame.data.shape}, flaws {frame.flaws}, {hits} pixels hit")
    phase("render", f"smallest (R128, {tuple(st.contents.shape)}) {RENDER_W}x{RENDER_H} ({smi}): general tracer "
          f"{s_warm * 1e3:.1f} ms (first {s_first * 1e3:.1f}); {hits} pixels hit the 1/128 voxel")
    del st

    # plaza(1280): 6,400 regions, under the window volume.
    sp = plaza(PLAZA_GENERAL)
    st, passes, relight_s = relit(sp, dev, f"plaza{PLAZA_GENERAL}")
    n_cubes = st.contents.numel()
    if tk.region_count(st) <= tk.MAX_REGIONS or n_cubes > R.AUTO_WINDOW_VOLUME:
        fail(f"render plaza{PLAZA_GENERAL}: {tk.region_count(st)} regions, {n_cubes} cubes")
    pcam = default_camera(sp, RENDER_W, RENDER_H, opts)
    frame, s_first = traced_by(lambda: R.render(st, pcam), "general", f"plaza{PLAZA_GENERAL}")
    check_image(frame.data, full, f"plaza{PLAZA_GENERAL}")
    (light, trans, stats), s_warm = traced_by(lambda: R.render_hdr(st, pcam, with_stats=True), "general",
                                              f"plaza{PLAZA_GENERAL} stats")
    if bool(stats["unfinished"]) or frame.flaws:
        fail(f"render plaza{PLAZA_GENERAL}: unfinished rays, flaws {frame.flaws}")
    slow = ""
    if max(s_first, s_warm) > GENERAL_SLOW_S:
        hcam = default_camera(sp, RENDER_W // 2, RENDER_H // 2, opts)
        _, s_half = traced_by(lambda: R.render(st, hcam), "general", f"plaza{PLAZA_GENERAL} 960x540")
        slow = f"; over {GENERAL_SLOW_S:g} s, so also at {RENDER_W // 2}x{RENDER_H // 2}: {s_half * 1e3:.1f} ms"
    phase("render", f"plaza{PLAZA_GENERAL} {tuple(st.contents.shape)} ({n_cubes} cubes, {tk.region_count(st)} "
          f"regions) {RENDER_W}x{RENDER_H} ({smi}): relit in {passes} passes {relight_s:.3f} s; render (general) "
          f"{s_first * 1e3:.1f} ms, render_hdr {s_warm * 1e3:.1f} ms; iterations per phase "
          f"{stats['iters'].tolist()}, walkers {stats['walkers'].tolist()}{slow}")
    general = dict(ms=s_first * 1e3, hdr_ms=s_warm * 1e3, iters=stats["iters"].tolist())
    del st, light, trans

    # plaza(1536): over the window volume; windowed, then a kernel.
    sp = plaza(PLAZA_WINDOWED)
    st, passes, relight_s = relit(sp, dev, f"plaza{PLAZA_WINDOWED}")
    n_cubes = st.contents.numel()
    if n_cubes <= R.AUTO_WINDOW_VOLUME:
        fail(f"render plaza{PLAZA_WINDOWED}: {n_cubes} cubes, not over the window volume")
    wcam = default_camera(sp, RENDER_W, RENDER_H, opts)
    win, win_s = synced(lambda: R.view_window(st, wcam))
    tracer, pick_s = synced(lambda: R.pick_tracer(win))
    if tracer not in ("megakernel", "v1") or win.contents.numel() >= n_cubes:
        fail(f"render plaza{PLAZA_WINDOWED}: window {tuple(win.contents.shape)} takes {tracer}")
    frame, frame_s = traced_by(lambda: R.render(st, wcam), tracer, f"plaza{PLAZA_WINDOWED}")
    check_image(frame.data, full, f"plaza{PLAZA_WINDOWED}")
    (lw, tw), whole_s = traced_by(lambda: R.render_hdr(st, wcam), "general", f"plaza{PLAZA_WINDOWED} whole")
    whole = R.finish_frame(lw, tw, float(wcam.exposure), wcam.options).cpu().numpy()
    crop = (slice(RENDER_H // 6, RENDER_H * 5 // 6), slice(RENDER_W // 8, RENDER_W * 7 // 8))
    diff = np.abs(whole[crop].astype(int) - frame.data[crop].astype(int))
    median, share = float(np.median(diff)), float((diff > WINDOW_FAR).mean())
    if median != 0 or share > WINDOW_MAX_SHARE:
        fail(f"render plaza{PLAZA_WINDOWED}: windowed vs whole frame: median {median}, {share:.4f} over {WINDOW_FAR}")
    phase("render", f"plaza{PLAZA_WINDOWED} {tuple(st.contents.shape)} ({n_cubes} cubes) {RENDER_W}x{RENDER_H} ({smi}): "
          f"relit in {passes} passes {relight_s:.3f} s; window {tuple(win.contents.shape)} lower {win.lower} "
          f"built in {win_s * 1e3:.1f} ms, its {tracer} tables in {pick_s * 1e3:.1f} ms; render (window + "
          f"tables + {tracer}) {frame_s * 1e3:.1f} ms; the whole state through the general tracer "
          f"{whole_s * 1e3:.1f} ms; central crop: median diff {median:g}, {share:.4f} of channels over "
          f"{WINDOW_FAR} (limit {WINDOW_MAX_SHARE})")
    del st, win, lw, tw
    counts = read_counts()
    for name in ("relight_pass", "trace_megakernel"):
        if counts[name] <= 0:
            fail(f"render phase: {name} was not launched: {counts}")
    phase("render", f"launches {counts}")
    return dict(counts=counts, general=general)


# -- the interactive session: demo-city with its HUD, served ------------------

#: The session phase: demo-city as bench.py's interactive loop plays it
#: (bench.py:248-289: 35 warm-up steps, 10 frames), its viewport, and the
#: WebSocket inputs timed to their frame (bench.py:294-366).
SESSION_W, SESSION_H = 1920, 1080
SESSION_WARMUP = 35
SESSION_FRAMES = 10
WS_INPUTS = 8


def _ws_client_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """A masked client frame (RFC 6455 §5.3), payload < 126 bytes."""
    key = b"\x01\x02\x03\x04"
    return bytes([0x80 | opcode, 0x80 | len(payload)]) + key + bytes(b ^ key[i & 3] for i, b in enumerate(payload))


def _ws_read_frame(f):
    import struct

    head = f.read(2)
    if len(head) < 2:
        fail("session server: the WebSocket closed")
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", f.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", f.read(8))[0]
    return head[0] & 0x0F, f.read(n)


def _ws_handshake(port: int):
    import socket

    from aic_tpu_torch.apps.server import ws_accept_key

    key = "dGhlIHNhbXBsZSBub25jZQ=="
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    sock.sendall(b"GET /ws HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                 b"Sec-WebSocket-Key: " + key.encode() + b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
    f = sock.makefile("rb")
    if b"101" not in f.readline():
        fail("session server: no 101 Switching Protocols")
    headers = {}
    while True:
        line = f.readline().strip()
        if not line:
            break
        k, _, v = line.partition(b":")
        headers[k.decode().lower()] = v.strip().decode()
    if headers.get("sec-websocket-accept") != ws_accept_key(key):
        fail(f"session server: bad Sec-WebSocket-Accept {headers}")
    return sock, f


def _pixel_of(cam, point) -> tuple[int, int]:
    """The pixel whose centre a world point projects to."""
    import numpy as np

    clip = np.linalg.inv(cam.inverse_projection_view) @ np.append(np.asarray(point, np.float64), 1.0)
    ndc = clip[:2] / clip[3]
    vp = cam.viewport
    return int((ndc[0] + 1.0) / 2.0 * vp.width), int((1.0 - ndc[1]) / 2.0 * vp.height)


#: Seeds of the text the session phase makes at run time.
RUNTIME_TEXT_SEED = 14
LATIN1 = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))]


def _text_voxels(space, cubes) -> int:
    """Opaque voxels of the text blocks at `cubes` of a UI space."""
    n = 0
    for cube in cubes:
        ev = space.evaluated_block_at(cube)
        if ev.attributes.display_name.startswith("text["):
            n += int((np.asarray(ev.voxels.color)[..., 3] > 0).sum())
    return n


def runtime_text(session, full) -> str:
    """Text made at run time, composed from the vendored glyph table with
    no PIL: a notification titled "Saved <seeded random name>.json" in the
    HUD, then `show_message` with a seeded three-line Latin-1 message, each
    in one 1920x1080 `render_with_ui` frame (synchronized, host clock).
    Fails if the notification's row or the message page holds no text
    voxel. Dismisses both after."""
    import torch
    from aic_tpu_torch.text import font

    rng = np.random.default_rng(RUNTIME_TEXT_SEED)
    name = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789-_"), 12)) + ".json"
    message = "\n".join("".join(rng.choice(LATIN1, int(rng.integers(12, 28)))) for _ in range(3))
    with timed_calls(font, "compose") as composed:
        note = session.show_notification(f"Saved {name}")
        session.refresh_ui()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        noted = session.render_with_ui()
        torch.cuda.synchronize()
        note_ms = (time.perf_counter() - t0) * 1e3
        sp = session.ui_space
        lo, size = sp.bounds.lower, sp.bounds.size
        row = [(lo[0] + x, lo[1] + size[1] - 2, lo[2]) for x in range(size[0])]
        note_voxels = _text_voxels(sp, row)
        session.show_message(message)
        page = session.pages.current()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shown = session.render_with_ui()
        torch.cuda.synchronize()
        message_ms = (time.perf_counter() - t0) * 1e3
        psp = page.space
        plo, psize = psp.bounds.lower, psp.bounds.size
        message_voxels = _text_voxels(psp, [(plo[0] + x, plo[1] + y, plo[2] + z) for x in range(psize[0])
                                            for y in range(psize[1]) for z in range(psize[2])])
    if note_voxels <= 0:
        fail(f"session: the notification 'Saved {name}' drew no text voxel in the HUD's row")
    if page is None or page.id != "message" or message_voxels <= 0:
        fail(f"session: show_message opened {page and page.id} with {message_voxels} text voxels")
    check_image(noted.data, full, "session notification frame")
    check_image(shown.data, full, "session message frame")
    session.back()
    note.dismiss()
    session.refresh_ui()
    if session.pages.current() is not None:
        fail("session: back from the message page left a page open")
    return (f"notification {('Saved ' + name)!r}: {note_voxels} text voxels in the HUD's row, its 1920x1080 frame "
            f"{note_ms:.1f} ms; message {message!r}: {message_voxels} text voxels on the page, its frame "
            f"{message_ms:.1f} ms; {len(composed)} strings composed glyph by glyph in {sum(composed) * 1e3:.2f} ms")


def session_world(dev, smi, reset_counts, read_counts) -> dict:
    """The interactive layer's main path: demo-city (seed 0, size 96)
    from `build_universe`, relit by `evaluate_light`, played by a
    `Session` at 1920x1080 with its HUD (`enable_ui`): SESSION_WARMUP
    steps, then SESSION_FRAMES frames of `maybe_step` + `render_with_ui`
    on a clock that advances 1/60 s a frame, each synchronized, with the
    counters set to 0 before the build and read after the frames. The
    frame's stages are the session profiler's synchronized spans; the UI
    layer's snapshots and K1 table builds are counted. Then every K1
    launch of one session frame (both layers) against the twin; the UI
    on the card (a toolbar click, the pause page, a setting, the
    composite against `composite_over` of the layers rendered apart);
    the WebSocket server (`echo_t` round trips, `/info`, `/frame.png`);
    and a save through `FileWhence`, reopened by `main` in `print` and
    `terminal` modes as subprocesses."""
    import importlib
    import json as _json
    import tempfile
    import urllib.request

    import torch
    from aic_tpu_torch.apps.server import SessionServer
    from aic_tpu_torch.apps.session import STEP_DT, Session
    from aic_tpu_torch.content import TemplateParameters, build_universe
    from aic_tpu_torch.io.whence import FileWhence
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.main import space_digest
    from aic_tpu_torch.raytrace import Viewport, decode_png, encode_png
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.space import Space
    from aic_tpu_torch.universe.cursor import cursor_raycast
    from aic_tpu_torch.vui.controller import HudController
    from aic_tpu_torch.vui.hud import composite_over
    from aic_tpu_torch.vui.page import cycle_setting

    R = importlib.import_module("aic_tpu_torch.raytrace.render")
    full = (SESSION_H, SESSION_W, 4)

    # The main path, counted.
    reset_counts()
    t0 = time.perf_counter()
    u = build_universe("demo-city", TemplateParameters(seed=0, size=96), device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", dense.OverrelaxFellBack)
        lit, n = evaluate_light(u.states["world"], batch_size=1024, max_rounds=5000)
        torch.cuda.synchronize()
    for w in caught:
        if not issubclass(w.category, dense.OverrelaxFellBack):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    fell = any(issubclass(w.category, dense.OverrelaxFellBack) for w in caught)
    u.states["world"] = lit
    load_s = time.perf_counter() - t0
    session = Session(u, viewport=Viewport(SESSION_W, SESSION_H))
    session.enable_ui()
    for i in range(SESSION_WARMUP):
        session.maybe_step(i * STEP_DT * 1.0001)
    torch.cuda.synchronize()

    traces_before = dict(R.TRACES)
    hud_commits = []
    real_hud_step = HudController.step

    def hud_step(self, s=None):
        changed = real_hud_step(self, s)
        hud_commits.append(changed)
        return changed

    session.profiler.reset()
    session.profiler.sync = torch.cuda.synchronize
    frames, spans = [], []
    HudController.step = hud_step
    try:
        with timed_calls(Space, "snapshot") as snaps, timed_calls(tk, "build_bitmask_ctx2") as tables:
            for i in range(SESSION_FRAMES):
                session.profiler.reset()
                now = (SESSION_WARMUP + i) * STEP_DT * 1.0001
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session.maybe_step(now)
                frame = session.render_with_ui()
                torch.cuda.synchronize()
                frames.append((time.perf_counter() - t0) * 1e3)
                spans.append({k: v.total_s * 1e3 for k, v in session.profiler.spans.items()})
    finally:
        HudController.step = real_hud_step
    session.profiler.sync = None
    counts = read_counts()
    traced = {k: R.TRACES[k] - traces_before[k] for k in R.TRACES if R.TRACES[k] != traces_before[k]}
    world_tracer = R.pick_tracer(u.states["world"])
    ui_tracer = R.pick_tracer(session.ui_state)
    want = {world_tracer: SESSION_FRAMES}
    want[ui_tracer] = want.get(ui_tracer, 0) + SESSION_FRAMES
    if traced != want:
        fail(f"session: frames traced by {traced}, not {want} (pick_tracer: world {world_tracer}, UI {ui_tracer})")
    for name in ("relight_pass", "relight_pass_dyn", "relight_batch", "trace_megakernel"):
        if counts[name] <= 0:
            fail(f"session main path: {name} was not launched: {counts}")
    check_image(frame.data, full, "session frame")
    stage_ms = {k: round(float(np.median([sp.get(k, 0.0) for sp in spans])), 3)
                for k in ("step", "world", "ui", "composite", "post_process", "to_host")}
    phase("session", f"demo-city {tuple(lit.contents.shape)} on the card "
          f"({smi}): build + evaluate_light {load_s:.3f} s ({n} cube updates, fall-back to w = 1: {fell}); "
          f"{SESSION_WARMUP} warm-up steps; {SESSION_FRAMES} frames of maybe_step + render_with_ui at "
          f"{SESSION_W}x{SESSION_H} (synchronized, host clock): median {float(np.median(frames)):.3f} ms, max "
          f"{max(frames):.3f} ms, all {[round(f, 1) for f in frames]}; stages (median ms, synchronized spans) "
          f"{stage_ms}; traced by {traced} (pick_tracer: world {world_tracer}, UI {ui_tracer}); HUD steps "
          f"{len(hud_commits)}, commits (new UI snapshots) {sum(hud_commits)}, Space.snapshot calls "
          f"{len(snaps)}, K1 table builds {len(tables)} ({sum(tables) * 1e3:.1f} ms); launches {counts}")

    # Every K1 launch of one session frame, both layers, against the twin.
    records = k1_frame_launches(lambda: session.render_with_ui())
    k1 = k1_frame_summary(check_k1_launches(records, "session"), "session")

    # The UI on the card. A toolbar slot's pixel selects the slot.
    tx = session.ui_widgets["tx"]
    slot = 3
    x, y = _pixel_of(session.ui_camera, (tx + slot + 0.5, 0.5, 1.0))
    ndc = np.array([2.0 * (x + 0.5) / SESSION_W - 1.0, 1.0 - 2.0 * (y + 0.5) / SESSION_H])
    cur = cursor_raycast(session.ui_space, *session.ui_camera.project_ndc_into_world(ndc), max_distance=1000.0)
    if cur is None or tuple(cur.cube[:2]) != (tx + slot, 0):
        fail(f"session: pixel ({x}, {y}) does not show toolbar slot {slot}: {cur}")
    before = session.inventory.selected
    if session.click(x, y) != ("slot", slot) or session.inventory.selected != slot or before == slot:
        fail(f"session: a click on toolbar slot {slot} left the selection at {session.inventory.selected}")
    # The composite equals composite_over of the layers rendered apart.
    cam = session.eye_camera()
    wl, wt = R.render_hdr(u.states["world"], cam)
    ul, ut = R.render_hdr(session.ui_state, session.ui_camera, include_sky=False)
    light, trans = composite_over(ul, ut, wl, wt)
    from aic_tpu_torch.math.color import linear_to_srgb8

    apart = torch.cat([linear_to_srgb8(cam.post_process(light)),
                       torch.clamp(torch.round((1.0 - trans) * 255.0), 0, 255).to(torch.uint8)[..., None]],
                      dim=-1).cpu().numpy()
    together = session.render_with_ui().data
    if not np.array_equal(apart, together):
        fail(f"session: the composite differs from composite_over of the layers in "
             f"{int((apart != together).any(-1).sum())} pixels")
    # `p` (the frontends' pause key) opens the pause page, which renders.
    if session.input.command("p") != ("pause", None):
        fail("session: `p` is not bound to pause")
    session.paused = not session.paused
    page = session.pages.current()
    if page is None or page.id != "paused":
        fail(f"session: `p` opened {page and page.id}, not the paused page")
    before = dict(R.TRACES)
    paused = session.render_with_ui()
    page_tracer = R.pick_tracer(page.snapshot())
    if R.TRACES[page_tracer] - before[page_tracer] < 1:
        fail(f"session: the paused page was not traced by {page_tracer}")
    check_image(paused.data, full, "session paused")
    if (paused.data != together).any(-1).mean() < 0.001:
        fail("session: the paused page left the frame as it was")
    # A setting cycled through the settings store reaches the options.
    fog = session.options.fog
    cycle_setting(session.settings, "fog")
    session.apply_settings()
    if session.options.fog == fog:
        fail(f"session: cycling fog left it at {fog}")
    session.back()
    if session.paused or session.pages.current() is not None:
        fail("session: back from the paused page did not resume")
    phase("session", f"UI on the card: a click at ({x}, {y}) selected toolbar slot {slot}; the composite equals "
          f"composite_over of the world and UI layers rendered apart, bit for bit; `p` opened the paused page "
          f"(traced by {page_tracer}, {float((paused.data != together).any(-1).mean()):.3f} of the pixels changed); "
          f"cycle_setting(fog) {fog} -> {session.options.fog}")
    phase("session", f"text made at run time, no PIL ({smi}): {runtime_text(session, full)}")

    # The server: WebSocket inputs carrying `t`, each timed to the frame
    # whose metadata echoes it.
    t0 = time.perf_counter()
    png = encode_png(together)
    png_ms = (time.perf_counter() - t0) * 1e3
    srv = SessionServer(session, port=0, stream_fps=60.0)
    srv.start()
    try:
        sock, f = _ws_handshake(srv.port)
        lat, lat_meta, render_ms, sizes, pushed = [], [], [], [], None
        for i in range(WS_INPUTS):
            t_send = time.perf_counter()
            stamp = int(t_send * 1e6)
            sock.sendall(_ws_client_frame(_json.dumps({"keys": ["w"] if i % 2 else [], "t": stamp}).encode()))
            deadline = time.time() + 60
            matched = False
            while time.time() < deadline:
                opcode, payload = _ws_read_frame(f)
                if opcode == 0x1:
                    meta = _json.loads(payload)
                    matched = meta.get("echo_t") == stamp
                    if matched:
                        lat_meta.append((time.perf_counter() - t_send) * 1e3)
                        render_ms.append(meta["render_ms"])
                elif opcode == 0x2 and matched:
                    lat.append((time.perf_counter() - t_send) * 1e3)
                    sizes.append(len(payload))
                    pushed = payload
                    break
            if not matched:
                fail(f"session server: input {i} was not echoed within 60 s")
        sock.sendall(_ws_client_frame(b"", opcode=0x8))
        sock.close()
        img = decode_png(pushed)
        check_image(img, full, "session pushed PNG")
        base = f"http://127.0.0.1:{srv.port}"
        info = _json.loads(urllib.request.urlopen(base + "/info", timeout=120).read())
        if set(info) != {"info_text", "paused"}:
            fail(f"session server: /info gave {info}")
        polled = decode_png(urllib.request.urlopen(base + "/frame.png", timeout=120).read())
        check_image(polled, full, "session /frame.png")
    finally:
        srv.shutdown()
    phase("session", f"server on the card ({smi}): {WS_INPUTS} WebSocket inputs, input->frame (the PNG after the "
          f"meta echoing the input) median {float(np.median(lat)):.1f} ms, max {max(lat):.1f} ms (to the meta: "
          f"median {float(np.median(lat_meta)):.1f} ms); render_ms (meta) median {float(np.median(render_ms)):.1f}, "
          f"max {max(render_ms):.1f}; PNG encode {png_ms:.1f} ms, {len(png)} bytes; pushed frames "
          f"{int(np.median(sizes))} bytes (median), one decoded: {SESSION_W}x{SESSION_H} RGBA; /info {info}; "
          f"/frame.png decoded")

    # IO and the CLI: the stepped universe saved through a FileWhence and
    # reopened by `main` in `print` and `terminal` (no tty) modes.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo-city.json")
        t0 = time.perf_counter()
        FileWhence(path, device=dev).save(u)
        save_s = time.perf_counter() - t0
        want = space_digest(u.spaces["world"])
        # Both modes at once (two processes on the one card), each waited for.
        t0 = time.perf_counter()
        procs = {mode: subprocess.Popen([sys.executable, "-m", "aic_tpu_torch.main", path, "--graphics", mode],
                                        cwd=HERE, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for mode in ("print", "terminal")}
        cli = []
        for mode, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            if proc.returncode != 0:
                fail(f"main {mode} on the saved universe exited {proc.returncode}: {err[-2000:]}")
            opened = [ln for ln in err.splitlines() if ln.startswith("[open]")]
            if not opened or not opened[0].endswith(want):
                fail(f"main {mode}: the loaded space is not the saved one: {opened} vs {want}")
            if out.count("\n") != 40 or "▀" not in out:
                fail(f"main {mode}: printed {out.count(chr(10))} lines, not a 120x80 frame's 40")
            cli.append(f"{mode} done at {time.perf_counter() - t0:.1f} s")
        size = os.path.getsize(path)
    phase("session", f"saved the stepped demo-city through FileWhence in {save_s:.3f} s ({size} bytes); main "
          f"reopened it and printed a frame, both modes started together ({', '.join(cli)}): world {want}")
    return dict(counts=counts, k1=k1, session=session)


#: The record phase: `main --graphics record` run as a user runs it, one
#: subprocess a command, each printing its launch counters at exit.
COUNTED_MAIN = (
    "import json, runpy, sys\n"
    "sys.argv = ['aic_tpu_torch.main'] + json.loads(sys.argv[1])\n"
    "try:\n"
    "    runpy.run_module('aic_tpu_torch.main', run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    from aic_tpu_torch.light import relight_kernel as rk\n"
    "    from aic_tpu_torch.raytrace import trace_kernel as tk, trace_kernel_v1 as v1\n"
    "    print('LAUNCHES ' + json.dumps({'relight_pass': rk.LAUNCHES, 'relight_pass_dyn': rk.LAUNCHES_DYN,\n"
    "          'relight_batch': rk.LAUNCHES_LISTED, 'trace_megakernel': tk.LAUNCHES, 'trace_v1': v1.LAUNCHES}),\n"
    "          file=sys.stderr)\n"
)
RECORD_W, RECORD_H = 1920, 1080
RECORD_CITY_SIZE = 96
#: Demo-city stepped with a chunked mesh updated every tick.
MESH_TICKS = 60
MESH_BUDGET = 8
APNG_FRAMES = 8
GLTF_FRAMES = 4


def run_main(args: list, label: str) -> tuple[dict, float, str]:
    """`python3 -m aic_tpu_torch.main ARGS` as a subprocess on the card
    (through COUNTED_MAIN): (its launch counters, host-clock seconds,
    stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COUNTED_MAIN, json.dumps(args)], cwd=HERE,
                          stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"record {label}: main exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = [ln for ln in proc.stderr.splitlines() if ln.startswith("LAUNCHES ")]
    if not line:
        fail(f"record {label}: no launch counters in main's output: {proc.stderr[-2000:]}")
    return json.loads(line[-1][len("LAUNCHES "):]), secs, proc.stderr


def _wrote_line(err: str) -> str:
    """main's load relight and output lines."""
    return "; ".join(ln for ln in err.splitlines() if ln.startswith(("wrote", "[light]")))


def png_chunks(data: bytes) -> list:
    """(kind, body) of each chunk of a PNG."""
    import struct

    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        out.append((kind, data[pos + 8 : pos + 8 + n]))
        pos += 12 + n
    return out


def gltf_parts(path):
    """(document, buffer bytes, decoded images) of a glTF with embedded
    data URIs."""
    import base64

    from aic_tpu_torch.raytrace import decode_png

    with open(path) as f:
        doc = json.load(f)
    buffers = [base64.b64decode(b["uri"].split(",", 1)[1]) for b in doc["buffers"]]
    images = [decode_png(base64.b64decode(im["uri"].split(",", 1)[1])) for im in doc.get("images", [])]
    return doc, buffers, images


def record_world(dev, smi, reset_counts, read_counts, session) -> dict:
    """The record and export path (`main --graphics record`) and what it
    stands on, the counters set to 0 before and read after (the
    subprocesses' counters added):

    demo-city (seed 0, size 96) to `.gltf` as a subprocess, the file
    parsed and held to an in-process textured mesh of the same world;
    demo-city stepped MESH_TICKS ticks (a placing behavior every 10)
    with a `ChunkedSpaceMesh` updated every tick (budget MESH_BUDGET),
    the chunks re-meshed a tick and the chunks the device tick's remap
    changed with no journal entry, then every untouched chunk against a
    fresh chunked mesh; the atrium (1920x1080) to `.stl` (its size from
    the voxel-detail mesh), to an APNG of APNG_FRAMES frames along a
    two-keyframe camera script (the first frame against an in-process
    render) and to a glTF of GLTF_FRAMES stepped frames; a
    `SessionAudio` over the session phase's steps and a scripted tool
    use, written as WAV; the C++ reference relight on light_bench and
    cornell-box 32 beside the card's `evaluate_light_dense`."""
    import tempfile

    import torch
    from aic_tpu_torch.apps.audio import SessionAudio, WavFileSink
    from aic_tpu_torch.apps.record_script import CameraScript
    from aic_tpu_torch.apps.session import STEP_DT, body_row
    from aic_tpu_torch.content import TemplateParameters, atrium, build_template_space, cornell_box
    from aic_tpu_torch.content.testing import light_bench_space
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.mesh import ChunkedSpaceMesh, mesh_space_textured, mesh_space_voxel_detail
    from aic_tpu_torch.native import ref_relight_state
    from aic_tpu_torch.raytrace import GraphicsOptions, decode_png, render
    from aic_tpu_torch.universe.cursor import click, cursor_raycast

    reset_counts()
    sub = {}
    city_args = ["--template", "demo-city", "--size", str(RECORD_CITY_SIZE), "--graphics", "record"]
    with tempfile.TemporaryDirectory() as tmp:
        # demo-city to glTF, a subprocess on the card.
        path = os.path.join(tmp, "city.gltf")
        sub["city.gltf"], secs, err = run_main(city_args + ["--output", path], "demo-city gltf")
        size = os.path.getsize(path)
        doc, buffers, images = gltf_parts(path)
        mesh, mesh_s = synced(lambda: mesh_space_textured(build_template_space(
            "demo-city", TemplateParameters(seed=0, size=RECORD_CITY_SIZE))))
        prim = doc["meshes"][0]["primitives"][0]
        acc = doc["accessors"]
        counts_in_file = {k: acc[i]["count"] for k, i in prim["attributes"].items()}
        if set(counts_in_file.values()) != {len(mesh.positions)} or len(counts_in_file) != 3:
            fail(f"record demo-city gltf: attribute counts {counts_in_file}, the mesh has {len(mesh.positions)} "
                 f"vertices")
        if acc[prim["indices"]]["count"] != 3 * mesh.triangle_count:
            fail(f"record demo-city gltf: {acc[prim['indices']]['count']} indices, the mesh has "
                 f"{mesh.triangle_count} triangles")
        if len(images) != 1 or images[0].shape != mesh.texture.shape or not np.array_equal(images[0], mesh.texture):
            fail(f"record demo-city gltf: the atlas decodes to {[im.shape for im in images]}, not the mesh's "
                 f"{mesh.texture.shape}")
        if sum(len(b) for b in buffers) != doc["buffers"][0]["byteLength"]:
            fail("record demo-city gltf: the buffer's length is not the stated one")
        os.remove(path)
        phase("record", f"demo-city size {RECORD_CITY_SIZE} -> city.gltf ({smi}): main as a subprocess {secs:.3f} s "
              f"({_wrote_line(err)!r}), {size} bytes ({size / 2 ** 20:.1f} MiB); {mesh.triangle_count} triangles, "
              f"{len(mesh.positions)} vertices, atlas {mesh.texture.shape[1]}x{mesh.texture.shape[0]} decoded equal "
              f"to an in-process mesh_space_textured ({mesh_s:.3f} s, host); launches {sub['city.gltf']}")

        # demo-city (the session's universe) stepped with a chunked mesh
        # updated every tick, its audio pumped every tick.
        u = session.universe
        sp = u.spaces["world"]
        wav = os.path.join(HERE, "aic_tpu_torch", "_build", "session.wav")
        audio = SessionAudio(session, WavFileSink(wav))
        sounds = audio.pump(0.0)  # the session phase's steps
        u.add_behavior("world", make_placer(free_cubes(sp, 3), PLACE_EVERY))
        journal = []
        real_drain = sp.drain_edits

        def drain():
            out = real_drain()
            journal.append(out)
            return out

        sp.drain_edits = drain
        csm = ChunkedSpaceMesh(sp)
        cs = csm.chunk_size
        before_counts = read_counts()
        view = body_row(u, session.character.body_index)["position"]
        remeshed, remap_chunks, remap_cubes, step_s, update_s, scripted = [], set(), 0, [], [], None
        for i in range(MESH_TICKS):
            before = sp.contents.copy()
            _, s = synced(u.step)
            step_s.append(s)
            if i == MESH_TICKS // 2 and sounds == 0:
                # A scripted tool use: the player removes the block under it.
                session.inventory.selected = 1
                pos = body_row(u, session.character.body_index)["position"]
                cur = cursor_raycast(sp, pos + np.array([0.0, 0.5, 0.0]), np.array([0.0, -1.0, 0.0]))
                scripted = (cur.cube if cur is not None else None, click(u, session.character, cur))
            sounds += audio.pump((i + 1) * STEP_DT)
            changed = np.argwhere(before != sp.contents)
            info, s = synced(lambda: csm.update(view, budget_chunks=MESH_BUDGET))
            update_s.append(s)
            remeshed.append(info.chunks_updated)
            edits = journal[-1]
            if edits != "all":
                unjournaled = [tuple(int(v) for v in c) for c in changed if tuple(int(v) for v in c) not in edits]
                remap_cubes += len(unjournaled)
                for c in unjournaled:
                    remap_chunks |= csm.chunks_of_cube(c)
        sp.drain_edits = real_drain
        stepped_counts = {k: v - before_counts[k] for k, v in read_counts().items()}
        journaled = sum(len(e) if e != "all" else 0 for e in journal[1:])
        while csm.update(view, budget_chunks=MESH_BUDGET).chunks_remaining:
            pass
        fresh = ChunkedSpaceMesh(sp)
        fresh.update(view, budget_chunks=10 ** 6)
        stale = []
        for c, m in fresh.meshes.items():
            same = all(np.array_equal(getattr(m, k), getattr(csm.meshes[c], k))
                       for k in ("positions", "colors", "indices"))
            if c in remap_chunks:
                stale += [] if same else [c]
            elif not same or m.opaque_range != csm.meshes[c].opaque_range:
                fail(f"record demo-city: chunk {c}, untouched by the remap, differs from a fresh chunked mesh")
        phase("record", f"demo-city stepped {MESH_TICKS} ticks with a ChunkedSpaceMesh ({len(fresh.meshes)} chunks "
              f"of {cs}^3) updated each tick, budget {MESH_BUDGET} ({smi}): chunks re-meshed a tick {remeshed} "
              f"(mean {float(np.mean(remeshed)):.2f}); journaled cubes {journaled}; cubes the device tick's remap "
              f"changed with no journal entry {remap_cubes}, in {len(remap_chunks)} chunks (with neighbours), of "
              f"which {len(stale)} differ from a fresh mesh after the full update; every other chunk equals the "
              f"fresh mesh's; step median {float(np.median(step_s)) * 1e3:.3f} ms, chunked update median "
              f"{float(np.median(update_s)) * 1e3:.3f} ms, max {max(update_s) * 1e3:.3f} ms (host); launches "
              f"{stepped_counts}")
        audio.flush()
        pcm = audio.mixer.take()
        peak = float(np.abs(pcm).max()) if len(pcm) else 0.0
        if sounds == 0 or peak <= 0.0:
            fail(f"record audio: {sounds} sounds mixed, PCM peak {peak}")
        phase("record", f"audio ({smi}): a SessionAudio over the session phase's steps and these {MESH_TICKS} (scripted "
              f"tool use, cube and edit: {scripted}): {sounds} sounds mixed, {len(pcm)} stereo samples, PCM peak "
              f"{peak:.4f}; {os.path.getsize(wav)} bytes of WAV")

        # The atrium: STL, an APNG along a camera script, an animated glTF.
        space = atrium()
        atrium_args = ["--template", "atrium", "--graphics", "record", "--width", str(RECORD_W),
                       "--height", str(RECORD_H)]
        path = os.path.join(tmp, "atrium.stl")
        sub["atrium.stl"], secs, err = run_main(atrium_args + ["--output", path], "atrium stl")
        tris, mesh_s = synced(lambda: mesh_space_voxel_detail(space).triangle_count)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(84)
        if size != 84 + 50 * tris or int.from_bytes(head[80:84], "little") != tris:
            fail(f"record atrium stl: {size} bytes, not 84 + 50 * {tris}")
        os.remove(path)
        phase("record", f"atrium -> atrium.stl ({smi}): main as a subprocess {secs:.3f} s ({_wrote_line(err)!r}); "
              f"{size} bytes = 84 + 50 * {tris} voxel-detail triangles (in-process mesh {mesh_s:.3f} s, host); "
              f"deleted; launches {sub['atrium.stl']}")

        lo = np.asarray(space.bounds.lower, float)
        ext = np.asarray(space.bounds.size, float)
        center = lo + ext / 2
        eyes = [lo + ext * np.array([0.5, 0.75, 0.9]), lo + ext * np.array([0.25, 0.55, 0.95])]
        script = {"position": {"times": [0.0, APNG_FRAMES / 30.0], "values": [e.tolist() for e in eyes]},
                  "look_direction": {"times": [0.0, APNG_FRAMES / 30.0],
                                     "values": [(center - e).tolist() for e in eyes]}}
        script_path = os.path.join(tmp, "flight.json")
        with open(script_path, "w") as f:
            json.dump(script, f)
        path = os.path.join(tmp, "atrium.png")
        sub["atrium.png"], secs, err = run_main(atrium_args + ["--frames", str(APNG_FRAMES), "--camera-script",
                                                               script_path, "--output", path], "atrium apng")
        with open(path, "rb") as f:
            data = f.read()
        chunks = png_chunks(data)
        n_fctl = sum(1 for k, _ in chunks if k == b"fcTL")
        if n_fctl != APNG_FRAMES or sum(1 for k, _ in chunks if k == b"fdAT") == 0:
            fail(f"record atrium apng: {n_fctl} fcTL chunks, not {APNG_FRAMES}")
        first = decode_png(data)
        # The first frame: the relit atrium at the script's t = 0 camera.
        state = space.snapshot(device=dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", dense.OverrelaxFellBack)
            state, _ = evaluate_light(state, batch_size=1024, max_rounds=5000)
        for w in caught:
            if not issubclass(w.category, dense.OverrelaxFellBack):
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        cam = default_camera(space, RECORD_W, RECORD_H, GraphicsOptions(lighting_display="smoothstep", fog="none"))
        CameraScript.from_dict(script).camera_at(0.0, cam, eyes[0], center)
        want, frame_s = synced(lambda: render(state, cam).data)
        check_image(first, (RECORD_H, RECORD_W, 4), "record atrium apng frame 0")
        diff = int((first != want).any(-1).sum())
        if diff:
            fail(f"record atrium apng: the first frame differs from an in-process render in {diff} pixels")
        phase("record", f"atrium -> atrium.png, {APNG_FRAMES} frames at {RECORD_W}x{RECORD_H} along a two-keyframe "
              f"script ({smi}): main as a subprocess {secs:.3f} s ({_wrote_line(err)!r}; a frame: trace + step); "
              f"{len(data)} bytes, {n_fctl} fcTL chunks; frame 0 equals an in-process render at the script's t = 0 "
              f"camera ({frame_s * 1e3:.1f} ms); launches {sub['atrium.png']}")
        del state
        os.remove(path)

        path = os.path.join(tmp, "atrium.gltf")
        sub["atrium.gltf"], secs, err = run_main(atrium_args + ["--frames", str(GLTF_FRAMES), "--output", path],
                                                 "atrium animated gltf")
        doc, _, images = gltf_parts(path)
        channels = doc["animations"][0]["channels"]
        frames = [n for n in doc["nodes"] if n.get("name", "").startswith("space.frame")]
        scale = [c for c in channels if c["target"]["path"] == "scale"]
        if len(frames) != GLTF_FRAMES or len(scale) != GLTF_FRAMES or len(images) != GLTF_FRAMES:
            fail(f"record atrium gltf: {len(frames)} frame nodes, {len(scale)} scale channels, {len(images)} "
                 f"atlases, not {GLTF_FRAMES}")
        phase("record", f"atrium -> atrium.gltf, {GLTF_FRAMES} stepped frames ({smi}): main as a subprocess "
              f"{secs:.3f} s ({_wrote_line(err)!r}), {os.path.getsize(path)} bytes; {len(frames)} frame nodes, "
              f"{len(scale)} scale channels; launches {sub['atrium.gltf']}")

    counts = read_counts()
    for k in counts:
        counts[k] += sum(c[k] for c in sub.values())
    for name in ("relight_pass", "relight_pass_dyn", "relight_batch", "trace_megakernel"):
        if counts[name] <= 0:
            fail(f"record main path: {name} was not launched: {counts}")
    phase("record", f"launches (in process and the subprocesses) {counts}")

    # The C++ reference relight on this host's CPU, as bench.py runs it,
    # beside the card's dense relight of the same scenes.
    nproc = os.cpu_count()
    ref = {}
    for name, make in (("light_bench", light_bench_space), ("cornell32", lambda: cornell_box(32))):
        reset_counts()
        st = make().snapshot(device=dev)
        secs, updates = ref_relight_state(st)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", dense.OverrelaxFellBack)
            dense.evaluate_light_dense(st)  # warm
            (lit, passes), card_s = synced(lambda: dense.evaluate_light_dense(st))
        fell = any(issubclass(w.category, dense.OverrelaxFellBack) for w in caught)
        ref[name] = (secs, updates, card_s, passes)
        phase("record", f"reference relight {name} {tuple(st.contents.shape)}: C++ on the host CPU ({nproc} cores, "
              f"OpenMP) {secs:.3f} s, {updates} cube updates; the card's evaluate_light_dense ({smi}) "
              f"{card_s * 1e3:.3f} ms, {passes} passes (fall-back to w = 1: {fell}); launches (both relights) "
              f"{read_counts()}")
    return dict(counts=counts, ref=ref)


#: The reference phase (12): tests/test_ref_relight.py's criteria for
#: the reference-procedure relight against the C++ one.
REF_MAX_STEPS = 4
REF_MEAN_DECODED = 0.01
REF_CHECKED = 10  # cornell-box size held against the C++ relight
REF_TIMED = 32  # cornell-box size timed
REF_HELD_ROUND = 10  # the round whose listed launch is held against the plain walk


class timed_launches:
    """Within the block, CUDA events around every call of
    `owner.name` (K2's listed launch as `light/update.py` calls it): the
    device ms between the event before and the one after each call, read
    after a synchronization."""

    def __init__(self, owner, name):
        self.owner, self.name, self.events = owner, name, []

    def __enter__(self):
        import torch

        real = self.real = getattr(self.owner, self.name)
        events = self.events

        def timed(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real(*args, **kwargs)
            e1.record()
            events.append((e0, e1))
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)
        return False

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]


def reference_world(dev, smi, reset_counts, read_counts) -> dict:
    """The reference-procedure relight (`light/refproc.py`
    `evaluate_light_reference`: the priority-bucket queue the reference's
    goldens are lit by, each bucket relit by one launch of K2's listed
    kernel over 64 rows) and one whole-volume round (`dense.relight_all`,
    K2's full pass), the counters set to 0 before and read after.
    Cornell-box REF_CHECKED on the card against the C++ `ref_relight_state`
    (statuses equal, packed light within REF_MAX_STEPS, mean decoded
    difference under REF_MEAN_DECODED); cornell-box REF_TIMED timed:
    seconds, rounds, listed launches and the share of the run inside them
    (CUDA events around each launch), beside the card's
    `evaluate_light_dense` and the C++ relight of the same world. Then
    round REF_HELD_ROUND's launch against the plain walk on its batch and
    `relight_all`'s pass against the plain pass (within one step,
    statuses equal); those launches are not counted."""
    import torch
    from aic_tpu_torch.content import cornell_box
    from aic_tpu_torch.light import dense, update
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.light.refproc import evaluate_light_reference, fast_evaluate_seed
    from aic_tpu_torch.math import lightpack
    from aic_tpu_torch.native import ref_relight_state

    reset_counts()
    st10 = cornell_box(REF_CHECKED).snapshot(device=dev)
    t0 = time.perf_counter()
    lit = evaluate_light_reference(st10)
    torch.cuda.synchronize()
    card10_s = time.perf_counter() - t0
    got = lit.light.cpu().numpy()
    cpp_s, cpp_updates, want = ref_relight_state(st10, return_light=True)
    if not (got[..., 3] == want[..., 3]).all():
        fail(f"reference cornell-box {REF_CHECKED}: statuses differ from the C++ relight in "
             f"{int((got[..., 3] != want[..., 3]).sum())} cubes")
    vis = want[..., 3] == lightpack.STATUS_VISIBLE
    steps = int(np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))[vis].max())
    table = lightpack.DECODE_TABLE
    mean = float(np.abs(table[got[..., :3]] - table[want[..., :3]])[vis].mean())
    if steps > REF_MAX_STEPS or mean >= REF_MEAN_DECODED:
        fail(f"reference cornell-box {REF_CHECKED}: {steps} packed steps (limit {REF_MAX_STEPS}), mean decoded "
             f"difference {mean:.5f} (limit {REF_MEAN_DECODED}) against the C++ relight")
    phase("reference", f"cornell-box {REF_CHECKED} {tuple(st10.contents.shape)} on the card ({smi}): "
          f"evaluate_light_reference {card10_s:.3f} s; against the C++ ref_relight_state ({cpp_s:.3f} s, "
          f"{cpp_updates} updates): statuses equal, {steps} packed steps at most (limit {REF_MAX_STEPS}), "
          f"mean decoded difference {mean:.5f} (limit {REF_MEAN_DECODED}) over {int(vis.sum())} visible cubes")

    st32 = cornell_box(REF_TIMED).snapshot(device=dev)
    rounds, held = [], []
    real_batch = update.relight_batch

    def counted(state, cubes, valid):
        rounds.append(1)
        if len(rounds) == REF_HELD_ROUND:
            held.append((state, cubes.clone(), valid.clone()))
        return real_batch(state, cubes, valid)

    before = rk.LAUNCHES_LISTED
    update.relight_batch = counted
    try:
        with timed_launches(update, "relight_listed_cuda") as launches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_light_reference(st32)
            torch.cuda.synchronize()
            card32_s = time.perf_counter() - t0
    finally:
        update.relight_batch = real_batch
    n_listed = rk.LAUNCHES_LISTED - before
    launch_ms = launches.ms()
    if n_listed != len(rounds) or n_listed != len(launch_ms):
        fail(f"reference cornell-box {REF_TIMED}: {len(rounds)} rounds but {n_listed} listed launches "
             f"({len(launch_ms)} timed)")
    t0 = time.perf_counter()
    dense_st, passes = dense.evaluate_light_dense(cornell_box(REF_TIMED).snapshot(device=dev))
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    cpp32_s, cpp32_updates = ref_relight_state(st32)
    phase("reference", f"cornell-box {REF_TIMED} {tuple(st32.contents.shape)} on the card ({smi}): "
          f"evaluate_light_reference {card32_s:.3f} s, {len(rounds)} rounds ({card32_s / len(rounds) * 1e3:.3f} ms "
          f"a round), {n_listed} K2 listed launches, {sum(launch_ms):.3f} ms inside them (CUDA events around each "
          f"launch; mean {float(np.mean(launch_ms)):.4f} ms, max {max(launch_ms):.4f} ms): "
          f"{sum(launch_ms) / (card32_s * 1e3):.2%} of the run; the card's evaluate_light_dense "
          f"{dense_s * 1e3:.3f} ms, {passes} passes; the C++ ref_relight_state on the host CPU {cpp32_s:.3f} s, "
          f"{cpp32_updates} updates")

    # One whole-volume round on the seeded world, counted.
    seeded, _ = fast_evaluate_seed(st32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    relit, stats = dense.relight_all(seeded)
    torch.cuda.synchronize()
    all_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    for name in ("relight_batch", "relight_pass"):
        if counts[name] <= 0:
            fail(f"reference main path: {name} was not launched: {counts}")

    # The held round's launch against the plain walk on its batch.
    st_h, cubes, valid = held[0]
    a = update.relight_batch_cuda(st_h, cubes, valid).cpu().numpy().astype(np.int32)
    b = update.relight_batch_plain(st_h, cubes, valid).cpu().numpy().astype(np.int32)
    v = valid.cpu().numpy()
    batch_err = int(np.abs(a[v, :3] - b[v, :3]).max())
    if batch_err > RELIGHT_MAX_STEP or (a[v, 3] != b[v, 3]).any() or a[~v].any():
        fail(f"reference round {REF_HELD_ROUND}: K2 listed differs from the plain walk by {batch_err} steps "
             f"or in a status or a padding row")
    # relight_all's pass against the plain pass.
    ctx = dense.build_relight_ctx(seeded)
    inc, tot = rk.relight_pass_plain(seeded.contents, lightpack.decode_rgb(seeded.light).contiguous(),
                                     seeded.tables.light_face_rows, ctx)
    plain = dense._finish(ctx, inc + ctx.incoming0, tot).cpu().numpy().astype(np.int32)
    got = relit.light.cpu().numpy().astype(np.int32)
    all_err = int(np.abs(got[..., :3] - plain[..., :3]).max())
    if all_err > RELIGHT_MAX_STEP or (got[..., 3] != plain[..., 3]).any():
        fail(f"reference relight_all: K2's pass differs from the plain pass by {all_err} steps or in a status")
    phase("reference", f"relight_all cornell-box {REF_TIMED} {all_ms:.3f} ms (host clock, synchronized; max change "
          f"{int(stats['max_diff'])} steps, {int(stats['queue_remaining'])} cubes marked dirty); round "
          f"{REF_HELD_ROUND}'s K2 listed launch ({int(v.sum())} valid of {len(v)} rows) against the plain walk: "
          f"{batch_err} steps at most, statuses equal; relight_all against the plain pass: {all_err} steps at "
          f"most, statuses equal; launches {counts}")
    return dict(counts=counts)


#: The multi-GPU phase (11). Four ranks share card 0 over the gloo
#: transport, which stages every exchange through host memory (NCCL
#: refuses two ranks on one card): their lines say "gloo (host-staged)",
#: so that none reads as NVLink. Each slab pass's gathered light is held
#: to the one-process K2 pass from the same light bit for bit; the
#: row-sharded frame to the one-process frame bit for bit. The slab frame
#: is held to the one-process frame within tests/test_slab.py's SLAB_ATOL
#: on the rays that end within the trace's budget, but for knife edges
#: (at most PIXEL_MAX_SHARE of them, as the trace paths are held: a slab
#: window's box moves where a ray's walk starts by an ulp): each slab traces
#: with a budget of its own (transparency phases, steps, the 1/256
#: transmittance a ray must keep to resume), so a ray that spends the
#: whole-world trace's (its last phase still hits) goes on further in the
#: slab composite, in `aic_tpu`'s design as in the port's (the same 26 of
#: 4,608 rays differ in both packages on demo-city size 32 on the CPU).
#: Those rays, and the pixels over the tracer tests' LIGHT_ATOL
#: (tests/test_torch_tracer.py), are counted and printed.
GLOO = "gloo (host-staged)"
GLOO_RANKS = 4
MULTI_W, MULTI_H = 1920, 1080
LIGHT_ATOL = 2e-3
SLAB_ATOL = 5e-3
CITY_SLAB_PASSES = 3
SLAB_MAX_PASSES = 64


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


class _OnPath:
    """Adds the kernel launches of the calls it wraps to `counts`: a
    rank's launches on the sharded paths, without the one-process
    passes and frames it is held against."""

    def __init__(self):
        self.counts: dict = {}

    def __call__(self, fn, *args, **kw):
        from aic_tpu_torch.graft_entry import launch_counts

        before = launch_counts()
        out = fn(*args, **kw)
        _sync()
        _add(self.counts, _delta(before, launch_counts()))
        return out


def _checked_slab_passes(mesh, state, on_path, passes=None):
    """Slab passes of `state` on this rank: `evaluate_light_slab` to
    convergence (`passes` None) or `passes` passes. Each pass's gathered
    light is held, on rank 0, to the one-process K2 pass
    (`dense.relight_all_pass`) from the same light on the same card (a
    comparison: not on the path). Returns (rows, passes run): per pass
    this rank's K2 ms (CUDA events), its exchanges' ms and bytes (the
    first pass's include the one-time contents halo), the world's
    max_diff and, on rank 0, whether the gathered light was the
    one-process pass's bit for bit."""
    import dataclasses as dc

    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.parallel import comm, slab

    dev = mesh.device
    sh = on_path(slab.shard_space, state, mesh)
    ref = state.to(dev) if mesh.rank == 0 else None
    ctx = dense.build_relight_ctx(ref) if ref is not None else None
    rows: list = []
    light = [state.light.to(dev)]
    plain_pass = slab.relight_pass_slab

    def checked(sh_):
        comm.reset_exchanges()
        k2 = []
        stats = on_path(plain_pass, sh_, k2)
        ex = list(comm.EXCHANGES)
        gathered = sh_.gather().light
        row = {"k2_ms": k2[0], "exchange_ms": sum(e["ms"] for e in ex),
               "exchange_bytes": sum(e["bytes"] for e in ex), "max_diff": int(stats["max_diff"])}
        if ref is not None:
            want = dense.relight_all_pass(dc.replace(ref, light=light[0]), ctx)
            row["equal"] = bool(torch.equal(gathered, want))
            if not row["equal"]:
                d = (gathered[..., :3].int() - want[..., :3].int()).abs()
                row["diff"] = (int(d.max()), int((d > 0).any(-1).sum()),
                               bool(torch.equal(gathered[..., 3], want[..., 3])))
        light[0] = gathered
        rows.append(row)
        return stats

    if passes is None:
        slab.relight_pass_slab = checked  # evaluate_light_slab's pass, checked as it runs
        try:
            n = slab.evaluate_light_slab(sh, max_passes=SLAB_MAX_PASSES)
        finally:
            slab.relight_pass_slab = plain_pass
    else:
        for _ in range(passes):
            checked(sh)
        n = passes
    return sh, rows, n


def _plain_passes(state, max_passes) -> int:
    """The passes of a loop of one-process `relight_all_pass` passes from
    the state's light until no cube moves by more than one step."""
    import dataclasses as dc

    from aic_tpu_torch.light import dense
    from aic_tpu_torch.math import lightpack

    ctx = dense.build_relight_ctx(state)
    for n in range(1, max_passes + 1):
        new = dense.relight_all_pass(state, ctx)
        diff = int(lightpack.difference_priority(state.light, new).max())
        state = dc.replace(state, light=new)
        if diff <= 1:
            return n
    return max_passes


def _timed_frame(fn, mesh=None):
    """(fn(), its host-clock ms), the card synchronized before and after;
    with `mesh`, its ranks meet first, so no rank's time holds its wait
    for the others."""
    if mesh is not None and mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def gloo_ranks(mesh, plaza_state, city_state, city_cam, atrium_state, atrium_cam) -> dict:
    """Rank work of phase 11(b): four ranks on one card over gloo. The
    states come as CPU tensors; a slab world moves only the rank's slab
    and its halos to the card, a replicated one the whole state.

    plaza640: `evaluate_light_slab` to convergence, every pass checked
    (`_checked_slab_passes`), and, on rank 0, the passes of a loop of
    one-process passes. Demo-city: CITY_SLAB_PASSES checked slab passes,
    then `trace_rays_slab` at MULTI_W x MULTI_H from `city_cam` against
    the one-process `trace_rays` (rank 0). The atrium:
    `relight_all_pass_sharded` against the one-process pass, and
    `render_sharded` against `trace_rays` of the whole frame (rank 0).
    Returns this rank's launches on those paths and its times."""
    import torch
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.parallel import render_sharded, slab
    from aic_tpu_torch.raytrace.tracer import trace_rays

    dev = mesh.device
    on_path = _OnPath()
    out: dict = {"rank": mesh.rank}

    _, out["plaza"], out["plaza_passes"] = _checked_slab_passes(mesh, plaza_state, on_path)
    if mesh.rank == 0:
        out["plaza_plain_passes"] = _plain_passes(plaza_state.to(dev), SLAB_MAX_PASSES)

    sh, out["city"], _ = _checked_slab_passes(mesh, city_state, on_path, passes=CITY_SLAB_PASSES)
    o, d = city_cam.pixel_rays(device=dev)
    (light, trans), out["city_slab_frame_ms"] = _timed_frame(
        lambda: on_path(slab.trace_rays_slab, sh, o, d, city_cam.options), mesh)
    lit = sh.gather()
    if mesh.rank == 0:
        (_, _), out["city_frame_ms"] = _timed_frame(lambda: trace_rays(lit, o, d, city_cam.options))
        wl, wt, hits = trace_rays(lit, o, d, city_cam.options, return_hits=True)
        err = torch.maximum((light - wl).abs().amax(-1), (trans - wt).abs())
        spent = (hits["phases"][-1]["hit_kind"] != 0).reshape(err.shape)  # the last phase still hit
        kept = err[~spent]
        out["city_frame"] = dict(
            max_err=float(kept.max()), over_slab=int((kept > SLAB_ATOL).sum()), over_light=int((err > LIGHT_ATOL).sum()),
            spent=int(spent.sum()), spent_max_err=float(err[spent].max()) if spent.any() else 0.0, rays=int(err.numel()))

    atrium = atrium_state.to(dev)
    ctx = dense.build_relight_ctx(atrium)
    # K2 over the rank's rays, and the all-reduce.
    new_light, out["atrium_pass_ms"] = _timed_frame(
        lambda: on_path(dense.relight_all_pass_sharded, atrium, ctx, mesh), mesh)
    (light, trans), out["atrium_rows_frame_ms"] = _timed_frame(
        lambda: on_path(render_sharded, atrium, atrium_cam, mesh), mesh)
    if mesh.rank == 0:
        want = dense.relight_all_pass(atrium, ctx)
        d = (new_light[..., :3].int() - want[..., :3].int()).abs()
        out["atrium_pass"] = (int(d.max()), bool(torch.equal(new_light[..., 3], want[..., 3])))
        o, d = atrium_cam.pixel_rays(device=dev)
        (wl, wt), out["atrium_frame_ms"] = _timed_frame(lambda: trace_rays(atrium, o, d, atrium_cam.options))
        out["atrium_frame_equal"] = bool(torch.equal(light, wl) and torch.equal(trans, wt))
    out["counts"] = on_path.counts
    return out


def nccl_ranks(mesh, city_state) -> dict:
    """Rank work of phase 11(a), one NCCL rank per card: the dry run
    (`graft_entry._dryrun_multichip_impl`), then one slab pass of
    demo-city, whose gathered light rank 0 holds to the one-process K2
    pass bit for bit."""
    import torch
    from aic_tpu_torch import graft_entry
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.parallel import slab

    on_path = _OnPath()
    t0 = time.perf_counter()
    on_path(graft_entry._dryrun_multichip_impl, mesh)
    out = {"rank": mesh.rank, "dry_s": time.perf_counter() - t0, "transport": mesh.transport,
           "world": mesh.world}
    sh = on_path(slab.shard_space, city_state, mesh)
    on_path(slab.relight_pass_slab, sh)
    gathered = sh.gather().light
    if mesh.rank == 0:
        ref = city_state.to(mesh.device)
        out["equal"] = bool(torch.equal(gathered, dense.relight_all_pass(ref, dense.build_relight_ctx(ref))))
    out["counts"] = on_path.counts
    return out


def multi_gpu_world(dev, smi, opts, universe) -> dict:
    """Phase 11: the multi-GPU paths, in two worlds of ranks, each world's
    states built once here and handed to the ranks as CPU tensors (the
    kernels were built before any rank started): (a) one NCCL rank per
    card (`nccl_ranks`); (b) GLOO_RANKS ranks on card 0 over the
    host-staged gloo transport (`gloo_ranks`), then
    `graft_entry.dryrun_multichip(GLOO_RANKS)` over it; (c)
    `universe` (the session's demo-city) saved with
    `save_alliscubesjson`, loaded back (contents equal up to the palette
    renumbering the importer makes, packed light equal) and opened by
    `main FILE --graphics print` as a subprocess.
    Returns the launches of every rank and of main, summed."""
    import tempfile

    import torch
    from aic_tpu_torch import graft_entry
    from aic_tpu_torch.content import TemplateParameters, atrium, build_universe, plaza
    from aic_tpu_torch.io import load_alliscubesjson, save_alliscubesjson
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.parallel import spawn
    from aic_tpu_torch.raytrace import Camera, GraphicsOptions, Viewport

    counts: dict = {}
    t0 = time.perf_counter()
    plaza_state = plaza().snapshot(device=dev).to("cpu")
    city = build_universe("demo-city", TemplateParameters(seed=0, size=96), device=dev)
    city_state = city.states["world"].to("cpu")
    sp = city.spaces["world"]
    city_cam = Camera(GraphicsOptions(lighting_display="smoothstep", fog="none", transparency="surface"),
                      Viewport(MULTI_W, MULTI_H))
    sz, lo = np.asarray(sp.bounds.size, np.float64), np.asarray(sp.bounds.lower, np.float64)
    city_cam.look_at(lo + sz * np.array([0.5, 0.6, 0.95]), lo + sz * 0.5)  # bench.py:259
    atrium_space = atrium()
    atrium_state = atrium_space.snapshot(device=dev).to("cpu")
    atrium_cam = default_camera(atrium_space, MULTI_W, MULTI_H, opts)
    del city
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0

    # (a) one NCCL rank per card.
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = spawn(nccl_ranks, n, "cuda", "nccl", args=(city_state,), threads=2, timeout=600)
    secs = time.perf_counter() - t0
    if not ranks[0]["equal"]:
        fail("multi-gpu nccl: demo-city's gathered slab pass is not the one-process K2 pass")
    for r in ranks:
        _add(counts, r["counts"])
    phase("multi-gpu", f"(a) nccl, {n} rank(s), one a card ({smi}): dry run {ranks[0]['dry_s']:.3f} s, then "
          f"demo-city {tuple(city_state.contents.shape)} in slabs of {city_state.contents.shape[0] // n}: one slab "
          f"pass, gathered, equal to "
          f"the one-process K2 pass bit for bit; the world {secs:.3f} s with start-up; launches by rank "
          f"{[r['counts'] for r in ranks]}")

    # (b) four ranks on card 0 over the host-staged gloo transport.
    t0 = time.perf_counter()
    ranks = spawn(gloo_ranks, GLOO_RANKS, "cuda", "gloo",
                  args=(plaza_state, city_state, city_cam, atrium_state, atrium_cam), threads=2, timeout=900)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        _add(counts, r["counts"])
    for name, st in (("plaza", plaza_state), ("city", city_state)):
        rows, size = r0[name], tuple(st.contents.shape)
        pad = min(st.light_max_distance + 1, size[0])
        slab_x = size[0] // GLOO_RANKS
        bad = [i for i, row in enumerate(rows) if not row["equal"]]
        if bad:
            fail(f"multi-gpu {GLOO}: {name} slab pass(es) {bad} differ from the one-process K2 pass: "
                 f"{[rows[i]['diff'] for i in bad]} (max step, cubes, statuses equal)")
        label = "plaza640" if name == "plaza" else "demo-city"
        phase("multi-gpu", f"(b) {GLOO}, {GLOO_RANKS} ranks on {smi}: {label} {size} in slabs of "
              f"{slab_x}, halo pad {pad} ({-(-pad // slab_x)} hop(s)): {len(rows)} slab passes, each "
              f"gathered light equal to the one-process K2 pass from the same light bit for bit; K2 ms a pass by "
              f"rank {[[round(row['k2_ms'], 4) for row in r[name]] for r in ranks]}; exchange ms a pass (rank 0) "
              f"{[round(row['exchange_ms'], 3) for row in rows]}, bytes {[row['exchange_bytes'] for row in rows]}; "
              f"max_diff {[row['max_diff'] for row in rows]}")
    if r0["plaza_passes"] >= SLAB_MAX_PASSES or r0["plaza_passes"] != r0["plaza_plain_passes"]:
        fail(f"multi-gpu {GLOO}: plaza640 took {r0['plaza_passes']} slab passes, the one-process loop "
             f"{r0['plaza_plain_passes']}")
    cf = r0["city_frame"]
    if cf["over_slab"] > PIXEL_MAX_SHARE * cf["rays"]:
        fail(f"multi-gpu {GLOO}: demo-city's slab frame: {cf}: rays within the trace's budget over {SLAB_ATOL}")
    d_max, status_equal = r0["atrium_pass"]
    if d_max > RELIGHT_MAX_STEP or not status_equal:
        fail(f"multi-gpu {GLOO}: the atrium's ray-split pass is {d_max} steps from the one-process pass "
             f"(statuses equal: {status_equal})")
    if not r0["atrium_frame_equal"]:
        fail(f"multi-gpu {GLOO}: the atrium's row-sharded frame is not trace_rays' bit for bit")
    phase("multi-gpu", f"(b) {GLOO} ({smi}): plaza640 converged in {r0['plaza_passes']} slab passes, a loop of "
          f"one-process passes in {r0['plaza_plain_passes']}; demo-city slab frame {MULTI_W}x{MULTI_H} "
          f"{[round(r['city_slab_frame_ms'], 1) for r in ranks]} ms by rank (one-process trace_rays "
          f"{r0['city_frame_ms']:.1f} ms): of {cf['rays']} rays, {cf['spent']} spend the one-process trace's budget "
          f"(max abs err {cf['spent_max_err']:.3e}), of the others {cf['over_slab']} over {SLAB_ATOL} (at most "
          f"{PIXEL_MAX_SHARE:g} of the rays; max abs err {cf['max_err']:.3e}); "
          f"{cf['over_light']} pixels over {LIGHT_ATOL} in all; atrium "
          f"ray-split pass {[round(r['atrium_pass_ms'], 3) for r in ranks]} ms by rank (K2 and the all-reduce), "
          f"within {d_max} step of the one-process pass; row-sharded frame "
          f"{[round(r['atrium_rows_frame_ms'], 1) for r in ranks]} ms by rank (one-process "
          f"{r0['atrium_frame_ms']:.1f} ms), equal to trace_rays' bit for bit; the world {secs:.3f} s with start-up "
          f"(worlds built in {build_s:.3f} s); launches by rank {[r['counts'] for r in ranks]}")
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(GLOO_RANKS, device="cuda", transport="gloo")
    dry_s = time.perf_counter() - t0
    for c in dry:
        _add(counts, c)
    phase("multi-gpu", f"(b) {GLOO}: graft_entry.dryrun_multichip({GLOO_RANKS}) {dry_s:.3f} s with start-up; "
          f"launches by rank {dry}")

    # (c) the reference's .alliscubesjson.
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "aic_tpu_torch", "_build")) as tmp:
        path = os.path.join(tmp, "city.alliscubesjson")
        t0 = time.perf_counter()
        save_alliscubesjson(universe, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, warns = load_alliscubesjson(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        # The file holds the whole palette; the importer (`aic_tpu`'s, as
        # the port's) keeps the entries the contents use, in index order,
        # so the contents are equal up to that renumbering: one loaded
        # entry for each saved one.
        saved, loaded = universe.spaces["world"].contents, back.spaces["world"].contents
        pairs = np.unique(np.stack([saved.ravel(), loaded.ravel()]), axis=1)
        n_used = len(np.unique(saved))
        if warns or saved.shape != loaded.shape or not (
                pairs.shape[1] == n_used == len(np.unique(pairs[1])) == back.spaces["world"].palette_len()):
            fail(f"multi-gpu .alliscubesjson: the loaded contents differ (warnings {warns[:3]}, "
                 f"{pairs.shape[1]} index pairs for {n_used} used entries)")
        if not torch.equal(back.states["world"].light, universe.states["world"].light):
            fail("multi-gpu .alliscubesjson: the loaded packed light differs")
        main_counts, main_s, err = run_main([path, "--graphics", "print"], "multi-gpu .alliscubesjson")
        if "[open] city.alliscubesjson" not in err:
            fail(f"multi-gpu .alliscubesjson: main did not open the file: {err[-1000:]}")
        _add(counts, main_counts)
        phase("multi-gpu", f"(c) .alliscubesjson ({smi}): the session's demo-city saved {save_s:.3f} s "
              f"({os.path.getsize(path)} bytes, {len(back.spaces)} spaces), loaded {load_s:.3f} s: contents equal "
              f"({universe.spaces['world'].palette_len()} palette entries saved, the {n_used} used kept, renumbered) "
              f"and packed light equal; main FILE --graphics print {main_s:.3f} s as a subprocess, launches {main_counts}")
    for name in ("relight_pass", "relight_batch"):
        if counts.get(name, 0) <= 0:
            fail(f"multi-gpu: {name} was not launched on the multi-GPU paths: {counts}")
    phase("multi-gpu", f"launches (every rank, main) {counts}")
    return dict(counts=counts)


# -- the goldens: the port's frames, light and transactions held to aic_tpu --

#: The self-goldens of tests/test_render_goldens.py (`aic_tpu`'s renders,
#: PNGs under tests/goldens/), built by `golden_case` as that file builds
#: them, and their threshold there (differing fraction, delta).
GOLDENS = os.path.join(HERE, "tests", "goldens")
SELF_GOLDENS = ("cornell_flat", "cornell_lit_smoothstep", "transparency_volumetric", "recursive_fog",
                "atrium_overview", "demo_city_overview")
SELF_GOLDEN_THRESHOLD = (0.02, 6)
#: `aic_tpu`'s 1920x1080 frames of the main paths' worlds and the light it
#: traced them with (written by tests/torch_references.py), and the
#: tracer `render` must take for each on the card. The trace reference
#: (the card's frame of the world carrying `aic_tpu`'s light) is held at
#: TRACE_THRESHOLD: `aic_tpu`'s own two tracers differ in 4 knife-edge
#: pixels of 2.07 M on demo-city (ROADMAP C). The end-to-end reference
#: (the atrium frame of the card's own relight) at END_TO_END_THRESHOLD,
#: the self-goldens': the card's w = 1.3 f32 relight and `aic_tpu`'s CPU
#: Jacobi agree to within one packed step (ROADMAP C).
REFERENCES = os.path.join(GOLDENS, "aic_tpu_1080p")
REFERENCE_TRACERS = {"atrium": "megakernel", "plaza640": "v1", "demo-city": "megakernel"}
TRACE_THRESHOLD = (0.001, 2)
END_TO_END_THRESHOLD = (0.02, 6)
#: The light oracle: ORACLE_SAMPLES seeded (cube, point, face) samples at
#: visible surfaces of the lit cornell-box 16, the port's smooth-light
#: functions (the phase shader's interp-row path and the direct-fetch
#: path) against `testing.refmath.interpolated_light_oracle` (f64), in
#: linear and smoothstep modes. ORACLE_BOUND (max abs difference of the
#: rgb) is the larger of 1e-5 and `aic_tpu`'s own `_interpolated_light`
#: against the oracle on the same samples, which
#: tests/test_torch_goldens.py::test_oracle_bound_covers_aic_tpu measures
#: on the CPU (8.7e-7 linear, 1.2e-6 smoothstep).
ORACLE_SAMPLES = 4096
ORACLE_SEED = 15
ORACLE_BOUND = 1e-5
ORACLE_MODES = (("linear", "linear"), ("smoothstep", "smooth"))


def golden_case(name, dev):
    """(state, camera) of one of tests/test_render_goldens.py's cases,
    built with the port as that file builds it with `aic_tpu`; the state on
    `dev`. The lit cornell-box's relight runs `evaluate_light`, whose w =
    1.3 loop falls back to plain Jacobi there (recorded, not an error)."""
    from aic_tpu_torch import block
    from aic_tpu_torch.content import atrium, cornell_box, demo_city, menger_sponge
    from aic_tpu_torch.light import dense
    from aic_tpu_torch.light.update import evaluate_light
    from aic_tpu_torch.math.grid import GridAab
    from aic_tpu_torch.raytrace import Camera, GraphicsOptions, Viewport
    from aic_tpu_torch.space import Sky, Space, SpacePhysics

    size, cornell_eye = 48, np.array([0.5, 0.5, 1.6]) * 16
    if name == "cornell_flat":
        st = cornell_box(16).snapshot(device=dev)
        opts = GraphicsOptions(lighting_display="none", fog="none", transparency="surface")
        eye, target = cornell_eye, (8, 8, 8)
    elif name == "cornell_lit_smoothstep":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", dense.OverrelaxFellBack)
            st, _ = evaluate_light(cornell_box(16).snapshot(device=dev), batch_size=512, max_rounds=400)
        opts = GraphicsOptions(lighting_display="smoothstep", fog="none", transparency="surface")
        eye, target = cornell_eye, (8, 8, 8)
    elif name == "transparency_volumetric":
        sp = Space(GridAab.cube(6), physics=SpacePhysics(sky=Sky.uniform((0.8, 0.85, 1.0))))
        sp.fill(GridAab.from_lower_size((0, 0, 0), (6, 1, 6)), block.from_color((0.4, 0.4, 0.4, 1)))
        sp.set((2, 1, 2), block.Block(block.Atom(color=(1.0, 0.2, 0.2, 0.4))))
        sp.set((3, 1, 3), block.from_color((0.2, 0.2, 1.0, 1.0)))
        sp.fast_evaluate_light()
        st = sp.snapshot(device=dev)
        opts = GraphicsOptions(lighting_display="flat", fog="none", transparency="volumetric")
        eye, target = (3.0, 4.0, 8.0), (3.0, 1.0, 3.0)
    elif name == "recursive_fog":
        st = menger_sponge(world_levels=2, block_levels=2).snapshot(device=dev)
        opts = GraphicsOptions(lighting_display="none", fog="physical", transparency="surface")
        eye, target = (14.0, 12.0, 20.0), (4.5, 4.5, 4.5)
    elif name == "atrium_overview":
        st = atrium(width=30, depth=20, floors=2).snapshot(device=dev)
        opts = GraphicsOptions(lighting_display="flat", fog="none")
        eye, target, size = np.array([15.0, 4.0, 6.0]), (15.0, 5.0, 10.0), 64
    elif name == "demo_city_overview":
        st = demo_city(seed=1, size=48).snapshot(device=dev)
        opts = GraphicsOptions(lighting_display="flat", fog="none")
        eye, target, size = np.array([0.0, 14.0, 30.0]), (0.0, 2.0, 0.0), 64
    else:
        raise KeyError(name)
    cam = Camera(opts, Viewport(size, size))
    cam.look_at(eye, target)
    return st, cam


def surface_samples(state, n, seed):
    """`n` seeded (cube i64[n,3], point f32[n,3], face i64[n]) at visible
    surfaces, index space: a face of a visible cube whose neighbour across
    it lies inside the bounds and is not visible. Half the points lie on
    the face (an atom's surface), half inside the cube at a random depth
    along the normal (where a voxel block's surface lies); both at a
    random place across the face."""
    from aic_tpu_torch.math import faces as F

    vis = state.tables.visible.cpu().numpy()[state.contents.cpu().numpy()]
    pad = np.pad(vis, 1, constant_values=True)
    X, Y, Z = vis.shape
    cands = []
    for f in range(6):
        nx, ny, nz = F.FACE_NORMALS[f]
        exposed = vis & ~pad[1 + nx : 1 + nx + X, 1 + ny : 1 + ny + Y, 1 + nz : 1 + nz + Z]
        cubes = np.argwhere(exposed)
        cands.append(np.concatenate([cubes, np.full((len(cubes), 1), f)], axis=1))
    cands = np.concatenate(cands)
    rng = np.random.default_rng(seed)
    pick = cands[rng.integers(0, len(cands), n)]
    cube, face = pick[:, :3], pick[:, 3]
    frame = np.asarray(F.FACE_TANGENT_FRAMES, np.float64)[face]
    depth = np.where(np.arange(n) % 2 == 0, 1.0, rng.random(n))
    r = rng.random((n, 2))
    point = (cube + 0.5 + frame[:, 2] * (depth[:, None] - 0.5) + frame[:, 0] * (r[:, :1] - 0.5)
             + frame[:, 1] * (r[:, 1:] - 0.5))
    return cube, point.astype(np.float32), face


def oracle_light(state, cube, point, face, mode):
    """f64[n,3]: `interpolated_light_oracle` over the samples (a host copy
    of the state read once)."""
    from aic_tpu_torch.testing.refmath import interpolated_light_oracle

    host = state.to("cpu")
    return np.stack([interpolated_light_oracle(host, c, p, int(f), mode) for c, p, f in zip(cube, point, face)])


def port_smooth_light(state, cube, point, face, mode):
    """The port's smooth light on the state's device, f64[n,3] each: the
    phase shader's path (`_interpolated_light_rows` over
    `_build_interp_rows`) and the direct-fetch path (`_interpolated_light`)."""
    import torch
    from aic_tpu_torch.raytrace import tracer

    dev = state.device
    c = torch.as_tensor(cube, dtype=torch.int32, device=dev)
    p = torch.as_tensor(point, device=dev)
    f = torch.as_tensor(face, dtype=torch.int32, device=dev)
    rows = tracer._interpolated_light_rows(state, tracer._build_interp_rows(state), c, p, f, mode)
    direct = tracer._interpolated_light(state, c, p, f, mode)
    return rows.double().cpu().numpy(), direct.double().cpu().numpy()


def txn_law_cases(make_target, commit):
    """tests/test_txn_laws.py's SpaceTransaction cases (its five example
    transactions, with the out-of-bounds non-conserved write of
    `test_commit_never_errors_when_check_passed` as a sixth, and its two
    targets) as a port `TransactionTester`. `make_target(with_red)` makes a
    target with `.space`; `commit(txn, target)` commits a transaction.
    Each predicate reads the target's host space and, where the target has
    a device `.state`, its contents at the cube."""
    from aic_tpu_torch import block
    from aic_tpu_torch.testing.txn_tester import TransactionTester
    from aic_tpu_torch.universe.transaction import SpaceTransaction

    red = block.from_color((0.9, 0.1, 0.1, 1.0), display_name="red")
    green = block.from_color((0.1, 0.9, 0.1, 1.0), display_name="green")
    blue = block.from_color((0.1, 0.1, 0.9, 1.0), display_name="blue")

    def expects(cube, blk):
        def pred(before, after):
            sp = after.space
            assert sp.block_at(cube) == blk, f"expected {blk.attributes.display_name} at {cube}"
            if getattr(after, "state", None) is not None:
                dev_idx = int(after.state.contents[cube].item())
                assert dev_idx == int(sp.contents[sp._rel(cube)]), f"device contents at {cube}: {dev_idx}"

        return pred

    return (
        TransactionTester(check=lambda txn, t: txn.check(t.space), commit=commit)
        .transaction(SpaceTransaction.set_cube((1, 1, 1), new=green), expects((1, 1, 1), green))
        .transaction(SpaceTransaction.set_cube((2, 2, 2), new=blue, conserved=False), expects((2, 2, 2), blue))
        .transaction(SpaceTransaction.set_cube((0, 0, 0), old=red, new=green), expects((0, 0, 0), green))
        .transaction(SpaceTransaction.set_cube((1, 1, 1), new=blue), expects((1, 1, 1), blue))
        .transaction(SpaceTransaction.emitting_fluff((3, 3, 3), "happened"), lambda before, after: None)
        .transaction(SpaceTransaction.set_cube((99, 0, 0), new=green, conserved=False),
                     lambda before, after: None)
        .target(lambda: make_target(True, (red, green, blue)))
        .target(lambda: make_target(False, (red, green, blue)))
    )


class DeviceTarget:
    """A transaction target whose contents live on the device: a 4³ host
    Space (red at the origin where `with_red`) with the example blocks
    already in its palette, so no commit grows it, and its snapshot on
    `dev`. `commit` commits the host half and scatters the device half
    (`scatter_set_cubes`, through `SpaceTransaction.commit`)."""

    def __init__(self, dev, with_red, blocks):
        from aic_tpu_torch.math.grid import GridAab
        from aic_tpu_torch.space import Space

        self.space = Space(GridAab.from_lower_size((0, 0, 0), (4, 4, 4)))
        for b in blocks:
            self.space.ensure_block(b)
        if with_red:
            self.space.set((0, 0, 0), blocks[0])
        self.state = self.space.snapshot(device=dev)

    def commit(self, txn):
        state = txn.commit(self.space, self.state)
        if state is None:
            raise RuntimeError("the commit grew the palette: the device state would need a resnapshot")
        self.state = state


def goldens_world(dev, smi, reset_counts, read_counts, spaces, atrium_frame) -> dict:
    """The port held to images, light and transactions `aic_tpu` made,
    the launch counters set to 0 before and read after: (a) the six
    self-goldens rendered on the card; (b) the main paths' worlds
    (`spaces` holds the atrium and plaza640; demo-city is built here as
    `city_world` builds it) carrying `aic_tpu`'s stored light, traced and
    finished by `render` (K1, K3) and held to `aic_tpu`'s frames, and
    `atrium_frame`, the slice phase's frame of the card's own relight,
    held to `aic_tpu`'s converged atrium; (c) the light oracle on the lit
    cornell-box 16 of (a); (d) the transaction laws on targets whose
    contents live on the card. A missing reference file fails."""
    import dataclasses
    import importlib

    import torch
    from aic_tpu_torch.content import TemplateParameters, build_template_space
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.raytrace import GraphicsOptions, render
    from aic_tpu_torch.space import state as state_mod
    from aic_tpu_torch.testing import Threshold, compare_to_golden

    render_mod = importlib.import_module("aic_tpu_torch.raytrace.render")

    def golden_path(path):
        if not os.path.exists(path):
            fail(f"goldens: the reference {os.path.relpath(path, HERE)} is missing")
        return path

    def compare(image, path, threshold, label):
        ok, msg = compare_to_golden(image, golden_path(path), Threshold(*threshold))
        if msg.startswith("recorded"):
            fail(f"goldens {label}: compare_to_golden recorded instead of comparing ({msg})")
        if not ok:
            fail(f"goldens {label}: {msg} at Threshold{threshold}")
        return msg

    t_phase = time.perf_counter()
    reset_counts()
    lit_cornell = None
    for name in SELF_GOLDENS:
        before = read_counts()
        state, cam = golden_case(name, dev)
        tracer = render_mod.pick_tracer(state)
        img = render(state, cam).data
        msg = compare(img, os.path.join(GOLDENS, f"{name}.png"), SELF_GOLDEN_THRESHOLD, name)
        after = read_counts()
        phase("goldens", f"(a) {name} {img.shape[1]}x{img.shape[0]}: {tracer}; {msg} "
              f"(Threshold{SELF_GOLDEN_THRESHOLD}); launches {_delta(before, after)}")
        if name == "cornell_lit_smoothstep":
            lit_cornell = state

    with open(golden_path(os.path.join(REFERENCES, "manifest.json"))) as f:
        manifest = json.load(f)
    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    for world, tracer_want in REFERENCE_TRACERS.items():
        entry = manifest[world]
        space = spaces.get(world) or build_template_space("demo-city", TemplateParameters(seed=0, size=96))
        cam = default_camera(space, 1920, 1080, opts)
        if not np.array_equal(cam.eye_to_world, np.asarray(entry["eye_to_world"])) or \
                entry["options"] != dict(lighting_display="smoothstep", fog="none"):
            fail(f"goldens {world}: the reference's camera or options are not the main path's")
        light = np.load(golden_path(os.path.join(REFERENCES, f"{world}_light.npz")))["light"]
        snap = space.snapshot(device=dev)
        if light.shape != tuple(snap.light.shape):
            fail(f"goldens {world}: stored light {light.shape}, the world's {tuple(snap.light.shape)}")
        state = dataclasses.replace(snap, light=torch.from_numpy(light).to(dev))
        del snap
        before = read_counts()
        traces = dict(render_mod.TRACES)
        t0 = time.perf_counter()
        frame = render(state, cam)
        frame_ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        took = [k for k in traces if render_mod.TRACES[k] > traces[k]]
        if took != [tracer_want]:
            fail(f"goldens {world}: render took {took}, not {tracer_want}")
        if frame.flaws:
            fail(f"goldens {world}: render flaws {frame.flaws}")
        msg = compare(frame.data, os.path.join(REFERENCES, f"{world}.png"), TRACE_THRESHOLD, f"{world} trace")
        phase("goldens", f"(b) {world} 1920x1080 with aic_tpu's light ({entry['light']}): {tracer_want}, "
              f"{frame_ms:.1f} ms; {msg} (Threshold{TRACE_THRESHOLD}); launches {_delta(before, after)}")
        del state, frame
    msg = compare(atrium_frame, os.path.join(REFERENCES, "atrium.png"), END_TO_END_THRESHOLD, "atrium end to end")
    phase("goldens", f"(b) atrium end to end (the slice phase's frame of the card's own relight) against "
          f"aic_tpu's converged atrium: {msg} (Threshold{END_TO_END_THRESHOLD})")

    t0 = time.perf_counter()
    cube, point, face = surface_samples(lit_cornell, ORACLE_SAMPLES, ORACLE_SEED)
    errs = {}
    for mode, oracle_mode in ORACLE_MODES:
        want = oracle_light(lit_cornell, cube, point, face, oracle_mode)
        rows, direct = port_smooth_light(lit_cornell, cube, point, face, mode)
        errs[mode] = (float(np.abs(rows - want).max()), float(np.abs(direct - want).max()))
        if max(errs[mode]) > ORACLE_BOUND:
            fail(f"goldens light oracle, {mode}: max abs difference (rows, direct) {errs[mode]} over {ORACLE_BOUND}")
    phase("goldens", f"(c) light oracle, lit cornell-box 16, {ORACLE_SAMPLES} samples at visible surfaces, on "
          f"{dev}: max abs difference to the f64 oracle (interp rows, direct) {errs}, bound {ORACLE_BOUND}; "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with timed_calls(state_mod, "scatter_set_cubes") as scatters:
        txn_law_cases(lambda with_red, blocks: DeviceTarget(dev, with_red, blocks),
                      lambda txn, target: target.commit(txn)).test()
    if not scatters:
        fail("goldens transaction laws: no commit went through scatter_set_cubes")
    phase("goldens", f"(d) transaction laws on targets on {dev}: check before commit and merge completeness held "
          f"over 6 transactions, their merges and 2 targets; {len(scatters)} commits scattered on the card; "
          f"{time.perf_counter() - t0:.1f} s")

    counts = read_counts()
    for name in ("trace_megakernel", "trace_v1"):
        if counts[name] <= 0:
            fail(f"goldens: {name} was not launched: {counts}")
    phase("goldens", f"({smi}) {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return dict(counts=counts)


def main() -> None:
    sys.path.insert(0, HERE)
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        import aic_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the aic_tpu_torch package is not beside chip_smoke.py ({e})")
    from aic_tpu_torch import block, kernels
    from aic_tpu_torch.graft_entry import launch_counts
    from aic_tpu_torch.content import atrium, cornell_box, plaza
    from aic_tpu_torch.light import evaluate_light_dense
    from aic_tpu_torch.light import relight_kernel as rk
    from aic_tpu_torch.main import default_camera
    from aic_tpu_torch.math.grid import GridAab
    from aic_tpu_torch.raytrace import GraphicsOptions, accel, render, save_png
    from aic_tpu_torch.raytrace import trace_kernel as tk
    from aic_tpu_torch.raytrace import trace_kernel_v1 as v1
    from aic_tpu_torch.raytrace.render import finish_frame
    from aic_tpu_torch.space import Sky, Space, SpacePhysics

    from aic_tpu_torch.light.dense import OverrelaxFellBack

    # The main paths' relights (the atrium, plaza640, the step worlds'
    # loads) converge at w = OVERRELAX without falling back to plain
    # Jacobi; compare_converge records the fall-back where it is expected.
    warnings.simplefilter("error", OverrelaxFellBack)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import importlib.util

    pil = "PIL importable" if importlib.util.find_spec("PIL") is not None else "PIL not importable"
    phase("device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}; "
          f"{pil} (the port composes text from its vendored glyph table either way, and never imports it)")

    # 2. build
    t0 = time.perf_counter()
    names = ("relight", "trace", "trace_v1")
    kernels.build(*names)
    for name in names:
        kernels.load_library(name)
    regs = {
        n: [ln.strip() for ln in info[1].splitlines() if "registers" in ln or "spill" in ln]
        for n, info in kernels.BUILD_INFO.items()
    }
    phase("build", f"{' + '.join(names)} built in {time.perf_counter() - t0:.1f} s; ptxas: {regs}")
    from aic_tpu_torch import native

    t0 = time.perf_counter()
    for name in native.CXX_FLAGS:
        native.load(name)
    phase("build", f"native {' + '.join(native.CXX_FLAGS)} (g++) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain twins
    pkg = (block, GridAab, Space, Sky, SpacePhysics)
    small = {"mixed 12^3": relight_scene(pkg), "cornell-box 16": cornell_box(16)}
    for label, sp in small.items():
        compare_relight(sp.snapshot(device=dev), label)
    check_empty_work_list(pkg, dev)
    scenes = trace_scenes(pkg)
    for label, sp in scenes.items():
        o, d = random_rays(4096, -4.0, 24.0, seed=len(label))
        compare_trace(sp.snapshot(device=dev), o, d, label)
        if label != "r32":  # the v1 kernel holds R <= 16
            compare_v1(sp.snapshot(device=dev), o, d, label, inner_round=label == "voxels")

    opts = GraphicsOptions(lighting_display="smoothstep", fog="none")
    atrium_space = atrium()
    cam = default_camera(atrium_space, 1920, 1080, opts)
    atrium_state = atrium_space.snapshot(device=dev)
    compare_relight(atrium_state, "atrium")
    for label, sp in dict(small, atrium=atrium_space).items():
        compare_converge(sp, label, dev)
    o, d = cam.pixel_rays(device=dev)
    compare_trace(atrium_state, o, d, "atrium 1920x1080")
    trace_v1_atrium = compare_v1(atrium_state, o, d, "atrium 1920x1080")
    compare_paths(atrium_state, o, d, opts, "atrium 1920x1080")

    plaza_space = plaza()
    plaza_cam = default_camera(plaza_space, 1920, 1080, opts)
    plaza_state = plaza_space.snapshot(device=dev)
    if tk.megakernel_fits(plaza_state):
        fail("plaza640's megakernel tables fit their budget: it would not take the v1 path")
    po, pd = plaza_cam.pixel_rays(device=dev)
    trace_v1 = compare_v1(plaza_state, po, pd, "plaza640 1920x1080")
    # K1 on the same rays, though plaza640's frame takes v1 (the tables'
    # 10 MiB limit is a TPU VMEM limit): timed for comparison only.
    compare_trace(plaza_state, po, pd, "plaza640 1920x1080")
    compare_paths(plaza_state, po, pd, opts, "plaza640 1920x1080")
    relight = compare_relight(plaza_state, "plaza640")
    compare_converge(plaza_space, "plaza640", dev)
    del plaza_state, atrium_state

    def reset_counts():
        rk.LAUNCHES = rk.LAUNCHES_DYN = rk.LAUNCHES_LISTED = tk.LAUNCHES = v1.LAUNCHES = 0
        torch.cuda.synchronize()

    def read_counts():
        torch.cuda.synchronize()
        return launch_counts()

    def relight_and_render(space, camera):
        t0 = time.perf_counter()
        state = space.snapshot(device=dev)
        torch.cuda.synchronize()
        snapshot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, passes = evaluate_light_dense(state)
        torch.cuda.synchronize()
        relight_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        frame = render(state, camera)
        return state, passes, snapshot_s, relight_s, frame, (time.perf_counter() - t0) * 1e3

    def warm_frames(state, camera, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            frame = render(state, camera)
        torch.cuda.synchronize()
        return frame, (time.perf_counter() - t0) * 1e3 / reps

    # 4. the first main path: the atrium, through the megakernel
    reset_counts()
    state, passes, snapshot_s, relight_s, frame, first_ms = relight_and_render(atrium_space, cam)
    atrium_counts = read_counts()
    phase("slice", f"atrium {tuple(state.contents.shape)} snapshot {snapshot_s:.3f} s, relit in "
          f"{passes} passes, {relight_s:.3f} s; first 1920x1080 frame {first_ms:.1f} ms; "
          f"launches {atrium_counts}")
    for name in ("relight_pass", "relight_pass_dyn", "trace_megakernel"):
        if atrium_counts[name] <= 0:
            fail(f"atrium main path: {name} was not launched: {atrium_counts}")
    coverage = check_frame(frame, state, "atrium")
    frame, frame_ms = warm_frames(state, cam, 3)
    atrium_frame = frame.data
    save_png(frame, os.path.join(HERE, "aic_tpu_torch", "_build", "atrium_1080p.png"))
    phase("slice", f"atrium 1920x1080 smoothstep: {frame_ms:.1f} ms/frame warm "
          f"({1920 * 1080 / frame_ms / 1e3:.2f} Mrays/s), alpha coverage {coverage:.3f}")
    k1_frame_summary(check_k1_launches(k1_frame_launches(lambda: render(state, cam)), "atrium"), "atrium")
    check_listed_frame(state, *cam.pixel_rays(device=dev), cam.options, "atrium 1920x1080", megakernel=True)
    phase("slice", f"atrium relight stages (ms): {relight_stages(atrium_space, state, dev)}")
    compare_batch(state, "atrium")
    del state

    # 5. the second main path: plaza640, through the v1 kernel
    reset_counts()
    state, passes, snapshot_s, relight_s, frame, first_ms = relight_and_render(plaza_space, plaza_cam)
    plaza_counts = read_counts()
    phase("slice", f"plaza640 {tuple(state.contents.shape)} snapshot {snapshot_s:.3f} s, relit in "
          f"{passes} passes, {relight_s:.3f} s; first 1920x1080 frame {first_ms:.1f} ms; "
          f"launches {plaza_counts}")
    for name in ("relight_pass", "relight_pass_dyn", "trace_v1"):
        if plaza_counts[name] <= 0:
            fail(f"plaza640 main path: {name} was not launched: {plaza_counts}")
    if plaza_counts["trace_megakernel"] != 0:
        fail(f"plaza640 main path went through the megakernel: {plaza_counts}")
    coverage = check_frame(frame, state, "plaza640")
    before = v1.LAUNCHES
    frame, frame_ms = warm_frames(state, plaza_cam, 3)
    per_frame = (v1.LAUNCHES - before) / 3
    save_png(frame, os.path.join(HERE, "aic_tpu_torch", "_build", "plaza640_1080p.png"))
    phase("slice", f"plaza640 1920x1080 smoothstep: {frame_ms:.1f} ms/frame warm "
          f"({1920 * 1080 / frame_ms / 1e3:.2f} Mrays/s), {per_frame:g} v1 launches per frame "
          f"(rounds x phases), alpha coverage {coverage:.3f}")

    # Where a plaza frame's time goes, one stage at a time.
    stages: dict = {}
    po, pd = stage(stages, "pixel_rays", lambda: plaza_cam.pixel_rays(device=dev))
    light, trans, _ = stage(stages, "trace", lambda: tk.trace_rays_kernel(state, po, pd, plaza_cam.options))
    img = stage(stages, "finish", lambda: finish_frame(light, trans, float(plaza_cam.exposure), plaza_cam.options))
    stage(stages, "to_host", lambda: img.cpu())
    # The snapshot's packed cells (skip field included) and the relight's
    # set-up apart from its passes.
    snap = stage(stages, "snapshot", lambda: plaza_space.snapshot(device=dev))
    tb = snap.tables
    vis, vidx, rl2 = (x.cpu().numpy() for x in (tb.visible, tb.voxel_index, tb.res_log2))
    contents_np = plaza_space.contents.astype(np.int32)
    stage(stages, "snapshot_skip_field", lambda: accel.np_skip_distance_field(vis[contents_np]))
    stage(stages, "snapshot_space_cells", lambda: accel.build_trace_cells(
        contents_np, vis, vidx >= 0, rl2, payload=accel.cell_payload(vidx)))
    stages.update(relight_stages(plaza_space, state, dev))
    phase("slice", f"plaza640 stages (ms, one each, synchronized): {stages}")
    rounds = check_v1_rounds(v1_frame_launches(lambda: render(state, plaza_cam)), "plaza640", state)
    check_listed_frame(state, *plaza_cam.pixel_rays(device=dev), plaza_cam.options, "plaza640 1920x1080",
                       megakernel=False)
    phase("slice", f"plaza640 K3 launches of one warm frame: walking rays per round "
          f"{[r[0] for r in rounds]}; launch only (ms) {[round(r[2], 4) for r in rounds]}, sum "
          f"{sum(r[2] for r in rounds):.4f} (in the frame {sum(r[1] for r in rounds):.4f}); bound per frame "
          f"{sum(r[3] for r in rounds):.4f} ms; longest ray per round {[r[5] for r in rounds]} attempts")
    phase("slice", f"plaza640 warm frame under torch.profiler: {profiled_frame(lambda: render(state, plaza_cam))}")
    phase("kernels", f"trace_v1 at the atrium 1920x1080 launch state: {trace_v1_atrium[1]:.3f} ms "
          f"(plain {trace_v1_atrium[2]:.3f} ms, bound {trace_v1_atrium[3]:.4f} ms)")
    compare_batch(state, "plaza640")
    del state

    # 6. the step loop: the device tick against the host path, then the
    # atrium and plaza640 stepped through Universe.step, each followed by
    # a frame (K1, K3).
    check_device_tick_vs_host(dev)
    steps = {}
    for name, camera, trace_kernel in (("atrium", cam, "trace_megakernel"), ("plaza640", plaza_cam, "trace_v1")):
        steps[name] = step_world(name, camera, dev, reset_counts, read_counts)
        c = steps[name]["counts"]
        if c["relight_batch"] <= 0 or c[trace_kernel] <= 0:
            fail(f"step {name}: the main path launched no {'relight_batch' if c['relight_batch'] <= 0 else trace_kernel}: {c}")
        phase("step", f"{name}: {c['relight_batch'] / steps[name]['ticks']:.2f} K2 listed launches a tick")

    # 7. demo-city: built, relit, rendered, stepped and rendered again.
    city = city_world(dev, opts, reset_counts, read_counts)

    # 8. the render API and the general tracer.
    rendered = render_world(dev, opts, smi, reset_counts, read_counts)

    # 9. the interactive session: demo-city with its HUD, served.
    session = session_world(dev, smi, reset_counts, read_counts)

    # 10. the record and export path: glTF, STL, APNG, the chunked mesh,
    # audio and the reference relight.
    universe = session["session"].universe
    recorded = record_world(dev, smi, reset_counts, read_counts, session.pop("session"))

    # 11. the multi-GPU paths and the reference's .alliscubesjson.
    multi = multi_gpu_world(dev, smi, opts, universe)

    # 12. the reference-procedure relight and one whole-volume round.
    reference = reference_world(dev, smi, reset_counts, read_counts)

    # 13. the goldens: frames, light and transactions held to aic_tpu's.
    goldens = goldens_world(dev, smi, reset_counts, read_counts,
                            {"atrium": atrium_space, "plaza640": plaza_space}, atrium_frame)

    if "PIL" in sys.modules:
        fail("PIL was imported during the run: the port draws text from its glyph table alone")
    counts = {k: atrium_counts[k] + plaza_counts[k] + city["counts"][k] + rendered["counts"][k]
              + session["counts"][k] + recorded["counts"][k] + multi["counts"].get(k, 0)
              + reference["counts"][k] + goldens["counts"][k] for k in atrium_counts}
    counts["relight_batch"] = (sum(st["counts"]["relight_batch"] for st in steps.values())
                               + city["counts"]["relight_batch"] + session["counts"]["relight_batch"]
                               + recorded["counts"]["relight_batch"] + multi["counts"].get("relight_batch", 0)
                               + reference["counts"]["relight_batch"] + goldens["counts"]["relight_batch"])
    rows = [
        ("trace_megakernel", "aic_tpu_torch/csrc/trace.cu", "aic_tpu/raytrace/pallas_trace.py:1140", city["k1"]),
        ("relight_pass", "aic_tpu_torch/csrc/relight.cu", "aic_tpu/light/pallas_relight.py:338",
         relight["relight_pass"]),
        ("relight_pass_dyn", "aic_tpu_torch/csrc/relight.cu", "aic_tpu/light/pallas_relight.py:338",
         relight["relight_pass_dyn"]),
        ("trace_v1", "aic_tpu_torch/csrc/trace_v1.cu", "aic_tpu/raytrace/pallas_trace.py:198", trace_v1),
        ("relight_batch", "aic_tpu_torch/csrc/relight.cu", "aic_tpu/light/pallas_relight.py:338",
         steps["atrium"]["batch"][:5]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        for name, source, replaces, (err, ms, plain_ms, b_ms, b_by) in rows
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
