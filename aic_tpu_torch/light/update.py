"""The incremental light queue: relight a batch of cubes, one queue round,
and the strategy switch to convergence.

Port of `aic_tpu/light/update.py` (the reference's light updater,
all-is-cubes/src/space/light/updater.rs). The queue is the per-cube
priority field `light_dirty`: a round selects the dirtiest cubes,
relights them, scatters the results and re-enqueues the neighbours of
cubes whose light moved by more than one packed step (updater.rs:340).
`evaluate_light` takes the dense Jacobi passes (`dense.py`) when more
than 2% of the volume is dirty and the queue below that.

`relight_batch` is `compute_light` (updater.rs:362) for a batch of
cubes. On the card it is one launch of K2's listed kernel
(`csrc/relight.cu`, `relight_kernel.relight_listed_cuda`), which walks
the chart rays of every batch row with the dense pass's step and reads
the state's packed light: `aic_tpu` states that its dense pass gives per
cube the results of `relight_batch` (dense.py:388-391). On the CPU it is
the plain version, a straight port of `aic_tpu`'s masked walk over the
chart steps (update.py:101-277). A CUDA tensor never takes the plain
walk.

A queue round reads nothing back and copies nothing from the host: on
the card it is a fixed sequence of launches. `evaluate_light` captures
it once as a CUDA graph over static buffers (`RoundGraph`) and replays
it, reading back only the round's two counts; on the CPU it runs the
round eagerly, with the same one read-back a round.

Selection is `aic_tpu`'s two-stage top-k (update.py:293-316). `lax.top_k`
returns the lower index first among equal values, and `torch.topk` makes
no promise on ties, which are common because priorities are u8: every
stage here selects on a composite integer key, the priority in the high
digits and the inverted index in the low ones, so that it picks exactly
what `aic_tpu` picks.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch

from .. import profiling
from ..math import faces, lightpack
from ..space.state import SpaceState, in_bounds_mask, lookup_contents
from . import relight_kernel
from .chart import STEP_END, STEP_PAD, build_chart
from .dense import device_pair_tables, finish
from .relight_kernel import build_face_mask, relight_listed_cuda

#: `evaluate_light` takes the dense passes above this share of dirty
#: cubes (update.py:388), the queue below it.
DENSE_THRESHOLD = 0.02


@functools.lru_cache(maxsize=8)
def _chart_host(max_distance: int) -> dict:
    """The chart tables as numpy arrays (update.py:47-61)."""
    ch = build_chart(max_distance)
    return dict(
        offsets=np.asarray(ch["offsets"], np.int64),
        faces_in=np.asarray(ch["faces_in"], np.int64),
        kinds=np.asarray(ch["kinds"], np.int64),
        cosines=np.asarray(ch["cosines"], np.float32),
        n_rays=ch["n_rays"],
        max_steps=ch["max_steps"],
    )


@functools.lru_cache(maxsize=16)
def _chart_device(max_distance: int, device: torch.device) -> dict:
    ch = _chart_host(max_distance)
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v for k, v in ch.items()}


@functools.lru_cache(maxsize=16)
def _face_constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The six face normals i64[6,3] and each face's opposite i64[6] on
    `device`, made once: a round copies nothing from the host."""
    return (torch.as_tensor(faces.FACE_NORMALS[:6], dtype=torch.int64, device=device),
            torch.as_tensor(faces.OPPOSITE[:6], dtype=torch.int64, device=device))


def _gather_light_rgb(state: SpaceState, pos: torch.Tensor) -> torch.Tensor:
    """Stored light at positions (..., 3), decoded; outside the bounds the
    sky's face light where the position touches exactly one face of the
    volume, else 0 (sky.rs:96 `light_outside`)."""
    X, Y, Z = state.contents.shape
    size = torch.as_tensor((X, Y, Z), dtype=pos.dtype, device=pos.device)
    inside = ((pos >= 0) & (pos < size)).all(-1)
    pc = torch.minimum(pos.clamp(min=0), size - 1)
    flat = (pc[..., 0] * Y + pc[..., 1]) * Z + pc[..., 2]
    stored = lightpack.decode_rgb(state.light.reshape(-1, 4)[flat])
    at_lower = pos == -1
    at_upper = pos == size
    outside = (pos < 0) | (pos >= size)
    touching = (outside.sum(-1) == 1) & ((at_lower | at_upper).sum(-1) == 1)
    face_idx = torch.argmax(torch.cat([at_lower, at_upper], dim=-1).to(torch.int32), dim=-1)
    sky = state.sky_faces[face_idx]
    return torch.where(inside[..., None], stored, torch.where(touching[..., None], sky, torch.zeros_like(sky)))


@dataclasses.dataclass(frozen=True)
class Origins:
    """What a batch's origin cubes give a relight (update.py:124-162):
    ray weights per face, the root step's alpha and incoming light, and
    what `finish` needs."""

    dir_weights: torch.Tensor  # f32[B,6]
    alpha0: torch.Tensor  # f32[B]
    incoming0: torch.Tensor  # f32[B,3]
    origin_opaque: torch.Tensor  # bool[B]
    origin_emission: torch.Tensor  # f32[B,3]


def _origins(state: SpaceState, cubes: torch.Tensor, cosines: torch.Tensor) -> Origins:
    t = state.tables
    idx0, _ = lookup_contents(state, cubes)
    idx0 = idx0.long()
    origin_opaque = t.opaque_faces[idx0].all(-1)
    origin_visible = t.visible[idx0]
    origin_emission = t.light_emission[idx0]
    mean_alpha = t.face_colors[idx0, 6, 3].clamp(0.0, 1.0)

    # directions_to_seek_light (updater.rs:663).
    normals, opp = _face_constants(cubes.device)
    nidx, _ = lookup_contents(state, cubes[:, None, :] + normals[None])
    nidx = nidx.long()
    n_visible = t.visible[nidx]
    n_emissive = (t.light_emission[nidx] != 0).any(-1)
    one = torch.ones_like(n_emissive, dtype=torch.float32)
    dir_weights = torch.where(
        origin_visible[:, None], one, torch.where(n_visible[:, opp] | n_emissive, one, 0.0 * one)
    )
    ray_w = dir_weights @ cosines.T  # [B,R]

    root_pickup = origin_visible & ~origin_opaque & (mean_alpha < 1.0)
    root_contrib = torch.where(root_pickup[:, None], origin_emission, torch.zeros_like(origin_emission))
    alpha0 = torch.where(root_pickup, 1.0 - mean_alpha, torch.ones_like(mean_alpha))
    return Origins(dir_weights, alpha0, root_contrib * ray_w.sum(-1, keepdim=True),
                   origin_opaque, origin_emission)


def relight_batch_plain(state: SpaceState, cubes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The plain version of `relight_batch`: `aic_tpu`'s masked walk over
    the chart steps for all (cube, ray) pairs at once (update.py:101-277)."""
    dev = cubes.device
    cubes = cubes.to(torch.int64)
    ch = _chart_device(state.light_max_distance, dev)
    rows = state.tables.light_face_rows
    n_rays = ch["n_rays"]
    b = cubes.shape[0]
    org = _origins(state, cubes, ch["cosines"])
    ray_w = org.dir_weights @ ch["cosines"].T  # [B,R]
    sky_ray = (ch["cosines"] @ state.sky_faces) / ch["cosines"].sum(-1)[:, None]  # [R,3]

    alpha = org.alpha0[:, None].expand(b, n_rays).clone()
    live = (ray_w > 0.0) & (alpha > 0.0)
    incoming = org.incoming0.clone()
    total_w = torch.zeros((b, n_rays), dtype=torch.float32, device=dev)
    # The light of the cube a step enters from: the origin's at step 0.
    prev_own = _gather_light_rgb(state, cubes)[:, None, :].expand(b, n_rays, 3)
    s = 0
    while s < ch["max_steps"] and bool(live.any()):
        off, f_in, kind = ch["offsets"][:, s], ch["faces_in"][:, s], ch["kinds"][:, s]
        pos = cubes[:, None, :] + off[None]
        idx, inside = lookup_contents(state, pos)
        row = rows[idx.long() * 6 + f_in[None, :]]
        fc = row[..., 0:4]
        flags = row[..., 4]
        opaque_f = torch.remainder(flags, 2.0) >= 1.0
        visible = flags >= 2.0
        emission = row[..., 5:8]
        active = live & (kind != STEP_PAD)[None]
        exits = active & ((kind == STEP_END)[None] | ~inside)
        hit_alpha = fc[..., 3].clamp(0.0, 1.0)
        interacting = active & ~exits & visible

        # Struck face: reflect the light behind it, the cube the ray came from.
        struck = interacting & (hit_alpha > 0.0)
        light_struck = emission + fc[..., :3].clamp(0.0, 1.0) * prev_own * hit_alpha[..., None]
        zero3 = torch.zeros_like(light_struck)
        contrib = torch.where(struck[..., None], light_struck * (alpha * ray_w)[..., None], zero3)
        hit_opaque = struck & opaque_f
        alpha = torch.where(struck & ~hit_opaque, alpha * (1.0 - hit_alpha), alpha)

        # Pass through: pick up the cube's own light.
        through = interacting & (hit_alpha < 1.0) & ~hit_opaque
        own_light = _gather_light_rgb(state, pos)
        light_through = emission + own_light * hit_alpha[..., None]
        contrib = contrib + torch.where(through[..., None], light_through * (alpha * ray_w)[..., None], zero3)
        alpha = torch.where(through, alpha * (1.0 - hit_alpha), alpha)

        alpha = torch.where(hit_opaque, torch.zeros_like(alpha), alpha)
        ends_now = exits | hit_opaque | (active & (alpha <= 0.0) & ~exits)
        contrib = contrib + torch.where(
            ends_now[..., None], sky_ray[None] * (alpha * ray_w)[..., None], zero3
        )
        total_w = total_w + torch.where(ends_now, ray_w, torch.zeros_like(ray_w))
        live = live & ~ends_now
        incoming = incoming + contrib.sum(1)
        prev_own = own_light
        s += 1

    out = finish(org.origin_opaque, org.origin_emission, incoming, total_w.sum(-1))
    return torch.where(valid[:, None], out, torch.zeros_like(out))


#: id(state.contents) → (weakrefs to it and to the face rows, mask): K2's
#: visibility mask for the batches of one contents tensor. An edit or a
#: device tick makes new contents, and so a new mask, never a stale one.
_FACE_MASKS: dict = {}


def batch_face_mask(state: SpaceState) -> torch.Tensor:
    """K2's visibility mask of the state's contents and face rows, built
    on its device once per contents tensor."""
    hit = _FACE_MASKS.get(id(state.contents))
    if hit is not None and hit[0]() is state.contents and hit[1]() is state.tables.light_face_rows:
        return hit[2]
    return _keep_face_mask(state, build_face_mask(state.contents, state.tables.light_face_rows))


def _keep_face_mask(state: SpaceState, mask: torch.Tensor) -> torch.Tensor:
    """Make `mask` what `batch_face_mask` gives for the state's contents."""
    if len(_FACE_MASKS) >= 8:
        _FACE_MASKS.pop(next(iter(_FACE_MASKS)))
    _FACE_MASKS[id(state.contents)] = (weakref.ref(state.contents), weakref.ref(state.tables.light_face_rows), mask)
    return mask


def listed_inputs(state: SpaceState, cubes: torch.Tensor, valid: torch.Tensor):
    """What `relight_listed_cuda` takes for a batch, and the batch's
    origins: (args, origins). Rows that are padding, opaque or fully
    absorbing at the root get zero ray weights, so they walk no ray. The
    light goes as the state holds it, packed: the kernel decodes the
    texels it reads."""
    pairs = device_pair_tables(state)
    cubes = cubes.to(torch.int64)
    org = _origins(state, cubes, pairs.cosines)
    walked = valid & (org.alpha0 > 0.0) & ~org.origin_opaque
    dw = torch.where(walked[:, None], org.dir_weights, torch.zeros_like(org.dir_weights)).contiguous()
    X, Y, Z = state.contents.shape
    flat = (cubes[:, 0].clamp(0, X - 1) * Y + cubes[:, 1].clamp(0, Y - 1)) * Z + cubes[:, 2].clamp(0, Z - 1)
    args = (state.contents, state.light.contiguous(), state.tables.light_face_rows, batch_face_mask(state),
            pairs, flat.to(torch.int32), dw, org.alpha0.contiguous())
    return args, org


def relight_batch_cuda(state: SpaceState, cubes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """`relight_batch` on the card: `relight_listed_batch`, except that a
    batch whose every row is padding gives zeros and launches nothing;
    finding that out reads back from the card. The queue round calls
    `relight_listed_batch` and reads nothing back."""
    with profiling.wait("light.any_valid"):
        any_valid = bool(valid.any())
    if not any_valid:
        return torch.zeros((cubes.shape[0], 4), dtype=torch.uint8, device=cubes.device)
    return relight_listed_batch(state, cubes, valid)


def relight_listed_batch(state: SpaceState, cubes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One launch of K2's listed kernel over the batch, padding rows
    included (they walk no ray and give 0), then `finish`, which gives the
    rows that walked no ray their status, as `aic_tpu`'s walk does.
    Reads nothing back."""
    args, org = listed_inputs(state, cubes, valid)
    incoming, total = relight_listed_cuda(*args)
    out = finish(org.origin_opaque, org.origin_emission, incoming + org.incoming0, total)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def relight_batch(state: SpaceState, cubes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """New packed light u8[B,4] for a batch of cubes (index-space i32[B,3];
    rows with `valid` false give 0 and cost no walk on the card): K2 for a
    state on the card, the plain walk for one on the CPU."""
    dev = state.contents.device
    if dev.type == "cuda":
        return relight_batch_cuda(state, cubes, valid)
    if dev.type == "cpu":
        return relight_batch_plain(state, cubes, valid)
    raise ValueError(f"no relight for device {dev}")


def _topk_first(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of the non-negative integers `values` along
    the last axis, largest first and the lower index first among equals,
    as `lax.top_k` orders them: one `torch.topk` on the key value·L +
    (L−1−index), whose entries are all distinct."""
    L = values.shape[-1]
    inv = torch.arange(L - 1, -1, -1, dtype=torch.int64, device=values.device)
    return torch.topk(values.to(torch.int64) * L + inv, k, dim=-1).indices


def batch_shape(n: int, batch_size: int) -> tuple[int, int, int]:
    """The shape of a round's batch over a volume of n cubes: (rows k,
    128-cube rows picked kr, cubes picked from each m)."""
    k = min(batch_size, n)
    kr = min(k, -(-n // 128))
    m = -(-k // kr) if kr * 4 < k else 4  # tiny volumes: deepen per-row picks
    m = min(m, 128)
    return min(k, kr * m), kr, m


def select_batch(light_dirty: torch.Tensor, batch_size: int):
    """A round's batch (update.py:286-324): the two-stage selection over
    128-cube rows. Returns (positions i64[k,3], valid bool[k], flat i64[k])."""
    X, Y, Z = light_dirty.shape
    flat_dirty = light_dirty.reshape(-1)
    n = flat_dirty.shape[0]
    k, kr, m = batch_shape(n, batch_size)
    if n % 128:
        flat_dirty = torch.cat([flat_dirty, flat_dirty.new_zeros(128 - n % 128)])
    rows2 = flat_dirty.reshape(-1, 128).to(torch.int64)
    rsel = _topk_first(rows2.amax(dim=1), kr)
    cand = rows2[rsel]  # [kr,128]
    coff = _topk_first(cand, m)  # [kr,m]
    cprio = cand.gather(1, coff)
    cpos = rsel[:, None] * 128 + coff
    ci = _topk_first(cprio.reshape(-1), k)
    prio = cprio.reshape(-1)[ci]
    flat_pos = torch.clamp(cpos.reshape(-1)[ci], max=n - 1)
    pos = torch.stack([flat_pos // (Y * Z), (flat_pos // Z) % Y, flat_pos % Z], dim=-1)
    return pos, prio > 0, flat_pos


def light_update_round(state: SpaceState, batch_size: int = 256):
    """One queue round (update.py:280-367): select the dirtiest cubes,
    relight them, scatter, clear them and re-enqueue the neighbours of
    cubes whose light changed by more than one step. Returns (state,
    stats), the stats as tensors on the state's device (updated,
    max_diff, queue_remaining). The round reads nothing back and copies
    nothing from the host: on the card its relight is one listed launch
    over the whole batch, padding rows included, so that the round can
    be captured as a CUDA graph (`RoundGraph`). A caller that knows the
    queue is empty skips the round (`queue_known_empty`): an all-padding
    batch changes nothing.

    Writes go through a copy of the volume with one spare element past
    its end, which takes the rows that must write nothing (padding rows,
    neighbours outside the bounds), so the scatters need no host-side
    filtering and no row's write can land on another's cube."""
    with profiling.span("light.round"):
        shape = state.contents.shape
        n = state.contents.numel()
        with profiling.span("light.select"):
            pos, valid, flat = select_batch(state.light_dirty, batch_size)
        with profiling.span("light.relight"):
            if state.contents.device.type == "cuda":
                new_light = relight_listed_batch(state, pos, valid)
            else:
                new_light = relight_batch(state, pos, valid)
        with profiling.span("light.scatter"):
            old_light = state.light.reshape(-1, 4)[flat]
            diff = lightpack.difference_priority(old_light, new_light)

            target = torch.where(valid, flat, n)
            light = torch.cat([state.light.reshape(-1, 4), state.light.new_zeros((1, 4))])
            light[target] = new_light
            dirty = torch.cat([state.light_dirty.reshape(-1), state.light_dirty.new_zeros(1)]).to(torch.int32)
            dirty.index_fill_(0, target, 0)
            npos = pos[:, None, :] + _face_constants(pos.device)[0][None]
            nflat = torch.where(in_bounds_mask(state, npos),
                                (npos[..., 0] * shape[1] + npos[..., 1]) * shape[2] + npos[..., 2], n)
            nprio = torch.where(valid & (diff > 1), torch.clamp(diff, max=255), 0)
            dirty.scatter_reduce_(0, nflat.reshape(-1), nprio[:, None].expand(-1, 6).reshape(-1), "amax")
            dirty = dirty[:n].to(torch.uint8).reshape(shape)

        new_state = dataclasses.replace(state, light=light[:n].reshape(state.light.shape), light_dirty=dirty)
        stats = dict(
            updated=valid.sum(),
            max_diff=torch.where(valid, diff, 0).max(),
            queue_remaining=(dirty > 0).sum(),
        )
        return new_state, stats


def _table_tensors(tables) -> list:
    return [getattr(tables, f.name) for f in dataclasses.fields(tables)]


@functools.lru_cache(maxsize=8)
def _capture_stream(device: torch.device):
    """The side stream on which `device`'s round graphs are captured."""
    return torch.cuda.Stream(device)


class RoundGraph:
    """`light_update_round` on the card, captured once as a CUDA graph over
    static buffers that hold a state's contents, packed light, queue and
    K2's face mask. `load` copies a state into them; each `replay` runs
    one round on them, writes its light and queue back into them and
    (updated, queue remaining) into `counts`; `result` gives the state
    with copies of the buffers' light and queue, so that no state aliases
    a buffer that a later call overwrites.

    A graph serves the states of its device, volume shape and batch size
    that have the palette tables and pair tables it was captured with
    (`fits`), which it follows by weakrefs: an edit changes only what
    `load` copies. It holds the listed kernel's tickets and decode table,
    which it reads at every replay; the tickets are those of the capture
    stream, 0 before and after each replay as before and after a launch.
    The face mask buffer is `batch_face_mask`'s for the static contents,
    so the captured round reads it as an eager round reads its mask."""

    def __init__(self, state: SpaceState, batch_size: int):
        dev = state.contents.device
        buffer = functools.partial(torch.empty_like, memory_format=torch.contiguous_format)
        self.contents = buffer(state.contents)
        self.light = buffer(state.light)
        self.dirty = buffer(state.light_dirty)
        self.face_mask = buffer(batch_face_mask(state))
        self.counts = torch.zeros(2, dtype=torch.int64, device=dev)
        self._tables = [weakref.ref(t) for t in _table_tensors(state.tables)]
        self._pairs = weakref.ref(device_pair_tables(state))
        self.load(state)
        static = dataclasses.replace(state, contents=self.contents, light=self.light, light_dirty=self.dirty)
        _keep_face_mask(static, self.face_mask)
        rows = batch_shape(state.light_dirty.numel(), batch_size)[0]
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # What a round makes on first use (K2's library, its decode
            # table, the stream's tickets, the constants) is made outside
            # the capture, by one round whose result is dropped.
            light_update_round(static, batch_size)
            self._held = (relight_kernel._tickets(dev, rows), relight_kernel.decode_table(dev))
        before = relight_kernel.LAUNCHES_LISTED
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            new, stats = light_update_round(static, batch_size)
            self.light.copy_(new.light)
            self.dirty.copy_(new.light_dirty)
            torch.stack((stats["updated"], stats["queue_remaining"]), out=self.counts)
        # A capture launches nothing: each replay launches what it recorded.
        self.launches = relight_kernel.LAUNCHES_LISTED - before
        relight_kernel.LAUNCHES_LISTED = before
        torch.cuda.current_stream(dev).wait_stream(stream)
        if self.launches != 1:
            raise RuntimeError(f"a captured queue round holds {self.launches} listed launches, not 1")

    def fits(self, state: SpaceState) -> bool:
        return self._pairs() is device_pair_tables(state) and all(
            ref() is t for ref, t in zip(self._tables, _table_tensors(state.tables)))

    def live(self) -> bool:
        """Whether its tables and pair tables still exist: a graph whose
        tables died fits no state again."""
        return self._pairs() is not None and all(ref() is not None for ref in self._tables)

    def load(self, state: SpaceState) -> None:
        self.contents.copy_(state.contents)
        self.light.copy_(state.light)
        self.dirty.copy_(state.light_dirty)
        self.face_mask.copy_(batch_face_mask(state))

    def replay(self) -> torch.Tensor:
        """One round on the buffers; returns `counts`, not read back."""
        self.graph.replay()
        relight_kernel.LAUNCHES_LISTED += self.launches
        profiling.count("light.graph_rounds")
        return self.counts

    def result(self, state: SpaceState) -> SpaceState:
        return dataclasses.replace(state, light=self.light.clone(), light_dirty=self.dirty.clone())


#: (device, volume shape, batch size) → its `RoundGraph`, the most recently
#: used last.
_ROUND_GRAPHS: dict = {}


def round_graph(state: SpaceState, batch_size: int) -> RoundGraph:
    """The `RoundGraph` for a state on the card: captured on first use, and
    again for new palette tables (a palette that grew) or pair tables (a
    new sky), counted in `light.graph_captures`."""
    for dead in [k for k, g in _ROUND_GRAPHS.items() if not g.live()]:
        del _ROUND_GRAPHS[dead]
    key = (state.contents.device, tuple(state.contents.shape), batch_size)
    graph = _ROUND_GRAPHS.pop(key, None)
    if graph is None or not graph.fits(state):
        graph = None  # its memory goes back before the new capture
        if len(_ROUND_GRAPHS) >= 4:
            _ROUND_GRAPHS.pop(next(iter(_ROUND_GRAPHS)))
        graph = RoundGraph(state, batch_size)
        profiling.count("light.graph_captures")
    _ROUND_GRAPHS[key] = graph
    return graph


#: id(light_dirty) → (weakref to it, how many cubes it marks: an int, or
#: a pinned host tensor and the event after which the card has written
#: the count into it).
_QUEUE_COUNTS: dict = {}


def note_queue(state: SpaceState, remaining) -> None:
    """Remember how many cubes the state's queue marks, for
    `queue_known_empty`: `remaining` is an int, or a round's count as a
    tensor, which on the card is copied to the host without waiting. A
    state's tensors are never written in place, so the count holds for
    as long as its `light_dirty` lives."""
    if isinstance(remaining, torch.Tensor):
        if remaining.device.type == "cuda":
            host = torch.empty((), dtype=remaining.dtype, pin_memory=True)
            host.copy_(remaining, non_blocking=True)
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(remaining.device))
            remaining = (host, written)
        else:
            remaining = int(remaining)
    for dead in [k for k, v in _QUEUE_COUNTS.items() if v[0]() is None]:
        del _QUEUE_COUNTS[dead]
    _QUEUE_COUNTS[id(state.light_dirty)] = (weakref.ref(state.light_dirty), remaining)


def queue_known_empty(state: SpaceState) -> bool:
    """Whether the state's queue is known to mark no cube, so that a round
    would select only padding and change nothing: its `light_dirty` is
    one that `note_queue` counted 0. Never waits for the card: a count
    still on its way reads as not known."""
    hit = _QUEUE_COUNTS.get(id(state.light_dirty))
    if hit is None or hit[0]() is not state.light_dirty:
        return False
    count = hit[1]
    if isinstance(count, tuple):
        host, written = count
        if not written.query():
            return False
        count = int(host)
        _QUEUE_COUNTS[id(state.light_dirty)] = (hit[0], count)
    return count == 0


def evaluate_light(state: SpaceState, batch_size: int = 256, max_rounds: int = 100000):
    """Relight to convergence (space.rs:1494 `evaluate_light`): the dense
    passes when more than DENSE_THRESHOLD of the volume is dirty, the
    queue rounds otherwise. Returns (state, cubes updated): a dense
    relight counts every cube once per pass. On the card the rounds are
    replays of the state's `RoundGraph` (counted in `light.graph_rounds`),
    on the CPU eager rounds; either way the host reads back one pair of
    counts a round, (updated, queue remaining), and stops at an empty
    queue or after `max_rounds`. Counts the queue's rounds
    (`light.rounds`), the rows its batches launch (`light.rows_launched`)
    and the cubes they relit (`light.rows_relit`) in `profiling`, and
    notes the queue it leaves (`note_queue`)."""
    from .dense import evaluate_light_dense

    with profiling.span("light.evaluate"):
        if not state.light_enabled:
            return state, 0
        with profiling.wait("light.n_dirty"):
            n_dirty = int((state.light_dirty > 0).sum())
        if n_dirty > DENSE_THRESHOLD * state.light_dirty.numel():
            state, passes = evaluate_light_dense(state)
            note_queue(state, 0)
            return state, passes * state.light_dirty.numel()
        rows = batch_shape(state.light_dirty.numel(), batch_size)[0]
        graph = None
        if state.contents.device.type == "cuda":
            graph = round_graph(state, batch_size)
            graph.load(state)
        total_updated, remaining = 0, n_dirty
        for _ in range(max_rounds):
            if graph is None:
                state, stats = light_update_round(state, batch_size=batch_size)
                counts = torch.stack((stats["updated"], stats["queue_remaining"]))
            else:
                counts = graph.replay()
            with profiling.wait("light.counts"):
                updated, remaining = counts.tolist()
            total_updated += updated
            profiling.count("light.rounds")
            profiling.count("light.rows_launched", rows)
            profiling.count("light.rows_relit", updated)
            if remaining == 0:
                break
        if graph is not None:
            state = graph.result(state)
        note_queue(state, remaining)
        return state, total_updated
