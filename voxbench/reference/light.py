"""The reference light: all-is-cubes' light equation, written plainly.

A cube's light is what reaches it along a fixed chart of rays: one ray
from the cube's centre toward each cube on the surface of the 11^3
lattice around it (602 rays), each ray weighted by the cosines between
its direction and the faces from which the cube seeks light, walked cube
by cube to the light's maximum distance. Along a ray, a visible face of
a cube it enters reflects the light stored in the cube behind that face,
tinted by the face's colour and scaled by its opacity; a partly clear
cube adds its own stored light; each passes on what its opacity leaves;
an opaque face ends the ray, and a ray that leaves the world or its
distance ends on the sky. The sum over rays, over their weight, is the
cube's light, stored as a logarithmic 8-bit code per channel with a
status byte (`encode`).

`light_pass` applies the equation once to every cube, reading only the
light given to it: a light field the program settled is a fixpoint of
it, to within the codes its stopping rule leaves, and a field that is
stale, half done or altered is not. `relight` iterates it (Jacobi) to
that fixpoint. Everything here is written from the equation, not taken
from the program; the world's blocks are decoded by the copy in
`reference/plain/` (`world.py`).

With `precision="lower"` (the control) each pass sums in bfloat16 and
keeps 4-bit codes: the step below what the configuration states.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Log scale of a light code: code = round(log2(v) * 10 + 144), 0 for 0.
CODE_SCALE = 10.0
CODE_OFFSET = 144.0
STATUS_NO_RAYS = 1
STATUS_OPAQUE = 128
STATUS_VISIBLE = 255

#: Faces in the order NX, NY, NZ, PX, PY, PZ, and their outward normals.
NORMALS = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.int64)
OPPOSITE = (3, 4, 5, 0, 1, 2)
#: The lattice whose surface the chart's rays point at: -5..5 on each axis.
LATTICE = 5
#: The longest a chart ray is cast, in ray lengths, before its distance ends it.
CHART_T_CAP = 127.0
#: (cube, ray, step) entries walked at once.
STEPS_AT_ONCE = 1 << 22


def encode(v: torch.Tensor) -> torch.Tensor:
    """Linear light (>= 0) to its 8-bit code; 0 and below give 0."""
    v = torch.clamp(v.to(torch.float32), min=0.0)
    code = torch.round(torch.log2(v) * CODE_SCALE + CODE_OFFSET)
    code = torch.nan_to_num(code, nan=0.0, neginf=0.0, posinf=255.0)
    return torch.clamp(code, 0, 255).to(torch.uint8)


def decode(code: torch.Tensor) -> torch.Tensor:
    """An 8-bit code to linear light."""
    c = code.to(torch.float32)
    return torch.where(c == 0, torch.zeros_like(c), torch.exp2((c - CODE_OFFSET) / CODE_SCALE))


def codes_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per cube: the largest difference of two packed lights' colour codes,
    255 where their status differs."""
    a = a.to(torch.int32)
    b = b.to(b.device if a.device == b.device else a.device).to(torch.int32)
    d = (a[..., :3] - b[..., :3]).abs().amax(-1)
    return torch.where(a[..., 3] != b[..., 3], torch.full_like(d, 255), d)


# -- the chart ---------------------------------------------------------------------


def ray_directions() -> tuple[np.ndarray, np.ndarray]:
    """(unit directions f64[R,3], face cosines f32[R,6]) of the chart's rays,
    in lattice order (x, then y, then z, each from -5 up). A direction is
    normalised in float32 and only then widened, as upstream does: the
    low bits decide which cube a near-diagonal ray enters on a tie."""
    out = []
    r = range(-LATTICE, LATTICE + 1)
    for x in r:
        for y in r:
            for z in r:
                if LATTICE in (abs(x), abs(y), abs(z)):
                    v = np.array([x, y, z], np.float32)
                    out.append((v / np.float32(np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]))).astype(np.float64))
    d = np.stack(out)
    cos = np.maximum(d.astype(np.float32) @ NORMALS.astype(np.float32).T, np.float32(0.0))
    return d, cos.astype(np.float32)


def cast(direction: np.ndarray, max_distance: int) -> list:
    """The cubes a ray from the centre of cube (0, 0, 0) enters, in order:
    [(cube offset, face of the cube it enters through, ends)]. The walk
    steps to whichever cube boundary is nearest along the ray, on a tie
    preferring z, then y, to x. A cube whose centre lies farther than
    `max_distance` from the origin's ends the ray without being visited
    (the sky), as does the end of the cast."""
    step = np.sign(direction).astype(np.int64)
    with np.errstate(divide="ignore"):
        delta = np.where(direction != 0.0, np.abs(1.0 / direction), np.inf)
    t_next = 0.5 * delta  # from a cube's centre, half a cube to each boundary
    cube = np.zeros(3, np.int64)
    t_cap = min(CHART_T_CAP, 2.0 * max_distance)
    out = []
    while True:
        if t_next[0] < t_next[1]:
            axis = 0 if t_next[0] < t_next[2] else 2
        else:
            axis = 1 if t_next[1] < t_next[2] else 2
        if t_next[axis] > t_cap:
            break
        cube[axis] += step[axis]
        t_next[axis] += delta[axis]
        face = axis if step[axis] > 0 else axis + 3
        if int((cube * cube).sum()) > max_distance * max_distance:
            out.append((cube.copy(), face, True))
            return out
        out.append((cube.copy(), face, False))
    last = out[-1][0] if out else np.zeros(3, np.int64)
    out.append((last, 0, True))
    return out


@functools.lru_cache(maxsize=4)
def chart(max_distance: int) -> dict:
    """The chart as arrays over rays R and steps S: `off` i64[R,S,3], `face`
    i64[R,S], `end` bool[R,S] (padding after a ray's end is an end too),
    `cos` f32[R,6]."""
    dirs, cos = ray_directions()
    walks = [cast(d, max_distance) for d in dirs]
    steps = max(len(w) for w in walks)
    off = np.zeros((len(walks), steps, 3), np.int64)
    face = np.zeros((len(walks), steps), np.int64)
    end = np.ones((len(walks), steps), bool)
    for r, w in enumerate(walks):
        for s, (c, f, e) in enumerate(w):
            off[r, s], face[r, s], end[r, s] = c, f, e
    return {"off": off, "face": face, "end": end, "cos": cos}


@functools.lru_cache(maxsize=4)
def _chart_on(max_distance: int, device: str):
    """The chart's (off, face, end, cos, steps of each ray) as tensors on
    `device`."""
    ch = chart(max_distance)
    length = torch.as_tensor(ch["end"].argmax(1) + 1, device=device)
    return tuple(torch.as_tensor(ch[k], device=device) for k in ("off", "face", "end", "cos")) + (length,)


# -- the pass ----------------------------------------------------------------------


def _shifted(vol: torch.Tensor, d) -> torch.Tensor:
    """out[c] = vol[c + d], False outside the volume."""
    out = torch.zeros_like(vol)
    src, dst = [], []
    for a in range(3):
        n, size = int(d[a]), vol.shape[a]
        src.append(slice(max(n, 0), size + min(n, 0)))
        dst.append(slice(max(-n, 0), size - max(n, 0)))
    out[tuple(dst)] = vol[tuple(src)]
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def light_pass(world, light: torch.Tensor, precision: str = "float32", cubes=None) -> torch.Tensor:
    """Every cube's packed light u8[X,Y,Z,4] from one application of the
    equation to `light` (packed u8[X,Y,Z,4]) in `world` (`World`, on the
    device of `light`); with `cubes` (flat indices i64[k]) only theirs,
    u8[k,4]."""
    if precision not in ("float32", "lower"):
        raise ValueError(precision)
    dev = light.device
    blocks = world.contents.to(dev).long()
    X, Y, Z = blocks.shape
    V = X * Y * Z
    t = world.tables(dev)
    off, face, end, cos, length = _chart_on(world.max_distance, str(dev))
    sky_faces = t["sky_faces"]
    sky_ray = (cos @ sky_faces) / cos.sum(-1, keepdim=True)

    # The origin cube: which directions it seeks light from, its own
    # pickup when it is partly clear, and whether it is opaque.
    visible = t["visible"][blocks]
    emission = t["emission"][blocks]
    emissive = (emission != 0).any(-1)
    opaque = t["opaque"][blocks].all(-1)
    mean_alpha = t["mean_alpha"][blocks]
    seek = torch.stack([visible | _shifted(visible, NORMALS[OPPOSITE[f]]) | _shifted(emissive, NORMALS[f])
                        for f in range(6)], -1).to(torch.float32)
    pickup = visible & ~opaque & (mean_alpha < 1.0)
    alpha0 = torch.where(pickup, 1.0 - mean_alpha, torch.ones_like(mean_alpha)).reshape(V)
    glow0 = torch.where(pickup[..., None], emission, torch.zeros_like(emission)).reshape(V, 3)
    opaque, emission = opaque.reshape(V), emission.reshape(V, 3)
    idx = torch.arange(V, device=dev) if cubes is None else cubes.to(dev).long()
    seek, alpha0, glow0, opaque, emission = seek.reshape(V, 6)[idx], alpha0[idx], glow0[idx], opaque[idx], emission[idx]
    K = idx.shape[0]
    ray_w = seek @ cos.T  # [K, R]
    incoming = glow0 * ray_w.sum(-1, keepdim=True)
    total = torch.zeros(K, dtype=torch.float32, device=dev)

    # The stored light, with the sky's face light on the ring around the world.
    rgb = decode(light[..., :3])
    ring = torch.zeros((X + 2, Y + 2, Z + 2, 3), dtype=torch.float32, device=dev)
    ring[1:-1, 1:-1, 1:-1] = rgb
    ring[0, 1:-1, 1:-1], ring[-1, 1:-1, 1:-1] = sky_faces[0], sky_faces[3]
    ring[1:-1, 0, 1:-1], ring[1:-1, -1, 1:-1] = sky_faces[1], sky_faces[4]
    ring[1:-1, 1:-1, 0], ring[1:-1, 1:-1, -1] = sky_faces[2], sky_faces[5]
    ring = ring.reshape(-1, 3)

    def ring_at(x, y, z):
        return ring[((x + 1).clamp(0, X + 1) * (Y + 2) + (y + 1).clamp(0, Y + 1)) * (Z + 2) + (z + 1).clamp(0, Z + 1)]

    normals = torch.as_tensor(NORMALS, device=dev)
    walks = (alpha0 > 0) & ~opaque
    flat_blocks = blocks.reshape(-1)
    c_all, r_all = ((ray_w > 0) & walks[:, None]).nonzero(as_tuple=True)
    # Every walked ray ends once (its chart ends it at the latest): its
    # weight is the cube's total.
    total.index_add_(0, c_all, ray_w[c_all, r_all])
    # Each ray's whole walk at once, so many rays at a time that the
    # (ray, step) tables stay under STEPS_AT_ONCE entries.
    chunk = max(1, STEPS_AT_ONCE // off.shape[1])
    for p0 in range(0, c_all.shape[0], chunk):
        c, r = c_all[p0:p0 + chunk], r_all[p0:p0 + chunk]
        S = int(length[r].max())
        w = ray_w[c, r]
        at = idx[c]
        o, f = off[r, :S], face[r, :S]
        px = (at // (Y * Z))[:, None] + o[..., 0]
        py = ((at // Z) % Y)[:, None] + o[..., 1]
        pz = (at % Z)[:, None] + o[..., 2]
        inside = (px >= 0) & (px < X) & (py >= 0) & (py < Y) & (pz >= 0) & (pz < Z)
        leaves = end[r, :S] | ~inside
        b = flat_blocks[(px.clamp(0, X - 1) * Y + py.clamp(0, Y - 1)) * Z + pz.clamp(0, Z - 1)]
        rgba = t["face_rgba"][b, f]
        ha = rgba[..., 3].clamp(0.0, 1.0)
        meets = ~leaves & t["visible"][b]
        strikes = meets & (ha > 0)
        stops = strikes & t["opaque"][b, f]
        passes = meets & (ha < 1) & ~stops
        # What is left of the ray entering each step, after a face it
        # strikes, and leaving it: a product of what each step lets by.
        after_face = torch.where(strikes & ~stops, 1.0 - ha, torch.ones_like(ha))
        lets = torch.where(stops, torch.zeros_like(ha), after_face * torch.where(passes, 1.0 - ha, torch.ones_like(ha)))
        out_a = alpha0[c][:, None] * torch.cumprod(lets, 1)
        in_a = torch.cat([alpha0[c][:, None], out_a[:, :-1]], 1)
        ends = leaves | stops | (out_a <= 0)
        walking = torch.cat([torch.ones_like(ends[:, :1]), ~ends[:, :-1]], 1).to(torch.uint8).cummin(1).values.bool()
        e = t["emission"][b]
        nb = normals[f]
        # A face it strikes reflects the light behind it; a cube it passes
        # through adds its own; where it ends, the sky.
        behind = ring_at(px + nb[..., 0], py + nb[..., 1], pz + nb[..., 2])
        gain = torch.where((walking & strikes)[..., None], (e + rgba[..., :3].clamp(0.0, 1.0) * behind * ha[..., None]) * in_a[..., None], 0.0)
        gain = gain + torch.where((walking & passes)[..., None], (e + ring_at(px, py, pz) * ha[..., None]) * (in_a * after_face)[..., None], 0.0)
        gain = gain + torch.where((walking & ends)[..., None], sky_ray[r][:, None, :] * out_a[..., None], 0.0)
        incoming.index_add_(0, c, gain.sum(1) * w[:, None])
    out = finish(opaque, emission, incoming, total, precision)
    return out if cubes is not None else out.reshape(X, Y, Z, 4)


def finish(opaque, emission, incoming, total, precision: str = "float32") -> torch.Tensor:
    """Packed light of cubes from their summed light and ray weight: an
    opaque cube holds its own emission, or none; a cube no ray reached
    has none either."""
    if precision == "lower":
        incoming, total = _bf16(incoming), _bf16(total)
    glows = opaque & (emission != 0).any(-1)
    total = torch.where(opaque, glows.to(torch.float32), total)
    incoming = torch.where(opaque[:, None], torch.where(glows[:, None], emission, 0.0), incoming)
    code = encode(incoming / torch.clamp(total, min=1.0)[:, None])
    status = torch.where(total > 0, STATUS_VISIBLE, torch.where(opaque, STATUS_OPAQUE, STATUS_NO_RAYS))
    code = torch.where((status == STATUS_VISIBLE)[:, None], code, torch.zeros_like(code))
    if precision == "lower":
        code = torch.where(code > 0, (code & 0xF0) | 0x08, code)
    return torch.cat([code, status[:, None].to(torch.uint8)], -1)


def relight(world, light: torch.Tensor, precision: str = "float32", max_passes: int = 200):
    """Jacobi passes from `light` until no cube's light moves by more than
    one code; (packed light, passes)."""
    for n in range(1, max_passes + 1):
        new = light_pass(world, light, precision)
        moved = int(codes_apart(new, light).max())
        light = new
        if moved <= 1:
            return light, n
    return light, max_passes


# -- the queue ---------------------------------------------------------------------

#: Cubes a queue round relights at most.
BATCH = 256
#: The share of the world's cubes whose marking sends a relight to whole
#: passes instead of the queue; the queue's replay covers only the queue.
DENSE_SHARE = 0.02


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, largest first, the
    lower index first among equals."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def select(dirty: torch.Tensor, batch: int = BATCH):
    """The cubes a queue round takes (flat indices i64[k], and which of
    them are marked at all): the rows of 128 cubes with the highest
    marks, up to four cubes of each (more where rows are few), and of
    those the `batch` highest."""
    flat = dirty.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    k = min(batch, n)
    rows = torch.cat([flat, flat.new_zeros((-n) % 128)]).reshape(-1, 128)
    kr = min(k, rows.shape[0])
    picked_rows = _top(rows.amax(1), kr)
    per_row = min(-(-k // kr) if kr * 4 < k else 4, 128)
    cols = _top(rows[picked_rows], per_row)
    marks = rows[picked_rows].gather(1, cols).reshape(-1)
    where = (picked_rows[:, None] * 128 + cols).reshape(-1)
    best = _top(marks, min(k, marks.shape[0]))
    return torch.clamp(where[best], max=n - 1), marks[best] > 0


def settle(world, light: torch.Tensor, dirty: torch.Tensor, precision: str = "float32", max_rounds: int = 100000):
    """The light queue run to empty from `light` with the cubes `dirty`
    marks (u8[X,Y,Z], 0 clean): each round relights the cubes `select`
    takes from the light as it stands, and marks the six neighbours of
    each whose light moved by more than one code with that difference.
    Returns (light, rounds); raises where the marking would take the
    whole-volume passes instead."""
    X, Y, Z = dirty.shape
    n = X * Y * Z
    if int((dirty > 0).sum()) > DENSE_SHARE * n:
        raise NotImplementedError("the marked cubes take whole-volume passes, which the queue's replay does not follow")
    light = light.clone().reshape(n, 4)
    dirty = dirty.clone().reshape(n).to(torch.int64)
    normals = torch.as_tensor(NORMALS, device=light.device)
    size = torch.as_tensor([X, Y, Z], device=light.device)
    rounds = 0
    while int((dirty > 0).sum()) and rounds < max_rounds:
        at, marked = select(dirty.reshape(X, Y, Z))
        at = at[marked]
        new = light_pass(world, light.reshape(X, Y, Z, 4), precision, cubes=at)
        moved = codes_apart(light[at], new)
        light[at] = new
        dirty[at] = 0
        pos = torch.stack([at // (Y * Z), (at // Z) % Y, at % Z], -1)
        nb = pos[:, None, :] + normals[None]
        ok = ((nb >= 0) & (nb < size)).all(-1) & (moved > 1)[:, None]
        nflat = ((nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2])[ok]
        mark = torch.clamp(moved, max=255)[:, None].expand(-1, 6)[ok]
        dirty.scatter_reduce_(0, nflat, mark.to(torch.int64), "amax")
        rounds += 1
    return light.reshape(X, Y, Z, 4), rounds
