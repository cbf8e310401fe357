"""Host-side block evaluation: Block → EvaluatedBlock (layer 1).

Copied unchanged from `aic_tpu/block/eval.py`: the port carries its own jax-free
copy because `aic_tpu`'s package imports pull in JAX. The text-primitive
branch rasterizes through the port's `..text` (PIL's masks read from a
vendored table, the system-16 atlas decoded without an imaging library).

Equivalent of the reference's `Block::evaluate` pipeline
(all-is-cubes/src/block.rs:568 → block/eval/): flatten a block's primitive
(following Indirect → BlockDef, extracting Recur voxels from a Space,
rasterizing Text), apply modifiers left→right, then derive aggregate data
(mean color, per-face colors, per-face opacity, emission, visibility) via
the same per-face mini-raytrace as eval/derived.rs:78 — here vectorized
with numpy over whole faces instead of per-pixel loops.

Evaluation is budget-limited (eval/control.rs:74) to cap runaway recursive
blocks; exceeding the budget yields the error block like the reference's
`InEvalError` → error-voxel fallback.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..math.grid import GridAab, ROTATION_MATRICES, rotate_voxel_array
from . import model
from .model import AIR, Block, BlockAttributes, COLLISION_HARD, COLLISION_NONE

#: Default attributes: a handle block with exactly these is transparent
#: to its definition's attributes (see _evaluate_impl Indirect case).
_DEFAULT_ATTRS = BlockAttributes()

#: Budget in evaluation cost units (components + voxels), mirroring
#: eval/control.rs's Budget { components, voxels }.
DEFAULT_BUDGET_VOXELS = 64 * 64 * 128
DEFAULT_BUDGET_COMPONENTS = 1000


class EvalBudgetExceeded(Exception):
    pass


@dataclass
class _Budget:
    voxels: int = DEFAULT_BUDGET_VOXELS
    components: int = DEFAULT_BUDGET_COMPONENTS

    def spend_components(self, n: int = 1):
        self.components -= n
        if self.components < 0:
            raise EvalBudgetExceeded()

    def spend_voxels(self, n: int):
        self.voxels -= n
        if self.voxels < 0:
            raise EvalBudgetExceeded()


@dataclass
class Evoxels:
    """Dense voxel data of an evaluated block (eval/voxel_storage.rs:189).

    Always stored as full R³ arrays; regions the source didn't cover are
    air (the reference keeps a sub-`Vol` + implicit air; dense is the
    array-native equivalent).
    """

    resolution: int
    color: np.ndarray  # f32 [R,R,R,4] linear straight-alpha RGBA
    emission: np.ndarray  # f32 [R,R,R,3]
    selectable: np.ndarray  # bool [R,R,R]
    collision: np.ndarray  # u8 [R,R,R]

    @staticmethod
    def uniform(color, emission=(0, 0, 0), selectable=True, collision=COLLISION_HARD, resolution=1):
        r = resolution
        return Evoxels(
            resolution=r,
            color=np.broadcast_to(np.asarray(color, np.float32), (r, r, r, 4)).copy(),
            emission=np.broadcast_to(np.asarray(emission, np.float32), (r, r, r, 3)).copy(),
            selectable=np.full((r, r, r), selectable, bool),
            collision=np.full((r, r, r), collision, np.uint8),
        )

    @staticmethod
    def air(resolution=1):
        return Evoxels.uniform((0, 0, 0, 0), selectable=False, collision=COLLISION_NONE,
                               resolution=resolution)


@dataclass
class EvaluatedBlock:
    """Block ready for rendering/physics (eval/evaluated.rs:37)."""

    attributes: BlockAttributes
    voxels: Evoxels
    # Derived (eval/derived.rs:31):
    color: np.ndarray  # f32[4] mean RGBA
    face_colors: np.ndarray  # f32[6,4] per-face mean RGBA
    light_emission: np.ndarray  # f32[3]
    opaque: np.ndarray  # bool[6]
    visible: bool
    uniform_collision: Optional[int]
    cost: int = 0

    @property
    def resolution(self) -> int:
        return self.voxels.resolution

    def visible_or_animated(self) -> bool:
        """evaluated.rs:252."""
        return self.visible or self.attributes.animated

    def face7_color(self, face: int) -> np.ndarray:
        """evaluated.rs:267: per-face color, mean color for WITHIN."""
        if 0 <= face < 6:
            return self.face_colors[face]
        return self.color

    def opaque_for_light(self) -> bool:
        """updater.rs:1025 `opaque_for_light_computation`."""
        return bool(self.opaque.all()) and not self.light_emission.any()


# ---------------------------------------------------------------------------
# Derived computation (vectorized eval/derived.rs:78)


def _apply_transmittance(rgba: np.ndarray, thickness: float):
    """Vectorized raytracer_components.rs:215 `apply_transmittance`.

    rgba: [..., 4]. Returns (adjusted rgba [...,4], emission_coeff [...]).
    """
    alpha = np.clip(rgba[..., 3], 0.0, 1.0)
    unit_transmittance = 1.0 - alpha
    depth_transmittance = unit_transmittance**thickness
    out_alpha = 1.0 - depth_transmittance
    with np.errstate(divide="ignore", invalid="ignore"):
        coeff = np.where(
            unit_transmittance == 1.0,
            thickness,
            (depth_transmittance - 1.0) / (unit_transmittance - 1.0),
        )
    out = np.concatenate([rgba[..., :3], out_alpha[..., None]], axis=-1)
    return out.astype(np.float32), np.maximum(coeff, 0.0).astype(np.float32)


def _trace_face(color: np.ndarray, emission: np.ndarray, face: int):
    """Trace all rays entering through `face` (raytracer_components.rs:174).

    Returns (rgba [N,4] premult-resolved to straight alpha, emission [N,3])
    for the R² face pixels.
    """
    r = color.shape[0]
    axis = face % 3
    # Reorder so the trace axis is axis 0, oriented from the entry face inward.
    c = np.moveaxis(color, axis, 0)
    e = np.moveaxis(emission, axis, 0)
    if face >= 3:  # positive face: enter at index R-1 moving inward (negative)
        c = c[::-1]
        e = e[::-1]
    thickness = 1.0 / r
    c_adj, coeff = _apply_transmittance(c, thickness)
    a = np.clip(c_adj[..., 3], 0.0, 1.0)
    # Transmittance before each layer: cumulative product of (1 - a) above.
    trans_before = np.cumprod(1.0 - a, axis=0)
    trans_before = np.concatenate([np.ones_like(trans_before[:1]), trans_before[:-1]], axis=0)
    premult_rgb = (c_adj[..., :3] * a[..., None] * trans_before[..., None]).sum(axis=0)
    alpha_out = 1.0 - np.prod(1.0 - a, axis=0)
    emission_out = (e * coeff[..., None] * trans_before[..., None]).sum(axis=0)
    rgba = np.concatenate([premult_rgb, alpha_out[..., None]], axis=-1)
    return rgba.reshape(-1, 4), emission_out.reshape(-1, 3)


def compute_derived(attributes: BlockAttributes, voxels: Evoxels) -> EvaluatedBlock:
    """eval/derived.rs:78 `compute_derived`, vectorized."""
    r = voxels.resolution
    color = voxels.color
    alpha = color[..., 3]

    face_colors = np.zeros((6, 4), np.float32)
    all_color_sum = np.zeros(3, np.float64)
    all_alpha_sum = 0.0
    all_emission_sum = np.zeros(3, np.float64)
    for face in range(6):
        rgba, emi = _trace_face(color, voxels.emission, face)
        # VoxSum::color (derived.rs:227): un-premultiply by alpha sum;
        # alpha averaged over the full face area.
        # VoxSum (derived.rs:227): rgb = Σ premultiplied light / Σ alpha;
        # alpha = Σ alpha / full face area. Our rgba[:, :3] is already the
        # premultiplied trace result.
        asum = rgba[:, 3].sum()
        if asum > 0:
            fc_rgb = rgba[:, :3].sum(axis=0) / asum
            face_colors[face] = np.concatenate(
                [fc_rgb, [min(asum / (r * r), 1.0)]]
            )
        all_color_sum += (rgba[:, :3]).sum(axis=0)
        all_alpha_sum += asum
        all_emission_sum += emi.sum(axis=0)

    surface_area = 6.0 * r * r
    if all_alpha_sum > 0:
        mean_rgb = all_color_sum / all_alpha_sum
        mean_color = np.concatenate(
            [mean_rgb, [min(all_alpha_sum / surface_area, 1.0)]]
        ).astype(np.float32)
    else:
        mean_color = np.zeros(4, np.float32)
    light_emission = (all_emission_sum / surface_area).astype(np.float32)

    # opaque per face (derived.rs:195): the face's surface layer is fully
    # opaque everywhere.
    opaque = np.zeros(6, bool)
    for face in range(6):
        axis = face % 3
        layer = np.moveaxis(alpha, axis, 0)[-1 if face >= 3 else 0]
        opaque[face] = bool((layer >= 1.0).all())

    visible = bool((alpha > 0).any() or (voxels.emission != 0).any())

    coll = voxels.collision
    uniform_collision = int(coll.flat[0]) if (coll == coll.flat[0]).all() else None

    return EvaluatedBlock(
        attributes=attributes,
        voxels=voxels,
        color=mean_color,
        face_colors=face_colors,
        light_emission=light_emission,
        opaque=opaque,
        visible=visible,
        uniform_collision=uniform_collision,
    )


# ---------------------------------------------------------------------------
# Primitive + modifier evaluation (block.rs:631 evaluate_impl)

_ERROR_BLOCK_COLOR = np.array([1.0, 0.0, 0.5, 1.0], np.float32)


def evaluate(block: Block, budget: Optional[_Budget] = None, _depth: int = 0) -> EvaluatedBlock:
    """Evaluate a block to renderable voxels (block.rs:568).

    On budget exhaustion or recursion failure, returns the magenta error
    block like the reference's error-fallback path.
    """
    if budget is None:
        budget = _Budget()
    try:
        return _evaluate_impl(block, budget, _depth)
    except EvalBudgetExceeded:
        return compute_derived(
            block.attributes, Evoxels.uniform(_ERROR_BLOCK_COLOR)
        )


def _evaluate_impl(block: Block, budget: _Budget, depth: int) -> EvaluatedBlock:
    if depth > 32:
        raise EvalBudgetExceeded()
    budget.spend_components()
    attributes = block.attributes
    if isinstance(block.primitive, model.Indirect) and attributes == _DEFAULT_ATTRS:
        # Indirection is transparent (block_def.rs): a bare handle
        # carries the definition's evaluated attributes (display_name,
        # tick/activation actions, animation) — without this, animated
        # content chained through BlockDefs would lose its tick actions.
        bd = block.primitive.block_def
        if not (bd._cache is not None and bd._cache_epoch == bd.epoch):
            bd._cache = _evaluate_impl(bd.block, budget, depth + 1)
            bd._cache_epoch = bd.epoch
        attributes = bd._cache.attributes
    voxels = _evaluate_primitive(block.primitive, budget, depth)

    for index, modifier in enumerate(block.modifiers):
        budget.spend_components()
        attributes, voxels = _apply_modifier(
            modifier, attributes, voxels, budget, depth, block=block, index=index
        )

    return compute_derived(attributes, voxels)


def _evaluate_primitive(primitive, budget: _Budget, depth: int) -> Evoxels:
    if isinstance(primitive, model.AirPrimitive):
        return Evoxels.air()
    if isinstance(primitive, model.Atom):
        return Evoxels.uniform(
            np.asarray(primitive.color, np.float32),
            np.asarray(primitive.emission, np.float32),
            collision=primitive.collision,
        )
    if isinstance(primitive, model.Indirect):
        bd = primitive.block_def
        if bd._cache is not None and bd._cache_epoch == bd.epoch:
            ev = bd._cache
        else:
            ev = _evaluate_impl(bd.block, budget, depth + 1)
            bd._cache = ev
            bd._cache_epoch = bd.epoch
        return ev.voxels
    if isinstance(primitive, model.Recur):
        return _evaluate_recur(primitive, budget, depth)
    if isinstance(primitive, model.TextPrimitive):
        return _evaluate_text(primitive, budget)
    raise TypeError(f"unknown primitive {primitive!r}")


def _evaluate_recur(primitive: model.Recur, budget: _Budget, depth: int) -> Evoxels:
    """Extract an R³ region of a Space as voxels (block.rs Primitive::Recur).

    Each cube of the source space becomes one voxel, taking the evaluated
    block's single-voxel representation (or, when the source block is itself
    multi-voxel, its mean color — matching `Space::extract`'s Evoxel::from
    behavior at resolution granularity).
    """
    r = primitive.resolution
    space = primitive.space
    out = Evoxels.air(resolution=r)
    lx, ly, lz = primitive.offset
    # The per-voxel value depends only on the palette index at each
    # cube, so evaluate one row per palette entry and gather — a Python
    # loop over R³ cubes would dominate content generation at R32+.
    lower = np.asarray(space.bounds.lower, np.int64)
    upper = lower + np.asarray(space.bounds.size, np.int64)
    lo = np.maximum([lx, ly, lz], lower)
    hi = np.minimum([lx + r, ly + r, lz + r], upper)
    # Cost = the occupied region only (block.rs:698-704 charges
    # occupied_bounds.volume(), the block∩space intersection) — so a
    # sparse R128 block like the Smallest exhibit fits the default
    # budget exactly as in the reference.
    if (hi <= lo).any():
        return out
    budget.spend_voxels(int(np.prod(hi - lo)))
    # Only completed palette entries have evaluations: during a cyclic
    # load/eval the entry being interned right now has no row yet (the
    # old per-cube path never touched it because contents cannot
    # reference an unfinished entry); out-of-range indices read as air.
    p = len(space._evaluated)
    col = np.zeros((max(p, 1), 4), np.float32)
    emi = np.zeros((max(p, 1), 3), np.float32)
    sel = np.zeros(max(p, 1), bool)
    colls = np.zeros(max(p, 1), np.int8)
    for i in range(p):
        ev = space.evaluated(i)
        vox = ev.voxels
        if vox.resolution == 1:
            col[i] = vox.color[0, 0, 0]
            emi[i] = vox.emission[0, 0, 0]
            sel[i] = vox.selectable[0, 0, 0]
            colls[i] = vox.collision[0, 0, 0]
        else:
            col[i] = ev.color
            emi[i] = ev.light_emission
            sel[i] = ev.attributes.selectable
            colls[i] = (
                ev.uniform_collision
                if ev.uniform_collision is not None
                else COLLISION_HARD
            )
    src = tuple(slice(int(a - l), int(b - l)) for a, b, l in zip(lo, hi, lower))
    dst = tuple(slice(int(a - o), int(b - o)) for a, b, o in zip(lo, hi, (lx, ly, lz)))
    idx = np.asarray(space.contents[src], np.int64)
    idx = np.where(idx < max(p, 1), idx, 0)
    out.color[dst] = col[idx]
    out.emission[dst] = emi[idx]
    out.selectable[dst] = sel[idx]
    out.collision[dst] = colls[idx]
    return out


def _evaluate_text(primitive: model.TextPrimitive, budget: _Budget) -> Evoxels:
    """Voxelize this block's tile of the laid-out string (block/text.rs
    Primitive::Text → text/layout.rs)."""
    r = primitive.resolution
    budget.spend_voxels(r * r * r)
    out = Evoxels.air(resolution=r)
    if primitive.font != "pil":
        return _evaluate_text_layout(primitive, out)
    from ..text.font import text_tile

    mask = text_tile(primitive.text, r, primitive.tile)  # bool[x, y]
    col = np.asarray(primitive.color, np.float32)
    depth = max(min(primitive.depth, r), 1)
    for z in range(depth):
        out.color[:, :, z][mask] = col
        out.collision[:, :, z][mask] = COLLISION_NONE
    return out


def _evaluate_text_layout(primitive: model.TextPrimitive, out: Evoxels) -> Evoxels:
    """Full-fidelity path: compute_layout + brush draw, windowed to this
    block's multiblock offset (text.rs:381 draw_voxels_to_transaction)."""
    from ..text import layout as TL

    r = primitive.resolution
    font = TL.FONTS[primitive.font]
    pos = (
        TL.Positioning(*primitive.positioning)
        if primitive.positioning is not None
        else TL.Positioning()
    )
    if primitive.layout_lower is not None:
        bounds = GridAab.from_lower_size(
            primitive.layout_lower, primitive.layout_size
        )
    else:
        bounds = GridAab.from_lower_size((0, 0, 0), (r,) * 3)
    outlined = primitive.outline_color is not None
    lay = TL.compute_layout(primitive.text, font, outlined, bounds, pos)
    fg = np.asarray(primitive.color, np.float32)
    oc = (
        np.asarray(primitive.outline_color, np.float32)
        if outlined
        else None
    )
    ox, oy = primitive.tile[0] * r, primitive.tile[1] * r
    oz = primitive.tile_z * r
    for (x, y, z), v in TL.draw_layout_voxels(lay, font, outlined):
        lx, ly, lz = x - ox, y - oy, z - oz
        if 0 <= lx < r and 0 <= ly < r and 0 <= lz < r:
            out.color[lx, ly, lz] = fg if v == TL.VALUE_FOREGROUND else oc
            out.collision[lx, ly, lz] = COLLISION_NONE
    return out


def _apply_modifier(
    modifier,
    attributes,
    voxels: Evoxels,
    budget: _Budget,
    depth: int,
    block: Optional[Block] = None,
    index: int = 0,
):
    if isinstance(modifier, model.Rotate):
        rot = ROTATION_MATRICES[modifier.rotation]
        return attributes, Evoxels(
            resolution=voxels.resolution,
            color=rotate_voxel_array(voxels.color, rot),
            emission=rotate_voxel_array(voxels.emission, rot),
            selectable=rotate_voxel_array(voxels.selectable, rot),
            collision=rotate_voxel_array(voxels.collision, rot),
        )
    if isinstance(modifier, model.Composite):
        src_ev = _evaluate_impl(modifier.source, budget, depth + 1)
        dst = voxels
        src = src_ev.voxels
        src_att, dst_att = src_ev.attributes, attributes
        if modifier.reverse:
            src, dst = dst, src
            src_att, dst_att = dst_att, src_att
        out_att = _compose_attributes(
            src_att, dst_att, modifier, block, index
        )
        return out_att, _composite(src, dst, modifier.operator)
    if isinstance(modifier, model.Quote):
        return (
            model.BlockAttributes(
                display_name=attributes.display_name,
                selectable=attributes.selectable,
                animated=attributes.animated,
            ),
            voxels,
        )
    if isinstance(modifier, model.SetAttributes):
        return modifier.attributes, voxels
    if isinstance(modifier, model.Tag):
        import dataclasses as _dc

        return (
            _dc.replace(attributes, tags=attributes.tags + (modifier.name,)),
            voxels,
        )
    if isinstance(modifier, model.Zoom):
        return attributes, _zoom(voxels, modifier)
    if isinstance(modifier, model.Move):
        return attributes, _move(voxels, modifier)
    if isinstance(modifier, model.InventoryModifier):
        return attributes, _render_inventory(
            modifier, attributes, voxels, budget, depth
        )
    raise TypeError(f"unknown modifier {modifier!r}")


def _compose_attributes(src_att, dst_att, modifier, block, index):
    """composite.rs:259-310 attribute composition: destination's name
    wins when both are named; selectable/animated are ORed; tick and
    activation actions blend when they are Become operations (each
    half's Become target is re-composed with the other half)."""
    unnamed = model.DEFAULT_ATTRIBUTES.display_name
    name = (
        src_att.display_name
        if dst_att.display_name == unnamed
        else dst_att.display_name
    )

    def blend_ops(src_op, dst_op):
        # CompositeOperator::blend_operations (composite.rs:638): only
        # Become operations compose; others pass through singly.
        from ..universe.op import Become

        if modifier.reverse:
            src_op, dst_op = dst_op, src_op
        src_b = src_op.block if isinstance(src_op, Become) else None
        dst_b = dst_op.block if isinstance(dst_op, Become) else None
        if src_b is None and dst_b is None:
            # Become is the only composable operation; anything else is
            # dropped here exactly like the reference (composite.rs:655).
            return None
        if dst_b is not None:
            new_block = dst_b
        elif block is not None:
            new_block = Block(block.primitive, block.attributes, block.modifiers[:index])
        else:
            return None
        source = src_b if src_b is not None else modifier.source
        return Become(
            new_block.with_modifier(
                model.Composite(
                    source=source,
                    operator=modifier.operator,
                    reverse=modifier.reverse,
                )
            )
        )

    tick = None
    tick_period = dst_att.tick_period
    if src_att.tick_action is not None or dst_att.tick_action is not None:
        tick = blend_ops(src_att.tick_action, dst_att.tick_action)
        tick_period = (
            src_att.tick_period
            if src_att.tick_action is not None
            else dst_att.tick_period
        )
    activation = None
    if src_att.activation_action is not None or dst_att.activation_action is not None:
        activation = blend_ops(src_att.activation_action, dst_att.activation_action)

    return model.BlockAttributes(
        display_name=name,
        selectable=src_att.selectable or dst_att.selectable,
        tick_action=tick,
        tick_period=tick_period,
        activation_action=activation,
        animated=src_att.animated or dst_att.animated,
        rotation_rule=dst_att.rotation_rule,
        tags=dst_att.tags + src_att.tags,
        inventory=_concat_inv_in_block(src_att.inventory, dst_att.inventory),
        ambient_sound=dst_att.ambient_sound,
    )


def _concat_inv_in_block(src_inv, dst_inv):
    """inv::InvInBlock::concatenate(src, dst) (inv_in_block.rs:222,
    applied by composite.rs:270): the composed block has the size and
    display of both; dst's icon rows are re-based past src's slots."""
    import dataclasses

    if src_inv is None:
        return dst_inv
    if dst_inv is None:
        return src_inv
    if src_inv.inventory_size == 0:
        return dst_inv
    rows = list(src_inv.icon_rows)
    for r in dst_inv.icon_rows:
        rows.append(
            dataclasses.replace(
                r, first_slot=r.first_slot + src_inv.inventory_size
            )
        )
    return model.InvInBlock(
        inventory_size=src_inv.inventory_size + dst_inv.inventory_size,
        icon_scale=src_inv.icon_scale,
        render_resolution=src_inv.render_resolution,
        icon_rows=tuple(rows),
    )


def _render_inventory(
    modifier, attributes, voxels: Evoxels, budget: _Budget, depth: int
) -> Evoxels:
    """Modifier::Inventory rendering (block/modifier/mod.rs:748
    render_inventory): for each configured icon position, evaluate the
    slot's icon block, downsample it to the configured icon size by
    center-sampling (mod.rs:799-820 resample), place it at the position,
    and composite the icon layer OVER the block's own voxels."""
    config = attributes.inventory or model.INV_IN_BLOCK_EMPTY
    if config.inventory_size == 0 or not config.icon_rows:
        return voxels
    rr = config.render_resolution
    icon_size = config.icon_size_in_resolution()

    layer = Evoxels.air(rr)
    placed_any = False
    for slot, lower in config.icon_positions(len(modifier.icons)):
        icon = modifier.icons[slot]
        if icon is None:
            continue
        icon_ev = _evaluate_impl(icon, budget, depth + 1)
        iv = icon_ev.voxels
        scale = max(iv.resolution // icon_size, 1)
        # Nearest (center) downsample: sample voxel centers at stride
        # `scale` with a half-stride offset.
        idx = np.minimum(
            np.arange(icon_size) * scale + scale // 2, iv.resolution - 1
        )
        small_c = iv.color[np.ix_(idx, idx, idx)]
        small_e = iv.emission[np.ix_(idx, idx, idx)]
        # Clip the placement to the block bounds.
        lo = np.asarray(lower)
        src_lo = np.maximum(-lo, 0)
        dst_lo = np.maximum(lo, 0)
        span = np.minimum(lo + icon_size, rr) - dst_lo
        if (span <= 0).any():
            continue
        sl_src = tuple(slice(src_lo[a], src_lo[a] + span[a]) for a in range(3))
        sl_dst = tuple(slice(dst_lo[a], dst_lo[a] + span[a]) for a in range(3))
        layer.color[sl_dst] = small_c[sl_src]
        layer.emission[sl_dst] = small_e[sl_src]
        placed_any = True
    if not placed_any:
        return voxels
    layer = Evoxels(
        resolution=rr,
        color=layer.color,
        emission=layer.emission,
        selectable=np.zeros((rr, rr, rr), bool),
        collision=np.full((rr, rr, rr), COLLISION_NONE, np.uint8),
    )
    return _composite(layer, voxels, "over")


def _unify_resolution(a: Evoxels, b: Evoxels):
    r = max(a.resolution, b.resolution)
    return _upsample(a, r), _upsample(b, r)


def _upsample(v: Evoxels, r: int) -> Evoxels:
    if v.resolution == r:
        return v
    k = r // v.resolution
    rep = lambda arr: np.repeat(np.repeat(np.repeat(arr, k, 0), k, 1), k, 2)
    return Evoxels(r, rep(v.color), rep(v.emission), rep(v.selectable), rep(v.collision))


def _alpha_blend(op: str, source, sa, destination, da):
    """CompositeOperator::alpha_blend (composite.rs:586-625), exactly:
    Over mixes STRAIGHT colors by source alpha only (not classic
    premultiplied Porter–Duff); In/Out keep the source color; Atop takes
    the destination's alpha. Returns (rgb, alpha)."""
    if op == "over":
        rgb = source * sa + destination * (1.0 - sa)
        alpha = np.clip(sa + (1.0 - sa) * da, 0.0, 1.0)
    elif op == "in":
        rgb, alpha = source, sa * da
    elif op == "out":
        rgb, alpha = source, sa * (1.0 - da)
    elif op == "atop":
        rgb = source * sa + destination * (1.0 - sa)
        alpha = da
        rgb = np.where(alpha > 0.0, rgb, 0.0)
    else:
        raise ValueError(f"unknown CompositeOperator {op!r}")
    return rgb, alpha


def _blend_binary(op: str, source, destination):
    """CompositeOperator::blend_binary (composite.rs:629-636)."""
    if op == "over":
        return source | destination
    if op == "in":
        return source & destination
    if op == "out":
        return source & ~destination
    return destination  # atop


def _composite(src: Evoxels, dst: Evoxels, op: str = "over") -> Evoxels:
    """Per-voxel compositing with the reference's exact blend semantics
    (composite.rs:530-583 blend_evoxel): color via `_alpha_blend` on
    clamped straight colors; emission via the same blend on (emission,
    color-alpha) then premultiplied by the output alpha; selectable and
    collision presence via `_blend_binary`, collision value preferring
    the source's."""
    src, dst = _unify_resolution(src, dst)
    sa = np.clip(src.color[..., 3:4], 0.0, 1.0)
    da = np.clip(dst.color[..., 3:4], 0.0, 1.0)
    s_rgb = np.clip(src.color[..., :3], 0.0, 1.0)
    d_rgb = np.clip(dst.color[..., :3], 0.0, 1.0)

    out_rgb, out_a = _alpha_blend(op, s_rgb, sa, d_rgb, da)
    em_blend, em_a = _alpha_blend(op, src.emission, sa, dst.emission, da)
    out_emission = em_blend * em_a  # premultiply (composite.rs:555-557)

    src_something = src.collision != COLLISION_NONE
    dst_something = dst.collision != COLLISION_NONE
    coll_something = _blend_binary(op, src_something, dst_something)
    collision = np.where(
        coll_something,
        np.where(src_something, src.collision, dst.collision),
        COLLISION_NONE,
    ).astype(np.uint8)
    selectable = _blend_binary(op, src.selectable, dst.selectable)

    return Evoxels(
        src.resolution,
        np.concatenate([out_rgb, out_a], axis=-1).astype(np.float32),
        np.nan_to_num(out_emission, nan=0.0, posinf=3.4e38, neginf=0.0).astype(
            np.float32
        ),
        selectable,
        collision,
    )


def _composite_over(src: Evoxels, dst: Evoxels) -> Evoxels:
    return _composite(src, dst, "over")


def _zoom(v: Evoxels, m: model.Zoom) -> Evoxels:
    """Magnify a 1/scale sub-cube to fill the block (zoom.rs).

    The result keeps the divided resolution (zoom.rs tests: an R16
    block zoomed ×2 evaluates at R8), so zoomed multiblock tiles don't
    inflate the voxel tables. Zooming below R1 (e.g. an atom) returns
    the input unchanged — every sub-cube of a uniform block is itself.
    """
    r = v.resolution
    sub = r // m.scale
    if sub == 0:
        return v
    ox, oy, oz = (o * sub for o in m.offset)
    crop = lambda a: a[ox : ox + sub, oy : oy + sub, oz : oz + sub]
    return Evoxels(
        sub, crop(v.color), crop(v.emission), crop(v.selectable), crop(v.collision)
    )


def _move(v: Evoxels, m: model.Move) -> Evoxels:
    """Translate with cropping (move.rs): distance in 1/256 cube units.

    The output resolution is promoted to lcm(input, movement)
    resolution (move.rs:120-123) so e.g. an atom moved half a cube
    becomes an R2 voxel slab, capped at R128 like the reference's
    Resolution::MAX.
    """
    movement_res = 256 // math.gcd(m.distance % 256 or 256, 256)
    r = min(128, math.lcm(v.resolution, movement_res))
    v = _upsample(v, r) if r > v.resolution else v
    r = v.resolution
    shift_voxels = int(round(m.distance / 256.0 * r))
    axis = m.face % 3
    sign = 1 if m.face >= 3 else -1
    out = Evoxels.air(resolution=r)
    s = sign * shift_voxels
    if abs(s) >= r:
        return out

    def shifted(dst, src):
        idx_dst = [slice(None)] * 3
        idx_src = [slice(None)] * 3
        if s >= 0:
            idx_dst[axis] = slice(s, r)
            idx_src[axis] = slice(0, r - s)
        else:
            idx_dst[axis] = slice(0, r + s)
            idx_src[axis] = slice(-s, r)
        dst[tuple(idx_dst)] = src[tuple(idx_src)]

    shifted(out.color, v.color)
    shifted(out.emission, v.emission)
    shifted(out.selectable, v.selectable)
    shifted(out.collision, v.collision)
    return out


#: The evaluation of AIR, used as palette slot 0 everywhere.
AIR_EVALUATED = compute_derived(AIR.attributes, Evoxels.air())
