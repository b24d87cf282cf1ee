"""Batched patch->3D reprojection + block-to-patch on device.

The device replacement for PCCCodec::generatePointCloud /
generateBlockToPatchFromOccupancyMapVideo (PCCCodec.cpp:517, :1712): instead
of per-pixel loops over patches, the whole atlas is processed as dense
(frames, H, W) tensors:

 * ``block_to_patch``: a ``lax.scan`` over the (padded, masked) patch table
   paints each patch's block bounding box onto the block grid — first
   decode-order patch wins on contested blocks, matching the reference's
   first-come assignment.
 * ``reproject``: every pixel gathers its owning patch's parameters, applies
   the inverse placement orientation, and produces a 3D point via one-hot
   axis composition.  Invalid pixels (unoccupied / unowned) are masked, not
   branched, keeping shapes static for XLA.

Patch table layout (int32, PATCH_TABLE_FIELDS per patch):
  [cx0, cy0, cw, ch,  w, h,  u1, v1, d1,  normal, tangent, bitangent,
   proj_mode, orientation, lod_x, lod_y]
where (cx0, cy0, cw, ch) is the canvas-space bounding box (orientation
already applied) and (w, h) the patch-space pixel size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.patch import Patch

PATCH_TABLE_FIELDS = 18

(
    F_CX0, F_CY0, F_CW, F_CH, F_W, F_H, F_U1, F_V1, F_D1,
    F_NORMAL, F_TANGENT, F_BITANGENT, F_PROJ_MODE, F_ORIENT, F_LODX, F_LODY,
    F_ROT, F_ROT_OFFSET,
) = range(PATCH_TABLE_FIELDS)


def build_patch_table(
    patch_lists: list[list[Patch]], max_patches: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame patch lists -> (table (F, maxP, FIELDS) int32,
    counts (F,) int32), padded to the static max_patches."""
    f = len(patch_lists)
    table = np.zeros((f, max_patches, PATCH_TABLE_FIELDS), np.int32)
    counts = np.zeros((f,), np.int32)
    for fi, patches in enumerate(patch_lists):
        counts[fi] = len(patches)
        for pi, p in enumerate(patches):
            cx0, cy0, cw, ch = p.canvas_bounds()
            table[fi, pi] = [
                cx0, cy0, cw, ch,
                p.size_u_pix, p.size_v_pix,
                p.u1, p.v1, p.d1,
                p.normal_axis, p.tangent_axis, p.bitangent_axis,
                p.projection_mode, int(p.orientation), p.lod_x, p.lod_y,
                p.rotation_axis, p.rot_offset,
            ]
    return table, counts


# ===========================================================================
@partial(jax.jit, static_argnames=("block_size", "reverse"))
def block_to_patch(
    occ: jax.Array,        # (F, H, W) uint8 binary occupancy
    table: jax.Array,      # (F, maxP, FIELDS) int32
    counts: jax.Array,     # (F,) int32
    block_size: int,
    reverse: bool = False,
) -> jax.Array:
    """-> (F, H/bs, W/bs) int32; 0 = unowned, k = owned by patch k-1.

    Default: the FIRST-coded patch covering a block owns it
    (asps_patch_precedence_order_flag=1 semantics — the flag our streams
    declare).  reverse=True claims in reversed coding order, i.e. the
    LAST-coded patch wins (flag=0, the reference's overwrite loop,
    PCCCodec.cpp:2068-2072)."""
    f, h, w = occ.shape
    nby, nbx = h // block_size, w // block_size
    occ_block = (
        occ.reshape(f, nby, block_size, nbx, block_size).max(axis=(2, 4)) > 0
    )
    bx = jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 1)
    by = jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 0)

    def per_frame(tbl, count, occ_b):
        def step(b2p, i):
            pi = jnp.where(reverse, count - 1 - i, i)
            row = tbl[jnp.clip(pi, 0, tbl.shape[0] - 1)]
            x0 = row[F_CX0] // block_size
            y0 = row[F_CY0] // block_size
            x1 = (row[F_CX0] + row[F_CW] + block_size - 1) // block_size
            y1 = (row[F_CY0] + row[F_CH] + block_size - 1) // block_size
            inside = (bx >= x0) & (bx < x1) & (by >= y0) & (by < y1)
            claim = inside & occ_b & (b2p == 0) & (i < count) & (pi >= 0)
            return jnp.where(claim, pi + 1, b2p), None

        b2p0 = jnp.zeros((nby, nbx), jnp.int32)
        b2p, _ = jax.lax.scan(step, b2p0, jnp.arange(tbl.shape[0]))
        return b2p

    return jax.vmap(per_frame)(table, counts, occ_block)


# ===========================================================================
def _inverse_orientation(dx, dy, w, h, orient):
    """Canvas-relative (dx, dy) -> patch (u, v) for all 8 orientations.
    Table matches core.patch.Patch.canvas_to_patch."""
    cases_u = [dx, dy, dy, w - 1 - dx, w - 1 - dy, w - 1 - dx, w - 1 - dy, dx]
    cases_v = [dy, dx, h - 1 - dx, h - 1 - dy, dx, dy, h - 1 - dx, h - 1 - dy]
    conds = [orient == i for i in range(8)]
    u = jnp.select(conds, cases_u, dx)
    v = jnp.select(conds, cases_v, dy)
    return u, v


@partial(jax.jit, static_argnames=("block_size", "reverse"))
def reproject(
    geo: jax.Array,        # (F, H, W) int32/uint16 depth plane
    occ: jax.Array,        # (F, H, W) uint8 binary occupancy
    table: jax.Array,      # (F, maxP, FIELDS) int32
    counts: jax.Array,     # (F,) int32
    block_size: int,
    reverse: bool = False,
):
    """-> (points (F, H*W, 3) int32, valid (F, H*W) bool, b2p (F, nby, nbx)).

    Every occupied pixel owned by a patch becomes one 3D point (the D0/near
    layer).  Output is dense+masked; compaction happens downstream (host or
    segment ops) so all shapes stay static for XLA."""
    f, h, w = geo.shape
    b2p = block_to_patch(occ, table, counts, block_size, reverse)

    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)

    def per_frame(geo_f, occ_f, tbl, b2p_f):
        pidx = jnp.repeat(
            jnp.repeat(b2p_f, block_size, axis=0), block_size, axis=1
        ) - 1  # (H, W), -1 = unowned
        params = tbl[jnp.clip(pidx, 0, tbl.shape[0] - 1)]  # (H, W, FIELDS)
        valid = (occ_f > 0) & (pidx >= 0)

        dx = px - params[..., F_CX0]
        dy = py - params[..., F_CY0]
        u, v = _inverse_orientation(
            dx, dy, params[..., F_W], params[..., F_H], params[..., F_ORIENT]
        )
        depth = geo_f.astype(jnp.int32)
        d = jnp.where(
            params[..., F_PROJ_MODE] == 0,
            params[..., F_D1] + depth,
            params[..., F_D1] - depth,
        )
        tang = params[..., F_U1] + u * params[..., F_LODX]
        bitang = params[..., F_V1] + v * params[..., F_LODY]

        axes = jnp.arange(3, dtype=jnp.int32)
        n_oh = params[..., F_NORMAL, None] == axes
        t_oh = params[..., F_TANGENT, None] == axes
        b_oh = params[..., F_BITANGENT, None] == axes
        pts = (
            d[..., None] * n_oh + tang[..., None] * t_oh + bitang[..., None] * b_oh
        )
        # 45-degree patches: coordinates live in a rotated space; apply the
        # exact integer inverse rotation for the patch's axis (reference
        # axisOfAdditionalPlane numbering, inverseRotatePosition45DegreeOnAxis
        # analog, PCCCodec.cpp:2503): 1 = about Y, 2 = about X, 3 = about Z
        rot = params[..., F_ROT]
        off = params[..., F_ROT_OFFSET]
        x_, y_, z_ = pts[..., 0], pts[..., 1], pts[..., 2]
        # about Y: sum in x', diff in z'
        y_dz = z_ - off
        y_x = (x_ - y_dz + 1) >> 1
        y_z = (x_ + y_dz + 1) >> 1
        # about X: diff in y', sum in z'
        x_dy = y_ - off
        x_y = (x_dy + z_ + 1) >> 1
        x_z = (z_ - x_dy + 1) >> 1
        # about Z: diff in x', sum in y'
        z_dx = x_ - off
        z_x = (z_dx + y_ + 1) >> 1
        z_y = (y_ - z_dx + 1) >> 1
        conds = [rot == 1, rot == 2, rot == 3]
        pts = jnp.stack(
            [
                jnp.select(conds, [y_x, x_, z_x], x_),
                jnp.select(conds, [y_, x_y, z_y], y_),
                jnp.select(conds, [y_z, x_z, z_], z_),
            ],
            axis=-1,
        )
        return pts.reshape(h * w, 3), valid.reshape(h * w)

    pts, valid = jax.vmap(per_frame)(geo, occ, table, b2p)
    return pts, valid, b2p
