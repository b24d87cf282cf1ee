"""Occupancy-map scaling ops.

The transcoder's occupancy 2x2 max-pool downscale (PCCTranscoder.cpp:594-646,
resizeOccupancyMap :341-372) and the decoder's occupancy upsample
(PCCCodec::generateOccupancyMap, PCCCodec.cpp:1584) as batched XLA ops over
(frames, H, W).  These lower to single fused reduce/broadcast kernels on the device —
the reference's per-pixel double loops are the anti-pattern we avoid.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

@partial(jax.jit, static_argnames=("factor",))
def downscale_maxpool(occ: jax.Array, factor: int) -> jax.Array:
    """(F, H, W) -> (F, H/f, W/f) max-pool.  Max (not mean) preserves any
    occupied pixel, matching the reference's conservative downscale."""
    f, h, w = occ.shape
    x = occ.reshape(f, h // factor, factor, w // factor, factor)
    return x.max(axis=(2, 4))


@partial(jax.jit, static_argnames=("factor",))
def upsample_nearest(occ: jax.Array, factor: int) -> jax.Array:
    """(F, h, w) -> (F, h*f, w*f) nearest-neighbour upsample."""
    return jnp.repeat(jnp.repeat(occ, factor, axis=1), factor, axis=2)


@jax.jit
def prefilter_lossy_om(planes: jax.Array) -> jax.Array:
    """3x3 smoothing prefilter over the lossy occupancy video
    (preFilterOccupancyMap, PCCEncoder.cpp:827-852; kernel
    PCCEncoderConstant.h:40 = {12,28,12;28,96,28;12,28,12}, >>8, edge
    clamp).  Softens the binary edges so the DCT codec spends fewer bits."""
    k = jnp.asarray(
        [[12, 28, 12], [28, 96, 28], [12, 28, 12]], jnp.int32
    )
    x = jnp.pad(planes.astype(jnp.int32), ((0, 0), (1, 1), (1, 1)),
                mode="edge")
    h, w = planes.shape[1], planes.shape[2]
    out = jnp.zeros_like(planes, dtype=jnp.int32)
    for dy in range(3):
        for dx in range(3):
            out = out + k[dy, dx] * x[:, dy:dy + h, dx:dx + w]
    return (out >> 8).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("threshold",))
def binarize(occ: jax.Array, threshold: int = 0) -> jax.Array:
    """Occupancy video plane -> binary map (lossy-occupancy threshold,
    OccupancyInformation.oi_lossy_occupancy_compression_threshold)."""
    return (occ > threshold).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("passes", "radius"))
def pbf_refine(
    occ: jax.Array,        # (F, H, W) bool/uint8 (precision-upsampled)
    geo: jax.Array,        # (F, H, W) decoded near-layer geometry
    owner: jax.Array,      # (F, H, W) int32 pixel patch ownership (0 = none)
    threshold: jax.Array,  # depth deviation beyond which a rim pixel drops
    passes: int = 2,
    radius: int = 1,
) -> jax.Array:
    """Patch-border filtering (occupancy synthesis SEI, the
    PatchBlockFiltering role, PCCPatch.h:301-435): precision-upsampled
    occupancy marks whole blocks occupied, so the rim carries background-
    fill geometry.  Each pass drops BOUNDARY pixels whose depth deviates
    more than `threshold` from the windowed mean of SAME-PATCH interior
    pixels (the reference's per-patch depth maps) — eroding dilated rims
    whose fill has drifted off the surface (e.g. toward a tightly packed
    neighbor patch) while leaving true surface pixels, which the fill
    extends smoothly, alone.  Fully vectorised shifted-window sums."""
    o = occ.astype(bool)
    g = geo.astype(jnp.float32)

    def shift(x, dy, dx, fill):
        # mask the FULL |dy|/|dx| wrap band (a radius-2 window once gathered
        # the opposite atlas edge through jnp.roll's wraparound)
        out = jnp.roll(jnp.roll(x, dy, axis=1), dx, axis=2)
        if dy > 0:
            out = out.at[:, :dy, :].set(fill)
        elif dy < 0:
            out = out.at[:, dy:, :].set(fill)
        if dx > 0:
            out = out.at[:, :, :dx].set(fill)
        elif dx < 0:
            out = out.at[:, :, dx:].set(fill)
        return out

    offsets = [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
        if (dy, dx) != (0, 0)
    ]
    for _ in range(passes):
        # interior = occupied with all 4 neighbors occupied AND same patch
        # (a seam between two tightly packed patches IS a patch border even
        # though occupancy is contiguous across it)
        interior = o
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            interior = interior & shift(o, dy, dx, False) & (
                shift(owner, dy, dx, -1) == owner
            )
        boundary = o & ~interior
        num = jnp.zeros_like(g)
        den = jnp.zeros_like(g)
        for dy, dx in offsets:
            sup = (
                shift(interior, dy, dx, False)
                & (shift(owner, dy, dx, 0) == owner)
            ).astype(jnp.float32)
            num = num + sup * shift(g, dy, dx, 0.0)
            den = den + sup
        ref = num / jnp.maximum(den, 1.0)
        bad = boundary & (den > 0) & (jnp.abs(g - ref) > threshold)
        o = o & ~bad
    return o
