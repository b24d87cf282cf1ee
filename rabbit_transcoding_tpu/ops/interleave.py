"""Single-map pixel interleaving (asps_pixel_deinterleaving_flag).

Capability parity with the reference's singleMapPixelInterleaving mode
(PCCEncoderParameters.h:218, PCCCodec pixel-deinterleave reconstruction):
both depth maps ride ONE video, checkerboarded by pixel parity —
(x + y) even carries D0, odd carries D1.  The missing map value at a pixel
is interpolated from its horizontal neighbors, which by construction carry
exactly the needed map.

Device ops: pure elementwise selects + shifts, fused by XLA.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _parity0(h: int, w: int) -> jax.Array:
    yy, xx = jnp.mgrid[0:h, 0:w]
    return ((yy + xx) % 2) == 0


@jax.jit
def interleave_maps(m0: jax.Array, m1: jax.Array) -> jax.Array:
    """(F, H, W) x2 -> (F, H, W): even-parity pixels from map 0, odd from
    map 1."""
    par0 = _parity0(m0.shape[1], m0.shape[2])
    return jnp.where(par0[None], m0, m1)


@partial(jax.jit, static_argnames=("use_occ", "use_clamp"))
def _deinterleave_impl(plane, occ, thickness, use_occ: bool,
                       use_clamp: bool):
    f, h, w = plane.shape
    p = plane.astype(jnp.int32)
    left = jnp.roll(p, 1, axis=2)
    right = jnp.roll(p, -1, axis=2)
    xx = jnp.arange(w)
    has_l = jnp.broadcast_to((xx > 0)[None, None, :], p.shape)
    has_r = jnp.broadcast_to((xx < w - 1)[None, None, :], p.shape)
    if use_occ:
        # only OCCUPIED neighbors contribute (an unoccupied neighbor holds
        # background fill, not the missing map's depth — the reference
        # gates each neighbor the same way, PCCCodec.cpp:350-471)
        ob = occ.astype(bool)
        has_l = has_l & jnp.roll(ob, 1, axis=2)
        has_r = has_r & jnp.roll(ob, -1, axis=2)
    cnt = has_l.astype(jnp.int32) + has_r.astype(jnp.int32)
    s = jnp.where(has_l, left, 0) + jnp.where(has_r, right, 0)
    # no usable neighbor: duplicate the own-parity sample (a same-position
    # point; remove-duplicates folds it)
    interp = jnp.where(cnt > 0, s // jnp.maximum(cnt, 1), p)
    if use_clamp:
        # the missing map stays within surfaceThickness of the coded one
        interp = jnp.clip(interp, p - thickness, p + thickness)
    par0 = _parity0(h, w)[None]
    m0 = jnp.where(par0, p, interp)
    m1 = jnp.where(par0, interp, p)
    return m0.astype(plane.dtype), m1.astype(plane.dtype)


def deinterleave_maps(
    plane: jax.Array,
    occ: jax.Array | None = None,
    thickness: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """(F, H, W) interleaved -> (map0, map1).

    The missing map at (x, y) interpolates from the (x∓1, y) samples —
    opposite parity, i.e. exactly the needed map.  With `occ` only occupied
    neighbors contribute; with `thickness` (geometry planes) the result
    clamps to the coded sample ± surfaceThickness (the reference's
    pixel-interleave reconstruction applies both gates,
    PCCCodec.cpp:350-471).  Encoder closed loop and decoder MUST pass the
    same arguments."""
    use_occ = occ is not None
    use_clamp = thickness is not None
    return _deinterleave_impl(
        plane,
        occ if use_occ else plane,
        jnp.int32(thickness if use_clamp else 0),
        use_occ, use_clamp,
    )
