"""Background fill (dilation / push-pull) for geometry & attribute planes.

Capability parity with the reference's padding family (PCCEncoder::dilate
:5757, dilateHarmonicBackgroundFill :6120, push-pull :6358-6528): unoccupied
atlas pixels are filled with values that compress well and do not bleed
across patch edges.

Device design: the push-pull pyramid is a sequence of masked 2x2 mean
reductions (push) and broadcast fills (pull) — O(log N) fused element-wise
passes over (frames, H, W), instead of the reference's per-pixel sweeps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _down2(val: jax.Array, wgt: jax.Array):
    """Masked 2x2 mean: returns (sum of val*wgt, sum of wgt) halved grids."""
    f, h, w = val.shape
    v = (val * wgt).reshape(f, h // 2, 2, w // 2, 2).sum(axis=(2, 4))
    m = wgt.reshape(f, h // 2, 2, w // 2, 2).sum(axis=(2, 4))
    return v, m


def _up2(x: jax.Array):
    return jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)


@jax.jit
def push_pull_fill(img: jax.Array, occ: jax.Array) -> jax.Array:
    """Fill unoccupied pixels of (F, H, W) `img` (float32) from a masked
    mipmap pyramid; occupied pixels keep their exact values.
    H and W must be powers of two (pad first if not)."""
    f, h, w = img.shape
    val = img.astype(jnp.float32)
    wgt = (occ > 0).astype(jnp.float32)

    # push: build masked pyramid down to 1x1
    levels = []
    v, m = val, wgt
    size = min(h, w)
    while size > 1:
        levels.append((v, m))
        v, m = _down2(v, m)
        v = jnp.where(m > 0, v / jnp.maximum(m, 1.0), 0.0)
        m = (m > 0).astype(jnp.float32)
        size //= 2
    levels.append((v, m))

    # pull: fill holes from coarser levels
    fill_v, fill_m = levels[-1]
    fill = jnp.where(fill_m > 0, fill_v, 0.0)
    for v, m in reversed(levels[:-1]):
        up = _up2(fill)
        have = m > 0
        fill = jnp.where(have, jnp.where(have, v, 0.0), up)
    return jnp.where(wgt > 0, img.astype(jnp.float32), fill)


@partial(jax.jit, static_argnames=("iterations",))
def dilate(img: jax.Array, occ: jax.Array, iterations: int = 2) -> jax.Array:
    """Simple iterative dilation (PCCEncoder::dilate analog): each pass fills
    empty pixels with the mean of occupied 4-neighbours."""
    val = img.astype(jnp.float32)
    mask = (occ > 0).astype(jnp.float32)

    def body(_, carry):
        v, m = carry
        vp = jnp.pad(v * m, ((0, 0), (1, 1), (1, 1)))
        mp = jnp.pad(m, ((0, 0), (1, 1), (1, 1)))
        s = (
            vp[:, :-2, 1:-1] + vp[:, 2:, 1:-1] + vp[:, 1:-1, :-2] + vp[:, 1:-1, 2:]
        )
        c = (
            mp[:, :-2, 1:-1] + mp[:, 2:, 1:-1] + mp[:, 1:-1, :-2] + mp[:, 1:-1, 2:]
        )
        newly = (m == 0) & (c > 0)
        v = jnp.where(newly, s / jnp.maximum(c, 1.0), v)
        m = jnp.maximum(m, newly.astype(jnp.float32))
        return v, m

    val, mask = jax.lax.fori_loop(0, iterations, body, (val, mask))
    return val


@partial(jax.jit, static_argnames=("iterations",))
def harmonic_fill(
    img: jax.Array, occ: jax.Array, iterations: int = 24
) -> jax.Array:
    """dilateHarmonicBackgroundFill analog (PCCEncoder.cpp:6120): solve the
    Laplace equation over the unoccupied pixels with occupied pixels as the
    Dirichlet boundary.  The reference runs a mipmap-initialised
    Gauss-Seidel; here the push-pull fill provides the multigrid
    initialisation and fused Jacobi sweeps relax it — the whole solve is one
    device program."""
    mask = occ > 0
    v = push_pull_fill(img, occ)

    def body(_, v):
        vp = jnp.pad(v, ((0, 0), (1, 1), (1, 1)), mode="edge")
        avg = 0.25 * (vp[:, :-2, 1:-1] + vp[:, 2:, 1:-1]
                      + vp[:, 1:-1, :-2] + vp[:, 1:-1, 2:])
        return jnp.where(mask, img.astype(jnp.float32), avg)

    return jax.lax.fori_loop(0, iterations, body, v)


def background_fill(planes, occ, mode: int, pad_fn=None):
    """attributeBGFill / geometry fill dispatch (PCCEncoder.cpp:371-443):
    0 = iterative dilate, 1 = smoothed push-pull (default), 2 = harmonic
    background fill, >=3 = no padding.  planes/occ are (F, H, W) numpy;
    returns float32 (F, H, W)."""
    import numpy as np

    if mode >= 3:
        return planes.astype("float32")
    ppad, opad, (oh, ow) = pad_pow2(planes.astype("float32"), occ)
    jp, jo = jnp.asarray(ppad), jnp.asarray(opad)
    if mode == 0:
        out = dilate(jp, jo, iterations=8)
    elif mode == 2:
        out = harmonic_fill(jp, jo)
    else:
        out = push_pull_fill(jp, jo)
    return np.asarray(out)[:, :oh, :ow]


def group_dilation(filled, occ, n_maps: int):
    """Group dilation (PCCEncoder.cpp:405-427, 5749): with interleaved
    dual-map video, both maps' background pixels take the rounded average of
    the pair so the D1/T1 frame predicts its background from D0/T0 for free.
    filled: (F*n_maps, H, W[,C]) float; occ: (F, H, W) of the shared
    occupancy.  In place; returns filled."""
    import numpy as np

    if n_maps != 2:
        return filled
    if not getattr(filled.flags, "writeable", True):
        filled = filled.copy()
    bg = occ == 0
    d0 = np.round(filled[0::2])
    d1 = np.round(filled[1::2])
    avg = np.floor((d0 + d1 + 1.0) / 2.0)
    if filled.ndim == 4:
        bg = bg[..., None] & np.ones(filled.shape[-1], bool)
    filled[0::2] = np.where(bg, avg, filled[0::2])
    filled[1::2] = np.where(bg, avg, filled[1::2])
    return filled


def pad_pow2(x, occ):
    """Pad trailing dims of (F, H, W) arrays up to powers of two (for
    push_pull_fill); returns (padded_img, padded_occ, (H, W))."""
    import numpy as np

    f, h, w = x.shape
    h2 = 1 << (h - 1).bit_length()
    w2 = 1 << (w - 1).bit_length()
    if h2 == h and w2 == w:
        return x, occ, (h, w)
    xp = np.zeros((f, h2, w2), x.dtype)
    op = np.zeros((f, h2, w2), occ.dtype)
    xp[:, :h, :w] = x
    op[:, :h, :w] = occ
    return xp, op, (h, w)
