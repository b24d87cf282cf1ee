"""Batched 2D block DCT/IDCT as matmuls.

The transform stage of the RBV video codec (the replacement for the
reference's HM/x265 transform path).  A 2D DCT-II of a BxB block is two
matrix multiplies (D @ X @ D^T); batching every block of every frame of a
GOP into one (N, B, B) tensor turns the whole transform into two large
batched matmuls for XLA, in contrast to the reference's per-CU scalar
loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows = basis functions)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


def blockify(x: jax.Array, block: int) -> jax.Array:
    """(..., H, W) -> (..., H//B, W//B, B, B).  H, W must be multiples of B."""
    *lead, h, w = x.shape
    nby, nbx = h // block, w // block
    x = x.reshape(*lead, nby, block, nbx, block)
    return jnp.swapaxes(x, -3, -2)


def deblockify(x: jax.Array) -> jax.Array:
    """(..., nby, nbx, B, B) -> (..., H, W)."""
    *lead, nby, nbx, b, b2 = x.shape
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, nby * b, nbx * b2)


# Full float32 products.  Left to its default, a float32 matmul may run in
# TF32 on a GPU (a 10-bit mantissa) or in bf16 passes elsewhere: far too
# coarse for 10-bit geometry in a closed codec loop, where the encoder's
# reconstruction must equal the decoder's.
_PRECISION = jax.lax.Precision.HIGHEST


def dct2d(blocks: jax.Array) -> jax.Array:
    """Forward 2D DCT over the last two dims: D @ X @ D^T."""
    d = jnp.asarray(dct_matrix(blocks.shape[-1]))
    y = jnp.einsum("ij,...jk->...ik", d, blocks, precision=_PRECISION,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("...ik,jk->...ij", y, d, precision=_PRECISION,
                      preferred_element_type=jnp.float32)


def idct2d(coeffs: jax.Array) -> jax.Array:
    """Inverse 2D DCT over the last two dims: D^T @ C @ D."""
    d = jnp.asarray(dct_matrix(coeffs.shape[-1]))
    y = jnp.einsum("ji,...jk->...ik", d, coeffs, precision=_PRECISION,
                   preferred_element_type=jnp.float32)
    return jnp.einsum("...ik,kj->...ij", y, d, precision=_PRECISION,
                      preferred_element_type=jnp.float32)


def pad_to_block(x: np.ndarray, block: int) -> np.ndarray:
    """Edge-pad the trailing two dims up to a multiple of `block` (edge
    padding keeps block energy low at image borders, unlike zero pad)."""
    h, w = x.shape[-2:]
    ph = (-h) % block
    pw = (-w) % block
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(x, pad, mode="edge")
