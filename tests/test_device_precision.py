"""Every float32 product in the geometry/colour device programs asks for
full float32 precision: left to its default a GPU may run it in TF32,
and the closed codec loop and the CPU comparisons need float32."""

import jax
import jax.numpy as jnp
import numpy as np

from rabbit_transcoding_tpu.encoder import normals, segment
from rabbit_transcoding_tpu.ops import smoothing

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dot_precisions(closed) -> list:
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def test_products_pin_highest_precision():
    n, k = 32, 4
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.integers(0, 64, (n, 3)), jnp.int32)
    ptsf = pts.astype(jnp.float32)
    nrm = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    cols = jnp.asarray(rng.integers(0, 255, (n, 3)), jnp.uint8)
    nbr = jnp.asarray(rng.integers(0, n, (n, k)), jnp.int32)
    ok = jnp.ones((n, k), bool)
    valid = jnp.ones((n,), bool)
    f32 = jnp.float32
    n_dirs = len(segment._DIRECTIONS_BY_MODE[0])
    programs = {
        "segment._ppi_scores": lambda: jax.make_jaxpr(
            segment._ppi_scores, static_argnums=2)(
                nrm, jnp.ones((n, n_dirs), f32), 0),
        "smoothing.color_grid_smooth": lambda: jax.make_jaxpr(
            lambda *a: smoothing.color_grid_smooth(*a, grid_dim=8))(
                pts, cols, valid, f32(4.0)),
        "smoothing.color_grid_smooth_gated": lambda: jax.make_jaxpr(
            lambda *a: smoothing.color_grid_smooth_gated(*a, grid_dim=8))(
                pts, cols, valid, jnp.zeros((n,), jnp.int32), valid,
                f32(4.0), f32(4.0), f32(4.0)),
        "normals._orient_sweep": lambda: jax.make_jaxpr(
            normals._orient_sweep)(nrm, nbr),
        "normals._orient_all": lambda: jax.make_jaxpr(
            normals._orient_all, static_argnums=3)(nrm, ptsf, nbr, 2),
        "normals._pca_normals_full": lambda: jax.make_jaxpr(
            normals._pca_normals_full)(ptsf, nbr, ok, jnp.zeros(3, f32)),
        "normals._smooth_normals": lambda: jax.make_jaxpr(
            normals._smooth_normals, static_argnums=4)(
                nrm, nbr, ok, f32(0.5), 2),
    }
    for name, trace in programs.items():
        precisions = _dot_precisions(trace())
        assert precisions, f"{name}: no product found"
        assert all(p == HIGHEST for p in precisions), (name, precisions)
