"""Multi-chip scaling: device-mesh sharding of (stream x frame x space) batches.

The reference's only parallelism is shared-memory TBB loops (SURVEY.md §2.7);
the device replacement is a jax.sharding Mesh over the local accelerators
(on GPUs XLA hands its collectives to NCCL over NVLink):

 * axis "stream" — data parallelism over concurrent V-PCC streams (the
   BASELINE.json config #5: N concurrent 8i sequences per host);
 * axis "space"  — spatial parallelism over atlas rows (the multi-tile /
   ROI analog, SURVEY.md §5.7): each device transforms its own row band of
   every frame; RBV's block transforms are row-local so XLA inserts no
   communication in the hot loop, and cross-chip reductions (global metrics)
   are collectives.

The mesh shape follows the algorithm, not an interconnect topology:
make_mesh factors the device count as evenly as it can.

No TP/PP/EP analog exists in this domain (SURVEY.md §2.7 states this
explicitly): a video codec has no weight matrices to shard (no TP), no layer
pipeline (no PP), and no experts (no EP).  DP over streams + SP over atlas
space is the complete, honest mapping.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dct import blockify, dct2d, deblockify, idct2d


def make_mesh(devices=None, stream_axis: int | None = None) -> Mesh:
    """Factor the device list into a ("stream", "space") mesh.  Prefers the
    most balanced 2D factorisation; a prime count becomes (n, 1)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if stream_axis is None:
        stream_axis = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                stream_axis = n // f
                break
    space_axis = n // stream_axis
    dev_array = np.array(devices).reshape(stream_axis, space_axis)
    return Mesh(dev_array, axis_names=("stream", "space"))


def stream_batch_sharding(mesh: Mesh) -> NamedSharding:
    """(S, F, H, W) video batches: streams over 'stream', rows over 'space'."""
    return NamedSharding(mesh, P("stream", None, "space", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ===========================================================================
# The flagship multi-stream device step: a full transcode compute pass
# (decode at QP_in -> pixel domain -> re-encode at QP_out -> reconstruct)
# batched over (streams, frames) and sharded over the mesh.
# ===========================================================================
def transcode_compute_step(
    coeffs: jax.Array,     # (S, F, nby, nbx, B, B) int32 coefficients @ qstep_in
    qstep_in: jax.Array,
    qstep_out: jax.Array,
    maxval: jax.Array,
):
    """Dequantise -> reconstruct pixels -> re-transform -> requantise ->
    reconstruct output pixels + distortion.  All-intra shape (the P-chain
    variant runs per-GOP via lax.scan in video.rbv); returns
    (new_coeffs, recon, mse) where mse is a global scalar — the cross-chip
    reduction that exercises the collectives (NCCL over NVLink on GPUs)."""
    from ..video.rbv import _DZ_INTRA, _quantize

    pixels = deblockify(idct2d(coeffs.astype(jnp.float32) * qstep_in))
    pixels = jnp.clip(jnp.round(pixels), 0.0, maxval)
    c2 = dct2d(blockify(pixels, coeffs.shape[-1]))
    # same deadzone quantiser as the production RBV intra path so the
    # sharded step reproduces the single-chip transcode arithmetic exactly
    q2 = _quantize(c2, qstep_out, _DZ_INTRA).astype(jnp.int32)
    recon = deblockify(idct2d(q2.astype(jnp.float32) * qstep_out))
    recon = jnp.clip(jnp.round(recon), 0.0, maxval)
    mse = jnp.mean((recon - pixels) ** 2)  # all-reduce over every axis
    return q2, recon, mse


def make_sharded_transcode_step(mesh: Mesh, block: int = 16):
    """jit the transcode compute step with mesh shardings; XLA partitions the
    transforms per shard and inserts the psum for the global MSE."""
    coeff_sharding = NamedSharding(
        mesh, P("stream", None, "space", None, None, None)
    )
    out_shardings = (
        coeff_sharding,
        NamedSharding(mesh, P("stream", None, "space", None)),
        NamedSharding(mesh, P()),
    )
    return jax.jit(
        transcode_compute_step,
        in_shardings=(coeff_sharding, None, None, None),
        out_shardings=out_shardings,
    )
