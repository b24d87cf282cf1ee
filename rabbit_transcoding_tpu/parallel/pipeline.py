"""Multi-chip sharding of the decoder + metrics stages.

parallel/mesh.py and parallel/multistream.py shard the TRANSCODER; the
round-3 review asked for the other two device-heavy pipelines too
(SURVEY.md §2.7: multi-chip metrics reduction):

 * decoder reconstruction (ops/reproject.py): the per-frame vmap is
   embarrassingly frame-parallel, so frames shard across EVERY mesh
   device (both axes flattened) — XLA partitions the whole program with
   zero communication;
 * metrics nearest-neighbour (ops/knn.py grid_knn): query points shard
   across devices, the reference grid is replicated (it is the small
   side), and the per-shard partial sums meet in one psum (an NCCL
   all-reduce on GPUs) — the canonical sharded-reduction shape.

Both paths are asserted IDENTICAL to their single-device results in
tests/test_parallel.py and exercised by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import knn as knn_ops
from ..ops import reproject as repro_ops

# frames / query points spread over BOTH mesh axes: the decoder and the
# metrics stages have no stream/space distinction of their own, they just
# want every chip busy
_ALL = ("stream", "space")


def _pad_leading(a: jax.Array, multiple: int) -> jax.Array:
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))


def sharded_reproject(
    mesh: Mesh,
    geo: np.ndarray,       # (F, H, W) depth plane
    occ: np.ndarray,       # (F, H, W) binary occupancy
    table: np.ndarray,     # (F, maxP, FIELDS) patch table
    counts: np.ndarray,    # (F,)
    block_size: int,
    reverse: bool = False,
):
    """ops/reproject.reproject with frames sharded across the whole mesh.

    Same return contract (points, valid, b2p), bit-identical to the
    single-device call: the computation is frame-local, so sharding the
    frame axis changes the device assignment and nothing else."""
    n = mesh.devices.size
    f = geo.shape[0]
    sh = NamedSharding(mesh, P(_ALL))
    put = lambda a: jax.device_put(_pad_leading(jnp.asarray(a), n), sh)
    pts, valid, b2p = repro_ops.reproject(
        put(geo.astype(np.int32)), put(occ), put(table),
        put(counts), block_size, reverse=reverse,
    )
    return pts[:f], valid[:f], b2p[:f]


def make_sharded_nn_mse(
    mesh: Mesh,
    k_cell_bits: int = 2,
    grid_dim: int = 256,
    cap: int = 32,
    chunk: int = 4096,
):
    """Build the sharded D1-style reduction: mean squared nearest-neighbour
    distance of `queries` against `refs`.

    Queries shard over every device; each shard runs the grid-hash KNN
    against the replicated reference set and the partial (sum, count)
    meet in one psum — on GPUs the NCCL all-reduce of the multi-chip
    metrics path.  Returns f(queries, valid_mask, refs) ->
    scalar MSE (float32 jax scalar)."""

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(_ALL), P(_ALL), P()),
        out_specs=P(),
    )
    def _reduce(q_shard, mask_shard, refs):
        d2, _ = knn_ops.grid_knn(
            q_shard, refs, k=1, cell_bits=k_cell_bits,
            grid_dim=grid_dim, cap=cap, chunk=chunk,
        )
        d2 = jnp.where(mask_shard, d2[:, 0], 0.0)
        unfound = jnp.sum(jnp.isinf(d2), dtype=jnp.float32)
        d2 = jnp.where(jnp.isinf(d2), 0.0, d2)
        s = jnp.sum(d2, dtype=jnp.float32)
        c = jnp.sum(mask_shard, dtype=jnp.float32)
        part = jax.lax.psum(jnp.stack([s, c, unfound]), axis_name=_ALL)
        return part

    def nn_mse(queries: np.ndarray, refs: np.ndarray) -> float:
        n = mesh.devices.size
        q = jnp.asarray(queries.astype(np.int32))
        nq = q.shape[0]
        qp = _pad_leading(q, n)
        mask = jnp.arange(qp.shape[0]) < nq
        sh = NamedSharding(mesh, P(_ALL))
        s, c, unfound = _reduce(
            jax.device_put(qp, sh),
            jax.device_put(mask, sh),
            jax.device_put(
                jnp.asarray(refs.astype(np.int32)),
                NamedSharding(mesh, P()),
            ),
        )
        if float(unfound) > 0:
            raise ValueError(
                f"{int(unfound)} queries found no neighbour within the "
                f"{(1 << k_cell_bits) * 3}-voxel grid search radius — "
                "increase cell_bits/cap for this content"
            )
        return float(s) / max(float(c), 1.0)

    return nn_mse
