"""Grid-hash K-nearest-neighbour search on device.

The device replacement for the reference's nanoflann KD-tree (SURVEY.md
§7.5): KD-trees are pointer-chasing structures that batched device code
traverses badly; voxelised point clouds hash perfectly into a uniform grid
instead.

Build: one bincount + exclusive cumsum (CSR cell index) over the reference
points sorted by cell id.  Query: every query point gathers up to ``cap``
candidates from each of its 27 neighbouring cells (static shapes, masked),
computes all candidate distances in one batched pass, and takes the k
smallest via top_k.  Queries stream through ``lax.map`` chunks to bound the
candidate-tensor footprint.

Exactness: neighbours are found within one cell radius (cell_size =
1 << cell_bits).  For dense voxel surfaces and the framework's uses
(recoloring k<=4, metrics k=1, segmentation k<=48 with cell_bits sized to
the sampling density) this matches the KD-tree; sparse outliers beyond the
radius get masked results (inf distance), which callers handle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    np.int32,
)


@partial(
    jax.jit,
    static_argnames=("k", "cell_bits", "grid_dim", "cap", "chunk"),
)
def grid_knn(
    queries: jax.Array,      # (Q, 3) int32 (padded to chunk multiple ok)
    refs: jax.Array,         # (R, 3) int32
    k: int = 1,
    cell_bits: int = 2,      # cell edge = 4 voxels
    grid_dim: int = 256,
    cap: int = 32,           # max candidates taken per cell
    chunk: int = 8192,
):
    """-> (dists_sq (Q, k) float32 [inf when unfound], indices (Q, k) int32
    into `refs` [-1 when unfound])."""
    r_cell = jnp.clip(refs >> cell_bits, 0, grid_dim - 1)
    r_id = (
        r_cell[:, 0] * grid_dim * grid_dim
        + r_cell[:, 1] * grid_dim
        + r_cell[:, 2]
    )
    order = jnp.argsort(r_id)
    sorted_refs = refs[order]
    sorted_id = r_id[order]
    n_cells = grid_dim ** 3
    counts = jnp.bincount(sorted_id, length=n_cells)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)])[:-1]

    q = queries.shape[0]
    pad = (-q) % chunk
    qpad = jnp.pad(queries, ((0, pad), (0, 0)))

    offs = jnp.asarray(_OFFSETS)

    def one_chunk(qc):
        qcell = jnp.clip(qc >> cell_bits, 0, grid_dim - 1)   # (C, 3)
        nb = qcell[:, None, :] + offs[None, :, :]            # (C, 27, 3)
        valid_cell = jnp.all((nb >= 0) & (nb < grid_dim), axis=-1)
        nb_id = (
            nb[..., 0] * grid_dim * grid_dim + nb[..., 1] * grid_dim + nb[..., 2]
        )
        nb_id = jnp.clip(nb_id, 0, n_cells - 1)
        st = starts[nb_id]                                   # (C, 27)
        ct = jnp.minimum(counts[nb_id], cap)
        lane = jnp.arange(cap, dtype=jnp.int32)              # (cap,)
        cand = st[..., None] + lane                          # (C, 27, cap)
        cand_valid = (lane < ct[..., None]) & valid_cell[..., None]
        cand = jnp.clip(cand, 0, refs.shape[0] - 1)
        cand_pts = sorted_refs[cand]                         # (C, 27, cap, 3)
        diff = cand_pts.astype(jnp.float32) - qc[:, None, None, :].astype(
            jnp.float32
        )
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(cand_valid, d2, jnp.inf)
        flat_d2 = d2.reshape(qc.shape[0], -1)
        flat_idx = cand.reshape(qc.shape[0], -1)
        neg_top, top_pos = jax.lax.top_k(-flat_d2, k)
        top_d2 = -neg_top
        top_sorted_idx = jnp.take_along_axis(flat_idx, top_pos, axis=1)
        top_ref_idx = jnp.where(
            jnp.isinf(top_d2), -1, order[top_sorted_idx].astype(jnp.int32)
        )
        return top_d2, top_ref_idx

    d2, idx = jax.lax.map(
        one_chunk, qpad.reshape(-1, chunk, 3)
    )
    return d2.reshape(-1, k)[:q], idx.reshape(-1, k)[:q]


def knn(
    queries: np.ndarray,
    refs: np.ndarray,
    k: int = 1,
    cell_bits: int | None = None,
    coord_bits: int = 10,
    cap: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper with automatic cell sizing.  Returns (sq dists, indices);
    unfound neighbours have inf distance and index -1."""
    if cell_bits is None:
        # choose the largest cell that (a) gives every query enough in-radius
        # candidates for k and (b) keeps occupied-cell occupancy under cap —
        # measured on the actual data (one cheap bincount per candidate size)
        r32 = refs.astype(np.int64)
        cell_bits = 1
        for cb in range(1, 6):
            gd = max(2, (1 << coord_bits) >> cb)
            ids = (
                np.clip(r32 >> cb, 0, gd - 1) @ np.array(
                    [gd * gd, gd, 1], np.int64
                )
            )
            occ_counts = np.bincount(ids)
            occ_counts = occ_counts[occ_counts > 0]
            p99 = np.percentile(occ_counts, 99) if len(occ_counts) else 0
            median = np.median(occ_counts) if len(occ_counts) else 0
            cell_bits = cb
            if p99 > cap:
                cell_bits = max(1, cb - 1)
                break
            if median * 27 >= 4 * k:
                break
    grid_dim = max(2, (1 << coord_bits) >> cell_bits)
    d2, idx = grid_knn(
        jnp.asarray(queries.astype(np.int32)),
        jnp.asarray(refs.astype(np.int32)),
        k=k,
        cell_bits=cell_bits,
        grid_dim=grid_dim,
        cap=cap,
    )
    return np.asarray(d2), np.asarray(idx)
