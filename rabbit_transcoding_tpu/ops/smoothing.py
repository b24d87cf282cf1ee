"""Geometry + color smoothing / outlier filtering (decoder post-processing).

Capability parity with PCCCodec::smoothPointCloudPostprocess /
smoothPointCloudGrid / gridFiltering (PCCCodec.cpp:52, :1065, :1000):
reconstruction artifacts near patch seams are pulled toward the local
neighborhood centroid, and isolated occupancy-fill outliers (the artifact
class the reference suppresses with occupancy refinement / PBF) are dropped
by a density test.  Driven by the geometry-smoothing SEI parameters.

Device design: one scatter-add builds a (cells, 4) accumulation grid for the
whole cloud; each point gathers its 27-cell neighborhood stats — a handful
of fused device passes, no per-point loops.  Static shapes via pow2 padding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# full float32 products (a float32 product may otherwise run in TF32 on a
# GPU; these 3-wide luma dots gain nothing from it)
_HIGHEST = jax.lax.Precision.HIGHEST

_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    np.int32,
)


@partial(jax.jit, static_argnames=("grid_size", "grid_dim"))
def grid_smooth(
    points: jax.Array,        # (N, 3) int32 (padded)
    valid: jax.Array,         # (N,) bool
    threshold: jax.Array,     # scalar: sq distance triggering the centroid snap
    min_neighbors: jax.Array, # scalar: below this 27-cell count -> drop point
    eligible: jax.Array,      # (N,) bool: only these may MOVE (boundary
                              # points, identifyBoundaryPoints analog)
    grid_size: int = 8,
    grid_dim: int = 128,
):
    """-> (points (N,3) int32, keep (N,) bool, moved (N,) bool)."""
    cell = jnp.clip(points // grid_size, 0, grid_dim - 1)
    w = valid.astype(jnp.float32)
    acc = jnp.zeros((grid_dim, grid_dim, grid_dim, 4), jnp.float32)
    acc = acc.at[cell[:, 0], cell[:, 1], cell[:, 2]].add(
        jnp.concatenate(
            [points.astype(jnp.float32) * w[:, None], w[:, None]], axis=1
        ),
        mode="drop",
    )

    stats = jnp.zeros((points.shape[0], 4), jnp.float32)
    for off in _OFFSETS:
        nb = jnp.clip(cell + jnp.asarray(off), 0, grid_dim - 1)
        stats = stats + acc[nb[:, 0], nb[:, 1], nb[:, 2]]

    count = stats[:, 3]
    centroid = stats[:, :3] / jnp.maximum(count, 1.0)[:, None]
    d2 = jnp.sum((points.astype(jnp.float32) - centroid) ** 2, axis=1)
    # density test: the point itself contributes 1
    keep = valid & (count > min_neighbors)
    move = keep & eligible & (d2 > threshold) & (count > 4.0)
    out = jnp.where(
        move[:, None], jnp.round(centroid).astype(jnp.int32), points
    )
    return out, keep, move


@partial(jax.jit, static_argnames=("grid_size", "grid_dim"))
def color_grid_smooth(
    points: jax.Array,       # (N, 3) int32 (padded)
    colors: jax.Array,       # (N, 3) uint8
    valid: jax.Array,        # (N,) bool
    threshold: jax.Array,    # luma-distance beyond which a point is smoothed
    grid_size: int = 8,
    grid_dim: int = 128,
):
    """Color smoothing (PCCCodec::colorSmoothing / smoothPointCloudColorLC
    analog, PCCCodec.cpp:149, :1268): points whose color deviates from their
    neighborhood mean by more than `threshold` (YUV-luma distance) are pulled
    to the mean.  Same two-pass scatter/gather grid as geometry smoothing."""
    cell = jnp.clip(points // grid_size, 0, grid_dim - 1)
    w = valid.astype(jnp.float32)
    c = colors.astype(jnp.float32)
    acc = jnp.zeros((grid_dim, grid_dim, grid_dim, 4), jnp.float32)
    acc = acc.at[cell[:, 0], cell[:, 1], cell[:, 2]].add(
        jnp.concatenate([c * w[:, None], w[:, None]], axis=1), mode="drop"
    )
    stats = jnp.zeros((points.shape[0], 4), jnp.float32)
    for off in _OFFSETS:
        nb = jnp.clip(cell + jnp.asarray(off), 0, grid_dim - 1)
        stats = stats + acc[nb[:, 0], nb[:, 1], nb[:, 2]]
    count = jnp.maximum(stats[:, 3], 1.0)
    mean = stats[:, :3] / count[:, None]
    # luma-weighted deviation (BT.709 luma)
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    dev = jnp.abs(jnp.matmul(c - mean, lw, precision=_HIGHEST))
    move = valid & (dev > threshold) & (stats[:, 3] > 4.0)
    out = jnp.where(
        move[:, None],
        jnp.clip(jnp.round(mean), 0, 255).astype(jnp.uint8),
        colors,
    )
    return out, move


@partial(jax.jit, static_argnames=("grid_size", "grid_dim"))
def color_grid_smooth_gated(
    points: jax.Array,        # (N, 3) int32 (padded)
    colors: jax.Array,        # (N, 3) uint8
    valid: jax.Array,         # (N,) bool
    partition: jax.Array,     # (N,) int32 patch index per point
    eligible: jax.Array,      # (N,) bool: boundary points only
    threshold: jax.Array,     # reference thresholdColorSmoothing
    thr_variation: jax.Array, # reference thresholdColorVariation
    thr_difference: jax.Array,  # reference thresholdColorDifference
    grid_size: int = 8,
    grid_dim: int = 128,
):
    """Fully gated color smoothing (PCCCodec::colorSmoothing +
    addGridColorCentroid + gridFilteringColor + smoothPointCloudColorLC,
    PCCCodec.cpp:149-290,:1268): a boundary point's color snaps to its
    neighborhood mean only when
      - its own cell holds points of more than one patch (colorDoSmooth),
      - the cell's luma spread is small (reference: |mean - median| <=
        thresholdColorVariation; here the std-dev carries the same gate),
      - neighbor cells whose luma mean differs from the own cell's by more
        than thresholdColorDifference are excluded from the centroid,
      - the luma distance to the centroid (scaled x10, the reference's
        16-bit *10/256) reaches thresholdColorSmoothing.
    One scatter pass builds per-cell {color sum, count, luma sum, luma
    sumsq, partition min/max}; each point gathers its 27-cell stats."""
    cell = jnp.clip(points // grid_size, 0, grid_dim - 1)
    w = valid.astype(jnp.float32)
    c = colors.astype(jnp.float32)
    lw = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
    lum = jnp.matmul(c, lw, precision=_HIGHEST)
    acc = jnp.zeros((grid_dim, grid_dim, grid_dim, 6), jnp.float32)
    acc = acc.at[cell[:, 0], cell[:, 1], cell[:, 2]].add(
        jnp.concatenate(
            [c * w[:, None], w[:, None], (lum * w)[:, None],
             (lum * lum * w)[:, None]],
            axis=1,
        ),
        mode="drop",
    )
    big = jnp.int32(1 << 30)
    pmin = jnp.full((grid_dim, grid_dim, grid_dim), big, jnp.int32)
    pmax = jnp.full((grid_dim, grid_dim, grid_dim), -big, jnp.int32)
    pv = jnp.where(valid, partition, big)
    pmin = pmin.at[cell[:, 0], cell[:, 1], cell[:, 2]].min(pv, mode="drop")
    pv2 = jnp.where(valid, partition, -big)
    pmax = pmax.at[cell[:, 0], cell[:, 1], cell[:, 2]].max(pv2, mode="drop")

    own = acc[cell[:, 0], cell[:, 1], cell[:, 2]]
    own_cnt = jnp.maximum(own[:, 3], 1.0)
    own_mean_lum = own[:, 4] / own_cnt
    own_var = jnp.maximum(own[:, 5] / own_cnt - own_mean_lum ** 2, 0.0)
    own_ok = jnp.sqrt(own_var) <= thr_variation
    mixed = (
        pmax[cell[:, 0], cell[:, 1], cell[:, 2]]
        != pmin[cell[:, 0], cell[:, 1], cell[:, 2]]
    )

    csum = jnp.zeros((points.shape[0], 3), jnp.float32)
    ccnt = jnp.zeros((points.shape[0],), jnp.float32)
    for off in _OFFSETS:
        nb = jnp.clip(cell + jnp.asarray(off), 0, grid_dim - 1)
        st = acc[nb[:, 0], nb[:, 1], nb[:, 2]]
        cnt = jnp.maximum(st[:, 3], 1.0)
        mean_lum = st[:, 4] / cnt
        var = jnp.maximum(st[:, 5] / cnt - mean_lum ** 2, 0.0)
        use = (
            (st[:, 3] > 0.0)
            & (jnp.abs(mean_lum - own_mean_lum) <= thr_difference)
            & (jnp.sqrt(var) <= thr_variation)
        ).astype(jnp.float32)
        csum = csum + st[:, :3] * use[:, None]
        ccnt = ccnt + st[:, 3] * use
    mean = csum / jnp.maximum(ccnt, 1.0)[:, None]
    dev = jnp.abs(lum - jnp.matmul(mean, lw, precision=_HIGHEST)) * 10.0
    move = (
        valid & eligible & mixed & own_ok
        & (dev >= threshold) & (ccnt > 0.0)
    )
    out = jnp.where(
        move[:, None],
        jnp.clip(jnp.round(mean), 0, 255).astype(jnp.uint8),
        colors,
    )
    return out, move


def smooth_colors(
    positions: np.ndarray,
    colors: np.ndarray,
    threshold: float = 10.0,
    grid_size: int = 8,
    coord_bits: int = 10,
    partition: np.ndarray | None = None,
    eligible: np.ndarray | None = None,
    threshold_variation: float = 255.0,
    threshold_difference: float = 255.0,
) -> tuple[np.ndarray, int]:
    """Host wrapper for color smoothing.  With a per-point `partition`
    (patch index) the fully gated reference algorithm runs
    (color_grid_smooth_gated); without one, the legacy neighborhood-mean
    filter (color_grid_smooth)."""
    n = len(positions)
    if n == 0:
        return colors, 0
    cap = 1 << max(10, (n - 1).bit_length())
    pts = np.zeros((cap, 3), np.int32)
    pts[:n] = positions
    cols = np.zeros((cap, 3), np.uint8)
    cols[:n] = colors
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    # clamp the cell grid to the occupied extent (pow2-rounded so jit keys
    # stay few): the dense (grid_dim^3, 6) accumulator at vox10/cgrid4 would
    # otherwise be 256^3 cells regardless of content
    occ_dim = int(positions.max()) // grid_size + 2
    grid_dim = max(2, min(
        (1 << coord_bits) // grid_size,
        1 << (occ_dim - 1).bit_length(),
    ))
    # memory guard: the dense per-cell stats are grid_dim^3 x ~8 floats —
    # 256^3 (cgridSize 4, full vox10 extent) would be >500 MB of device
    # buffers.  Coarsen the cell size instead; BOTH sides derive the same
    # grid from the same decoded cloud, so the closed loop stays identical.
    while grid_dim > 128:
        grid_size *= 2
        grid_dim = (grid_dim + 1) // 2
    if partition is None:
        out, moved = color_grid_smooth(
            jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
            jnp.float32(threshold), grid_size, grid_dim,
        )
        return np.asarray(out)[:n], int(np.asarray(moved).sum())
    part = np.zeros((cap,), np.int32)
    part[:n] = partition
    elig = np.zeros((cap,), bool)
    elig[:n] = True if eligible is None else eligible
    out, moved = color_grid_smooth_gated(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid),
        jnp.asarray(part), jnp.asarray(elig),
        jnp.float32(threshold), jnp.float32(threshold_variation),
        jnp.float32(threshold_difference), grid_size, grid_dim,
    )
    return np.asarray(out)[:n], int(np.asarray(moved).sum())


def knn_smooth(
    positions: np.ndarray,
    partition: np.ndarray,
    neighbor_count: int = 64,
    radius2: float = 64.0,
    radius2_boundary: float = 64.0,
    threshold: float = 64.0,
    eligible: np.ndarray | None = None,
) -> tuple[np.ndarray, int]:
    """Full-KNN geometry smoothing (PCCCodec::smoothPointCloud, the
    gridSmoothing=0 path; reference knobs neighborCountSmoothing /
    radius2Smoothing / radius2BoundaryDetection / thresholdSmoothing).

    Per point: neighbors within sqrt(radius2) (capped neighbor_count); if
    any neighbor within sqrt(radius2_boundary) belongs to a DIFFERENT patch
    and the rounded-centroid distance reaches `threshold`, the point snaps
    to the rounded neighborhood centroid (the reference's integer rounding
    kept).  KNN runs on device via the grid-hash kernel."""
    from .knn import grid_knn

    n = len(positions)
    if n == 0:
        return positions, 0
    k = max(1, neighbor_count)
    if k > 64:
        import sys

        print(
            f"warning: neighborCountSmoothing={k} exceeds the device KNN "
            "kernel's 64-neighbor tile; smoothing with 64",
            file=sys.stderr,
        )
        k = 64
    pos = positions.astype(np.int32)
    d2, idx = grid_knn(
        jnp.asarray(pos), jnp.asarray(pos), k=min(k, 64),
        cap=max(32, min(k, 64)),
    )
    d2 = np.asarray(d2)
    idx = np.asarray(idx)
    inr = (d2 <= radius2) & (idx >= 0)
    safe = np.clip(idx, 0, n - 1)
    cnt = inr.sum(axis=1)
    centroid = (pos[safe] * inr[..., None]).sum(axis=1)
    other = (
        inr & (d2 <= radius2_boundary)
        & (partition[safe] != partition[:, None])
    ).any(axis=1)
    nc = np.maximum(cnt, 1)
    # the reference's integer centroid rounding (PCCCodec.cpp:~smoothPointCloud)
    cent_i = ((centroid + (nc // 2)[:, None]) // nc[:, None]).astype(np.int64)
    # reference: |sum(neighbors) - n*point|^2 / n  ==  n * |mean - point|^2
    d2c = np.floor(
        ((centroid - pos * nc[:, None]).astype(np.float64) ** 2).sum(axis=1)
        + nc / 2.0
    ) / nc
    move = other & (d2c >= threshold)
    if eligible is not None:
        move &= eligible
    out = pos.copy()
    out[move] = cent_i[move].astype(np.int32)
    return out, int(move.sum())


def presmooth_colors(
    positions: np.ndarray,
    colors: np.ndarray,
    eligible: np.ndarray | None = None,
    radius2: float = 64.0,
    max_neighbors: int = 64,
    threshold: float = 10.0,
    entropy_threshold: float = 4.5,
) -> tuple[np.ndarray, int]:
    """Encoder-side color pre-smoothing (presmoothPointCloudColor,
    PCCEncoder.cpp: radius-KNN per boundary point; the color snaps to the
    neighborhood centroid only where the local luma ENTROPY is low — flat
    regions — and the L1 color distance to the centroid reaches
    thresholdColorPreSmoothing).  Decoder-invisible."""
    from scipy.spatial import cKDTree

    n = len(positions)
    if n == 0:
        return colors, 0
    k = min(max(1, max_neighbors), n)
    tree = cKDTree(positions)
    cand = np.arange(n) if eligible is None else np.nonzero(eligible)[0]
    if len(cand) == 0:
        return colors, 0
    d, idx = tree.query(positions[cand], k=k)
    if k == 1:
        d = d[:, None]
        idx = idx[:, None]
    inr = (d * d) <= radius2
    nc = np.maximum(inr.sum(axis=1), 1)
    cols = colors.astype(np.int64)
    centroid = (cols[idx] * inr[..., None]).sum(axis=1)
    centroid = (centroid + (nc // 2)[:, None]) // nc[:, None]
    # local luma Shannon entropy over the in-radius neighbors
    lum = (
        0.2126 * cols[idx][..., 0] + 0.7152 * cols[idx][..., 1]
        + 0.0722 * cols[idx][..., 2]
    ).astype(np.int32)
    # vectorized per-row Shannon entropy: scatter-add in-radius luma values
    # into a (rows, 256) histogram (a per-row python unique() loop measured
    # minutes per frame on a single-core host)
    rows = len(cand)
    hist = np.zeros((rows, 256), np.int32)
    rr = np.repeat(np.arange(rows), k)
    lv = np.clip(lum.reshape(-1), 0, 255)
    sel = inr.reshape(-1)
    np.add.at(hist, (rr[sel], lv[sel]), 1)
    tot = np.maximum(hist.sum(axis=1, keepdims=True), 1)
    pmat = hist / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.where(pmat > 0, pmat * np.log2(pmat), 0.0).sum(axis=1)
    dist1 = np.abs(centroid - cols[cand]).sum(axis=1)
    move = (dist1 >= threshold) & (ent < entropy_threshold)
    out = colors.copy()
    out[cand[move]] = np.clip(centroid[move], 0, 255).astype(colors.dtype)
    return out, int(move.sum())


def smooth_cloud(
    positions: np.ndarray,
    threshold: float = 64.0,
    min_neighbors: int = 4,
    grid_size: int = 8,
    coord_bits: int = 10,
    eligible: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host wrapper: pad to a static-shape bucket, run, trim.
    eligible: optional (N,) bool — only these points may move (the
    reference smooths patch-BOUNDARY points only, identifyBoundaryPoints,
    PCCCodec.cpp:266); None = all movable.
    Returns (positions, keep mask over input order, moved count)."""
    n = len(positions)
    if n == 0:
        return positions, np.zeros(0, bool), 0
    cap = 1 << max(10, (n - 1).bit_length())
    pts = np.zeros((cap, 3), np.int32)
    pts[:n] = positions
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    elig = np.zeros((cap,), bool)
    elig[:n] = True if eligible is None else eligible
    grid_dim = max(2, (1 << coord_bits) // grid_size)
    out, keep, moved = grid_smooth(
        jnp.asarray(pts), jnp.asarray(valid), jnp.float32(threshold),
        jnp.float32(min_neighbors), jnp.asarray(elig), grid_size, grid_dim,
    )
    keep = np.asarray(keep)[:n]
    return np.asarray(out)[:n], keep, int(np.asarray(moved).sum())
