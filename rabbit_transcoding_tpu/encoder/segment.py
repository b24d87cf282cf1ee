"""Patch segmentation: PPI classification, refinement, patch extraction.

Capability parity with PCCPatchSegmenter3 (/root/reference/source/lib/
PccLibEncoder/source/PCCPatchSegmenter.cpp): initialSegmentation (:213,
normal-vs-projection-direction scoring over the 6 canonical orientations),
refineSegmentation (:1286, iterative KNN smoothing of the partition), and
segmentPatches (:506, connected components -> per-patch depth maps with a
missed-points recovery loop).

Host/device split: PPI scoring and the smoothing iterations are batched device
ops over the (host-built) KNN graph; connected components run on host via
scipy's sparse graph machinery (small, irregular); depth-map rasterisation is
vectorised NumPy scatter per patch.
"""

from __future__ import annotations

import dataclasses

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from ..codec.patch_frame import _axes_of
from ..core.patch import Patch
from ..utils.enums import PatchType
from .normals import compute_normals, knn_indices

# the 6 canonical projection directions (+X,+Y,+Z,-X,-Y,-Z), ppi order;
# ppi 6..9 are the 45-degree-about-Y diagonals (asps extended projection)
_SQ2 = float(np.sqrt(0.5))
_DIRECTIONS_6 = np.array(
    [
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    ],
    np.float32,
)
# the 45-degree diagonal blocks per rotation axis, in the reference's
# cluster order (orientations10_{Y,X,Z}Axis[6..9] / orientations18[6..17],
# PCCPatchSegmenter.h:323-383): [+sum, +diff, -sum, -diff] per plane
_DIAG_Y = np.array(
    [[_SQ2, 0, _SQ2], [-_SQ2, 0, _SQ2], [-_SQ2, 0, -_SQ2], [_SQ2, 0, -_SQ2]],
    np.float32,
)
_DIAG_X = np.array(
    [[0, _SQ2, _SQ2], [0, _SQ2, -_SQ2], [0, -_SQ2, -_SQ2], [0, -_SQ2, _SQ2]],
    np.float32,
)
_DIAG_Z = np.array(
    [[_SQ2, _SQ2, 0], [_SQ2, -_SQ2, 0], [-_SQ2, -_SQ2, 0], [-_SQ2, _SQ2, 0]],
    np.float32,
)
# additionalProjectionPlaneMode -> PPI direction table
_DIRECTIONS_BY_MODE = {
    0: _DIRECTIONS_6,
    1: np.concatenate([_DIRECTIONS_6, _DIAG_Y]),
    2: np.concatenate([_DIRECTIONS_6, _DIAG_X]),
    3: np.concatenate([_DIRECTIONS_6, _DIAG_Z]),
    4: np.concatenate([_DIRECTIONS_6, _DIAG_Y, _DIAG_X, _DIAG_Z]),
}
_DIRECTIONS_10 = _DIRECTIONS_BY_MODE[1]


def ppi_to_view_id(ppi: int, mode: int) -> int:
    """Cluster index -> projection/view id (the reference's +4/+8 shift for
    X-/Z-axis planes, PCCPatchSegmenter.cpp:885-889; mode 4's 18-entry table
    is already in view-id order)."""
    if ppi <= 5:
        return ppi
    if mode == 2:
        return ppi + 4
    if mode == 3:
        return ppi + 8
    return ppi


def rotate45(points: np.ndarray, axis: int, offset: int) -> np.ndarray:
    """Exact integer 45-degree rotation about one coordinate axis — an
    integer bijection (sum and difference of two coords share parity), so
    the inverse loses nothing on clean data.  Axis numbering follows the
    reference's axisOfAdditionalPlane (PCCPatchSegmenter.h:238-255 convert):
    1 = about Y: (x, y, z) -> (x+z, y, z-x+offset)
    2 = about X: (x, y, z) -> (x, y-z+offset, y+z)
    3 = about Z: (x, y, z) -> (x-y+offset, x+y, z)
    """
    x = points[:, 0].astype(np.int64)
    y = points[:, 1].astype(np.int64)
    z = points[:, 2].astype(np.int64)
    if axis == 1:
        return np.stack([x + z, y, z - x + offset], axis=1)
    if axis == 2:
        return np.stack([x, y - z + offset, y + z], axis=1)
    if axis == 3:
        return np.stack([x - y + offset, x + y, z], axis=1)
    raise ValueError(f"bad rotation axis {axis}")


def rotate45_y(points: np.ndarray, offset: int) -> np.ndarray:
    """Exact integer rotation about Y: (x, y, z) -> (x+z, y, z-x+offset)."""
    return rotate45(points, 1, offset)


@dataclasses.dataclass
class SegmenterParams:
    """Mirrors the reference's segmentation knobs (PCCEncoderParameters
    subset, names kept)."""

    nn_normal_estimation: int = 16
    max_nn_count_refine_segmentation: int = 48
    iteration_count_refine_segmentation: int = 10
    lambda_refine_segmentation: float = 3.0
    # normalOrientation (PCCPatchSegmenter.cpp:88-98): orientation strategy
    # for the segmentation normals — 0 none (estimation-time viewpoint flip
    # only), 1 spanning tree (the default; true max-spanning-tree sign
    # propagation in native C++, sweep fallback without a compiler),
    # 2 viewpoint, 3 cubemap projection
    normal_orientation: int = 1
    # gridBasedRefineSegmentation (refineSegmentationGridBased,
    # PCCPatchSegmenter.cpp:1334): smooth the PPI with voxel-level score
    # histograms over a radius-limited voxel adjacency instead of the
    # point-level KNN graph
    grid_based_refine_segmentation: bool = False
    voxel_dimension_refine_segmentation: int = 4
    search_radius_refine_segmentation: int = 192
    min_point_count_per_cc_patch_segmentation: int = 16
    surface_thickness: int = 4
    max_allowed_depth: int = 255
    max_missed_point_iterations: int = 4
    # KNN count of the CC adjacency graph (maxNNCountPatchSegmentation —
    # distinct from the refine pass's count); 0 = use the full graph width
    max_nn_count_patch_segmentation: int = 16
    # raw-points thresholds (PCCPatchSegmenter.cpp:526-527, 778, 1261):
    # after each round every source point measures its NN dist^2 to the
    # resampled reconstruction; points > selection stay missed, and the
    # next round only keeps components seeded by a point > detection
    max_allowed_dist2_raw_points_detection: float = 9.0
    max_allowed_dist2_raw_points_selection: float = 1.0
    # KNN edges longer than this do not connect components (a kNN graph
    # otherwise links arbitrarily distant clutter into one bogus patch)
    max_cc_edge_distance: float = 5.0
    # 45-degree extended projection planes (additionalProjectionPlaneMode:
    # 0 off, 1 about Y, 2 about X, 3 about Z, 4 all three; mode 5 = partial,
    # handled by segment_frame_partial)
    additional_projection_mode: int = 0
    # enhancedProjectionPlane axis weights for the 6 axial PPI directions
    # (calculateWeightNormal, PCCEncoder.cpp:3601); None = flat
    axis_weight: tuple | None = None
    # maxPatchSize (reference sequence cfgs): components wider than this in
    # tangent/bitangent split at the median of the longer axis; 0 = off
    max_patch_size: int = 1024
    # enablePatchSplitting (PCCPatchSegmenter.cpp:920-947): gates the
    # maxPatchSize component splitting
    enable_patch_splitting: bool = True
    # patchExpansion (PCCPatchSegmenter.cpp:578,925-945): components
    # (largest first) absorb unclaimed KNN-adjacent points of other,
    # non-opposite partitions within dist^2 <= 2 — fewer cross-plane seams
    patch_expansion: bool = False
    # EOMFixBitCount (asps_eom_fix_bit_count): how many between-layer depth
    # bits one EOM cell carries; deeper interior points fall back to the
    # missed set.  This framework's occupancy plane carries up to 7.
    eom_fix_bit_count: int = 7
    # depthQuantizationStep (minLevel, PCCEncoderParameters.cpp:76): the
    # patch D1 reference floors to a multiple of this so pdu_3d_offset_d
    # codes in ath_pos_min_d_quantizer units; relative depths absorb the
    # residue (points pushed past max_allowed_depth go missed)
    min_level: int = 1
    # hard cap on the relative depth range a patch may cover: the D1 plane
    # codes at the nominal 2D bitdepth AND pdu_3d_range_d has a fixed bit
    # budget (shrunk by ath_pos_delta_max_d_quantizer) — points beyond go
    # missed instead of silently clipping in the video plane or overflowing
    # the coded field
    max_size_d: int = 255
    # enablePointCloudPartitioning (PCCPatchSegmenter.cpp:585-660): ROIs cut
    # along their sorted-longest axes into chunks; connected components
    # never span a chunk boundary.  partition_rois = ((minx,maxx,miny,maxy,
    # minz,maxz), ...); partition_cuts = cuts along (1st,2nd,3rd) longest
    partition_rois: tuple = ()
    partition_cuts: tuple = (0, 0, 0)
    # surfaceSeparation (PCCPatchSegmenter.cpp:1087,1110 + colorSimilarity
    # PCCPatchSegmenter.h:158): a point only joins the D0..D1 column when
    # its color is within +/-128 per channel of the D0 point — dissimilar
    # back-surface points stay missed and re-patch in the next CC round
    surface_separation: bool = False
    rot_offset: int = 1024
    # LoD subsampling (levelOfDetailX/Y): keep only points on the lod grid;
    # off-grid points stay in the missed set (raw-patch recovery)
    level_of_detail_x: int = 1
    level_of_detail_y: int = 1
    # gridBasedSegmentation (convertPointsToVoxels, PCCPatchSegmenter.cpp:78,
    # :148): run normals/PPI/refine/CC on the voxelized cloud, then expand
    # voxel decisions to the member points — ~voxel-ratio x faster on dense
    # clouds with near-identical patch structure
    grid_based_segmentation: bool = False
    voxel_dimension_grid_based_segmentation: int = 2
    # highGradientSeparation (separateHighGradientPoints,
    # PCCPatchSegmenter.cpp:1520): cells whose D0 depth jumps more than
    # min_gradient vs an occupied neighbor cell are edge-on surfaces —
    # evict their points and repartition them to a non-parallel axis
    # (point mode only; ignored under grid_based_segmentation)
    high_gradient_separation: bool = False
    min_gradient: float = 15.0
    min_num_high_gradient_points: int = 256


@dataclasses.dataclass
class SegmentedPatch:
    """A patch plus its patch-space maps (indexed [u, v])."""

    patch: Patch
    depth0: np.ndarray      # (size_u, size_v) int32 relative near depth, -1 = empty
    depth1: np.ndarray      # (size_u, size_v) int32 relative far depth (>= depth0)
    occupancy: np.ndarray   # (size_u, size_v) bool
    point_indices: np.ndarray  # indices into the source cloud covered by [D0, D1]
    eom: np.ndarray | None = None  # (size_u, size_v) uint8 between-layer bits
    # points intentionally dropped by LoD subsampling: consumed (never
    # retried at shifted alignments) but reported missed for raw recovery
    lod_dropped: np.ndarray | None = None
    # points evicted by high-gradient separation: stay unconsumed and get
    # repartitioned to a non-parallel axis before the next CC round
    hg_dropped: np.ndarray | None = None


@partial(jax.jit, static_argnames=("mode",))
def _ppi_scores(
    normals: jax.Array, weights: jax.Array, mode: int = 0
) -> jax.Array:
    dirs = _DIRECTIONS_BY_MODE[mode]
    return jnp.einsum("nc,dc->nd", normals, jnp.asarray(dirs),
                      precision=jax.lax.Precision.HIGHEST) * weights


def _direction_weights(mode: int, axis_weight) -> np.ndarray:
    """Per-direction weight vector: axial directions take the
    enhancedProjectionPlane axis weights, diagonals stay 1 (the reference's
    weightValue table, PCCPatchSegmenter.cpp:233-241)."""
    n = len(_DIRECTIONS_BY_MODE[mode])
    w = np.ones(n, np.float32)
    if axis_weight is not None:
        for a in range(3):
            w[a] = w[a + 3] = float(axis_weight[a])
    return w


def calculate_weight_normal(
    points: np.ndarray, geometry_bits: int, min_weight: float = 0.6
) -> np.ndarray:
    """enhancedProjectionPlane axis weights (calculateWeightNormal,
    PCCEncoder.cpp:3601-3652): per axis, count the occupied faces of the
    orthogonal projection; weights are face-count ratios against the
    best-covered axis, floored at min_weight with the middle axis
    interpolated."""
    p = np.clip(points.astype(np.int64), 0, (1 << geometry_bits) - 1)
    cnt = np.array([
        len(np.unique((p[:, 2] << geometry_bits) + p[:, 1])),  # X faces (YZ)
        len(np.unique((p[:, 0] << geometry_bits) + p[:, 2])),  # Y faces (ZX)
        len(np.unique((p[:, 1] << geometry_bits) + p[:, 0])),  # Z faces (XY)
    ], np.float64)
    order = np.argsort(cnt)  # ascending: [smallest, middle, largest]
    w = np.ones(3, np.float64)
    lo, mid, hi = order
    if cnt[lo] / cnt[hi] >= min_weight:
        w[lo] = cnt[lo] / cnt[hi]
        w[mid] = cnt[mid] / cnt[hi]
        w[hi] = 1.0
    else:
        tmpa = cnt[lo] / cnt[hi]
        tmpb = cnt[mid] / cnt[hi]
        w[lo] = min_weight
        w[hi] = 1.0
        w[mid] = min_weight + (tmpb - tmpa) / (1.0 - tmpa) * (1 - min_weight)
    return w.astype(np.float32)


@jax.jit
def _refine_step(
    ppi: jax.Array, scores: jax.Array, nbr_idx: jax.Array, lam_over_k: jax.Array
) -> jax.Array:
    ndirs = scores.shape[1]
    nbr_ppi = ppi[nbr_idx]                                  # (N, k)
    one_hot = jax.nn.one_hot(nbr_ppi, ndirs, dtype=jnp.float32)
    smooth = one_hot.sum(axis=1)                            # (N, ndirs)
    return jnp.argmax(scores + lam_over_k * smooth, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_iter",))
def _refine_all(
    ppi: jax.Array, scores: jax.Array, nbr_idx: jax.Array,
    lam_over_k: jax.Array, n_iter: int,
) -> jax.Array:
    """All smoothing iterations in ONE device program (a lax.fori_loop) —
    one host round trip instead of n_iter, which matters on high-latency
    links and lets XLA keep the one-hot buffers on chip."""
    def body(_, p):
        return _refine_step(p, scores, nbr_idx, lam_over_k)

    return jax.lax.fori_loop(0, n_iter, body, ppi)


def initial_segmentation(
    normals: np.ndarray, mode: int = 0, axis_weight=None
) -> np.ndarray:
    """PPI = argmax normal . direction (PCCPatchSegmenter3::initialSegmentation)."""
    w = jnp.asarray(_direction_weights(int(mode), axis_weight))
    return np.asarray(
        jnp.argmax(_ppi_scores(jnp.asarray(normals), w, int(mode)), axis=1)
    ).astype(np.int32)


def refine_segmentation(
    normals: np.ndarray,
    ppi: np.ndarray,
    nbr_idx: np.ndarray,
    params: SegmenterParams,
) -> np.ndarray:
    """Iterative KNN smoothing of the PPI partition (refineSegmentation)."""
    scores = _ppi_scores(
        jnp.asarray(normals),
        jnp.asarray(_direction_weights(
            int(params.additional_projection_mode), params.axis_weight
        )),
        int(params.additional_projection_mode),
    )
    p = jnp.asarray(ppi)
    idx = jnp.asarray(nbr_idx[:, : params.max_nn_count_refine_segmentation])
    lam_over_k = jnp.float32(params.lambda_refine_segmentation / idx.shape[1])
    p = _refine_all(
        p, scores, idx, lam_over_k,
        params.iteration_count_refine_segmentation,
    )
    return np.asarray(p)


@partial(jax.jit, static_argnames=("n_iter", "n_vox"))
def _grid_refine_all(
    ppi: jax.Array, scores: jax.Array, inv: jax.Array, adj: jax.Array,
    adj_ok: jax.Array, weights: jax.Array, n_iter: int, n_vox: int,
) -> jax.Array:
    """All grid-based refinement iterations in ONE device program: per
    iteration the per-voxel PPI histogram is rebuilt (segment_sum), summed
    over the voxel adjacency, and every point re-argmaxes its direction
    score plus the weighted neighborhood histogram."""
    ndirs = scores.shape[1]

    def body(_, p):
        hist = jax.ops.segment_sum(
            jax.nn.one_hot(p, ndirs, dtype=jnp.float32), inv,
            num_segments=n_vox,
        )                                                   # (V, ndirs)
        smooth = (hist[adj] * adj_ok[..., None]).sum(axis=1)  # (V, ndirs)
        sc = scores + (weights[:, None] * smooth)[inv]
        return jnp.argmax(sc, axis=1).astype(jnp.int32)

    return jax.lax.fori_loop(0, n_iter, body, ppi)


def refine_segmentation_grid_based(
    points: np.ndarray,
    normals: np.ndarray,
    ppi: np.ndarray,
    params: SegmenterParams,
) -> np.ndarray:
    """refineSegmentationGridBased (PCCPatchSegmenter.cpp:1334-1513): the
    partition smooths over VOXEL-level PPI histograms gathered within a
    search radius, so far fewer neighbor relations are evaluated than in the
    point-KNN variant.  Host/device split: voxelization + radius-limited voxel
    adjacency (truncated once the cumulative member-point count reaches
    maxNNCount, which also fixes the lambda/nnPointCount weight) on host;
    all iterations run as one device program."""
    vdim = max(1, params.voxel_dimension_refine_segmentation)
    half = vdim // 2
    vox = (points.astype(np.int64) + half) // vdim
    key = (vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2]
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    centers = vox[first].astype(np.float32)
    n_vox = len(centers)
    counts = np.bincount(inv, minlength=n_vox).astype(np.int64)
    radius = max(1.0, params.search_radius_refine_segmentation / vdim)
    k = int(min(n_vox, 128))
    tree = cKDTree(centers)
    dist, adj = tree.query(centers, k=k, workers=-1)
    if adj.ndim == 1:
        dist, adj = dist[:, None], adj[:, None]
    ok = dist <= radius
    # truncate each adjacency once the cumulative point count reaches
    # maxNNCount; the weight is lambda over the point count actually summed
    cum = np.cumsum(np.where(ok, counts[adj], 0), axis=1)
    reached = cum >= params.max_nn_count_refine_segmentation
    # keep neighbors up to and including the one that crosses the threshold
    keep = ~np.roll(reached, 1, axis=1)
    keep[:, 0] = True
    ok &= keep
    nn_points = np.maximum(np.where(ok, counts[adj], 0).sum(axis=1), 1)
    weights = (params.lambda_refine_segmentation / nn_points).astype(
        np.float32
    )
    scores = _ppi_scores(
        jnp.asarray(normals),
        jnp.asarray(_direction_weights(
            int(params.additional_projection_mode), params.axis_weight
        )),
        int(params.additional_projection_mode),
    )
    p = _grid_refine_all(
        jnp.asarray(ppi.astype(np.int32)), scores,
        jnp.asarray(inv.astype(np.int32)), jnp.asarray(adj.astype(np.int32)),
        jnp.asarray(ok), jnp.asarray(weights),
        params.iteration_count_refine_segmentation, n_vox,
    )
    return np.asarray(p)


def _quantize_size_d(size_d: int, min_level: int) -> int:
    """quantDD rounding: the coded depth range is ceil((sizeD)/minLevel)
    units, decoded as units*minLevel - 1 (PCCEncoder.cpp:1166,
    PCCDecoder.cpp:953)."""
    if min_level <= 1 or size_d <= 0:
        return max(0, size_d)
    units = (size_d - 1) // min_level + 1
    return units * min_level - 1


def _chunk_ids(points: np.ndarray, rois, cuts) -> np.ndarray:
    """Per-point chunk labels for enablePointCloudPartitioning
    (PCCPatchSegmenter.cpp:585-660): each ROI's bounding box is cut into
    (cuts[k]+1) equal ranges along its k-th longest axis; points outside all
    ROIs share chunk 0 of the nearest... the reference requires ROIs to
    cover the cloud, so out-of-ROI points get the last matching ROI's grid
    clamped to its edge."""
    n = len(points)
    ids = np.zeros(n, np.int64)
    pts = points.astype(np.float64)
    base = 1
    for r, (x0, x1, y0, y1, z0, z1) in enumerate(rois):
        lo = np.array([x0, y0, z0], np.float64)
        hi = np.array([x1, y1, z1], np.float64)
        inside = ((pts >= lo) & (pts <= hi)).all(axis=1)
        if not inside.any():
            continue
        lens = hi - lo
        order = np.argsort(-lens)              # axes, longest first
        ncuts = np.zeros(3, np.int64)
        for rank in range(3):
            ncuts[order[rank]] = max(0, int(cuts[rank]))
        buckets = np.zeros((n, 3), np.int64)
        for a in range(3):
            nb = ncuts[a] + 1
            span = max(lens[a], 1e-9)
            buckets[:, a] = np.clip(
                ((pts[:, a] - lo[a]) * nb / (span + 1e-9)).astype(np.int64),
                0, nb - 1,
            )
        local = buckets[:, 0] + (ncuts[0] + 1) * (
            buckets[:, 1] + (ncuts[1] + 1) * buckets[:, 2]
        )
        ids = np.where(inside, base + local, ids)
        base += int(np.prod(ncuts + 1))
    return ids


def _candidate_edges(
    nbr_idx: np.ndarray,
    ppi: np.ndarray,
    points: np.ndarray,
    max_edge_dist: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Static edge set (same-PPI, within max_edge_dist) computed ONCE per
    frame; the missed-points loop only re-filters by its shrinking mask."""
    n, k = nbr_idx.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = nbr_idx.reshape(-1)
    diff = points[src].astype(np.int32) - points[dst].astype(np.int32)
    edge_d2 = np.einsum("nc,nc->n", diff, diff)
    keep = (ppi[src] == ppi[dst]) & (
        edge_d2 <= int(max_edge_dist * max_edge_dist)
    )
    return src[keep], dst[keep]


def _connected_components(
    src: np.ndarray,
    dst: np.ndarray,
    mask: np.ndarray,
    n: int,
) -> tuple[np.ndarray, int]:
    """Connected components over the precomputed edge set restricted to
    `mask`.  Returns (labels (N,), n_components); labels -1 off-mask."""
    keep = mask[src] & mask[dst]
    s2, d2 = src[keep], dst[keep]
    graph = sp.coo_matrix(
        (np.ones(len(s2), np.int8), (s2, d2)), shape=(n, n)
    ).tocsr()
    ncomp, labels = sp.csgraph.connected_components(graph, directed=False)
    labels = labels.copy()
    labels[~mask] = -1
    return labels, ncomp


def _inverse_rotate45(pts: np.ndarray, axis: int, offset: int) -> np.ndarray:
    """Float inverse of rotate45 (cell centers may land on half-integers)."""
    a = pts[:, 0].astype(np.float64)
    b = pts[:, 1].astype(np.float64)
    c = pts[:, 2].astype(np.float64)
    if axis == 1:   # a = x+z, c = z-x+offset
        return np.stack([(a - (c - offset)) / 2, b, (a + (c - offset)) / 2], 1)
    if axis == 2:   # b = y-z+offset, c = y+z
        return np.stack([a, ((b - offset) + c) / 2, (c - (b - offset)) / 2], 1)
    if axis == 3:   # a = x-y+offset, b = x+y
        return np.stack([((a - offset) + b) / 2, ((b - (a - offset))) / 2, c], 1)
    raise ValueError(f"bad rotation axis {axis}")


def _resampled_positions(seg: SegmentedPatch) -> np.ndarray:
    """3D positions of the patch's D0+D1 samples (the reference `resampled`
    cloud, PCCPatchSegmenter.cpp segmentPatches) in source coordinates."""
    p = seg.patch
    occ = seg.occupancy
    uu, vv = np.nonzero(occ)
    layers = []
    d1_min = p.d1 if p.projection_mode == 0 else -p.d1

    def _layer(uu_, vv_, rel_):
        dd = rel_.astype(np.int64) + d1_min
        d = dd if p.projection_mode == 0 else -dd
        xyz = np.zeros((len(uu_), 3), np.int64)
        xyz[:, p.tangent_axis] = p.u1 + uu_.astype(np.int64) * p.lod_x
        xyz[:, p.bitangent_axis] = p.v1 + vv_.astype(np.int64) * p.lod_y
        xyz[:, p.normal_axis] = d
        return xyz

    for depth in (seg.depth0, seg.depth1):
        layers.append(_layer(uu, vv, depth[uu, vv]))
    if seg.eom is not None and seg.eom.any():
        bits = seg.eom[uu, vv].astype(np.int64)
        base = seg.depth0[uu, vv].astype(np.int64)
        for i in range(8):
            sel = (bits >> i) & 1 > 0
            if sel.any():
                layers.append(_layer(uu[sel], vv[sel], base[sel] + i + 1))
    out = np.unique(np.concatenate(layers), axis=0).astype(np.float64)
    if p.rotation_axis:
        out = _inverse_rotate45(out, p.rotation_axis, p.rot_offset)
    return out


def segment_patches(
    points: np.ndarray,
    ppi: np.ndarray,
    nbr_idx: np.ndarray,
    params: SegmenterParams,
    voxel_map: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
) -> tuple[list[SegmentedPatch], np.ndarray]:
    """Connected components -> patches with D0 depth maps; missed points are
    re-segmented for up to max_missed_point_iterations rounds
    (PCCPatchSegmenter3::segmentPatches concept).

    voxel_map (gridBasedSegmentation): (inv point->voxel, voxel grid coords,
    voxel ppi) — the CC graph then lives on voxels (nbr_idx is the VOXEL
    knn graph) and voxel components expand to their member points.

    Returns (patches, indices of points never covered by any patch)."""
    n = len(points)
    remaining = np.ones(n, bool)
    # NN dist^2 of every source point to the resampled reconstruction so
    # far (inf before any patch exists); drives the selection/detection
    # thresholds (PCCPatchSegmenter.cpp:778,1261)
    raw_dist2 = np.full(n, np.inf)
    sel_thr = params.max_allowed_dist2_raw_points_selection
    det_thr = params.max_allowed_dist2_raw_points_detection
    lod_consumed = np.zeros(n, bool)
    patches: list[SegmentedPatch] = []
    lod_missed: list[np.ndarray] = []
    hg_batch: list[np.ndarray] = []
    ppi = np.asarray(ppi).copy()  # high-gradient eviction repartitions in place
    k_cc = params.max_nn_count_patch_segmentation or nbr_idx.shape[1]
    cc_nbr = nbr_idx[:, :k_cc]
    if voxel_map is None:
        inv = None
        n_nodes = n
        edge_src, edge_dst = _candidate_edges(
            cc_nbr, ppi, points, params.max_cc_edge_distance
        )
        if params.partition_rois and any(c > 0 for c in
                                         params.partition_cuts):
            # enablePointCloudPartitioning: components never span a chunk
            chunks = _chunk_ids(points, params.partition_rois,
                                params.partition_cuts)
            keep = chunks[edge_src] == chunks[edge_dst]
            edge_src, edge_dst = edge_src[keep], edge_dst[keep]
    else:
        inv, node_pos, node_ppi = voxel_map
        n_nodes = len(node_pos)
        edge_src, edge_dst = _candidate_edges(
            cc_nbr, node_ppi, node_pos, params.max_cc_edge_distance
        )

    expansion_claimed = np.zeros(n, bool)
    for _ in range(params.max_missed_point_iterations):
        if remaining.sum() < params.min_point_count_per_cc_patch_segmentation:
            break
        if inv is None:
            node_mask = remaining
        else:
            node_mask = np.zeros(n_nodes, bool)
            node_mask[inv[remaining]] = True
        labels, ncomp = _connected_components(
            edge_src, edge_dst, node_mask, n_nodes
        )
        if ncomp == 0:
            break
        if inv is not None:
            labels = np.where(remaining, labels[inv], -1)
        # group point indices by component via one sort (the per-component
        # nonzero() scan is O(ncomp * N) and ncomp can be ~N)
        on_mask = labels >= 0
        order = np.argsort(labels[on_mask], kind="stable")
        pts_sorted = np.nonzero(on_mask)[0][order]
        uniq, starts = np.unique(labels[pts_sorted], return_index=True)
        bounds = np.append(starts, len(pts_sorted))
        made_progress = False
        round_segs: list[SegmentedPatch] = []
        comps = [
            pts_sorted[bounds[ci] : bounds[ci + 1]]
            for ci in range(len(uniq))
        ]
        if params.patch_expansion:
            comps.sort(key=len)  # pop() processes largest first
        absorbed_this_round = np.zeros(n, bool)
        while comps:
            idx = comps.pop()
            if params.patch_expansion:
                # points absorbed into an earlier (larger) component this
                # round must leave their donor component or they would code
                # twice; uncovered ones legitimately re-cluster next round
                idx = idx[~absorbed_this_round[idx]]
            if len(idx) < params.min_point_count_per_cc_patch_segmentation:
                continue
            # detection threshold: a component of only mildly-missed points
            # (all raw_dist2 <= detection) is already represented well
            # enough and is not re-patched (PCCPatchSegmenter.cpp:778)
            if not (raw_dist2[idx] > det_thr).any():
                continue
            if params.patch_expansion and inv is None:
                # absorb unclaimed adjacent points of other (non-opposite)
                # partitions within dist^2 <= 2 (PCCPatchSegmenter.cpp:
                # 925-945; components processed largest-first)
                c = int(ppi[idx[0]])
                cand = cc_nbr[idx].reshape(-1)
                diff = points[np.repeat(idx, cc_nbr.shape[1])].astype(
                    np.int64) - points[cand].astype(np.int64)
                d2 = np.einsum("nc,nc->n", diff, diff)
                pn = ppi[cand]
                ok = (
                    (d2 <= 2) & ~expansion_claimed[cand] & remaining[cand]
                    & (pn != c) & (pn != c + 3) & (pn + 3 != c)
                )
                extra = np.unique(cand[ok])
                if len(extra):
                    expansion_claimed[extra] = True
                    absorbed_this_round[extra] = True
                    idx = np.concatenate([idx, extra])
            expansion_claimed[idx] = True
            if params.max_patch_size > 0 and params.enable_patch_splitting:
                halves = _split_oversized(points, idx, int(ppi[idx[0]]),
                                          params)
                if halves is not None:
                    comps.extend(halves)
                    continue
            seg = _build_patch(points, idx, int(ppi[idx[0]]), params,
                               len(patches), colors=colors)
            if seg is None:
                continue
            patches.append(seg)
            round_segs.append(seg)
            remaining[seg.point_indices] = False
            if seg.lod_dropped is not None:
                remaining[seg.lod_dropped] = False
                lod_consumed[seg.lod_dropped] = True
                lod_missed.append(seg.lod_dropped)
            if seg.hg_dropped is not None:
                hg_batch.append(seg.hg_dropped)
            made_progress = True
        if round_segs:
            # refresh raw_dist2 against this round's new resampled samples
            # (min over the union == min of incremental minima); only the
            # still-missed candidates need the query
            res = np.concatenate([_resampled_positions(s)
                                  for s in round_segs])
            cand = raw_dist2 > sel_thr
            if cand.any():
                dn, _ = cKDTree(res).query(
                    points[cand].astype(np.float64), k=1, workers=-1
                )
                raw_dist2[cand] = np.minimum(raw_dist2[cand], dn * dn)
            remaining = (raw_dist2 > sel_thr) & ~lod_consumed
        if hg_batch and normals is not None:
            # repartition evicted high-gradient points to their best
            # NON-parallel axial direction and extend the edge set so the
            # next CC round can regroup (or rejoin) them there
            hg = np.concatenate(hg_batch)
            hg_batch = []
            dirs = np.asarray(_DIRECTIONS_6, np.float32)
            sc = normals[hg].astype(np.float32) @ dirs.T      # (M, 6)
            old_axis = (ppi[hg] % 3)[:, None]
            sc = np.where(np.arange(6)[None, :] % 3 == old_axis,
                          -np.inf, sc)
            ppi[hg] = np.argmax(sc, axis=1).astype(ppi.dtype)
            src = np.repeat(hg.astype(np.int32), nbr_idx.shape[1])
            dst = nbr_idx[hg].reshape(-1)
            diff = points[src].astype(np.int32) - points[dst].astype(
                np.int32
            )
            d2 = np.einsum("nc,nc->n", diff, diff)
            lim = int(params.max_cc_edge_distance ** 2)
            keep = (ppi[src] == ppi[dst]) & (d2 <= lim)
            edge_src = np.concatenate([edge_src, src[keep]])
            edge_dst = np.concatenate([edge_dst, dst[keep]])
            made_progress = made_progress or bool(keep.any())
        if not made_progress:
            break

    missed = np.nonzero(remaining)[0]
    if lod_missed:
        missed = np.unique(np.concatenate([missed] + lod_missed))
    return patches, missed


def _split_oversized(
    points: np.ndarray, idx: np.ndarray, ppi: int, params: SegmenterParams
) -> list[np.ndarray] | None:
    """maxPatchSize splitting (reference enablePatchSplitting/maxPatchSize):
    when a component's tangent/bitangent extent exceeds max_patch_size,
    split it at the median of the longer axis.  Returns the two halves, or
    None when the component already fits."""
    view_id = ppi_to_view_id(ppi, params.additional_projection_mode)
    _, tangent, bitangent, _, rot = _axes_of(view_id)
    pts = rotate45(points[idx], rot, params.rot_offset) if rot else points[idx]
    spans = [
        int(pts[:, ax].max()) - int(pts[:, ax].min()) + 1
        for ax in (tangent, bitangent)
    ]
    if max(spans) <= params.max_patch_size:
        return None
    ax = (tangent, bitangent)[int(np.argmax(spans))]
    cut = np.median(pts[:, ax])
    left = idx[pts[:, ax] <= cut]
    right = idx[pts[:, ax] > cut]
    if len(left) == 0 or len(right) == 0:
        return None  # degenerate (all points at the median): keep as is
    return [left, right]


def _build_patch(
    points: np.ndarray,
    idx: np.ndarray,
    ppi: int,
    params: SegmenterParams,
    patch_index: int,
    colors: np.ndarray | None = None,
) -> SegmentedPatch | None:
    view_id = ppi_to_view_id(ppi, params.additional_projection_mode)
    normal, tangent, bitangent, mode, rot = _axes_of(view_id)
    if rot:
        pts = rotate45(points[idx], rot, params.rot_offset)
    else:
        pts = points[idx]
    u = pts[:, tangent]
    v = pts[:, bitangent]
    d = pts[:, normal]
    u1, v1 = int(u.min()), int(v.min())
    lod_x, lod_y = params.level_of_detail_x, params.level_of_detail_y
    lod_dropped = None
    if lod_x > 1 or lod_y > 1:
        # LoD: only points on the (lod_x, lod_y) tangent grid are coded;
        # the rest go straight to the missed set (NOT retried, which would
        # just re-cover them at shifted grid alignments); patch grid coords
        # are divided, reconstruction multiplies back via pdu_lod_scale_*
        on_grid = ((u - u1) % lod_x == 0) & ((v - v1) % lod_y == 0)
        if on_grid.sum() < params.min_point_count_per_cc_patch_segmentation:
            return None
        lod_dropped = idx[~on_grid]
        idx = idx[on_grid]
        pts = pts[on_grid]
        u, v, d = pts[:, tangent], pts[:, bitangent], pts[:, normal]
        u = (u - u1) // lod_x + u1
        v = (v - v1) // lod_y + v1
    size_u = int(u.max()) - u1 + 1
    size_v = int(v.max()) - v1 + 1
    uu = (u - u1).astype(np.int64)
    vv = (v - v1).astype(np.int64)
    flat = uu * size_v + vv

    # D0: near layer — min depth for mode 0, max for mode 1 (internal space
    # negates mode-1 depths so min/max logic is uniform)
    d0 = np.full(size_u * size_v, 1 << 30, np.int64)
    dd = d.astype(np.int64) if mode == 0 else -d.astype(np.int64)
    np.minimum.at(d0, flat, dd)
    occupied = d0 != (1 << 30)
    if not occupied.any():
        return None
    d1 = int(d0[occupied].min())
    if params.min_level > 1:
        # depthQuantizationStep: floor (toward -inf, so both projection
        # modes stay rel>=0) to a minLevel multiple; the relative depths
        # grow by the residue and pdu_3d_offset_d codes d1 >> quantizer
        d1 = (d1 // params.min_level) * params.min_level
    rel = np.where(occupied, d0 - d1, -1)
    # depth-range clamp: cells too deep are dropped (their points stay missed)
    too_deep = occupied & (rel > params.max_allowed_depth)
    rel[too_deep] = -1
    occupied &= ~too_deep

    # high-gradient separation: cells whose D0 depth jumps sharply vs an
    # occupied 4-neighbor are edge-on surfaces projected badly on this axis
    # (separateHighGradientPoints, PCCPatchSegmenter.cpp:1520); evict them
    hg_dropped = None
    if (params.high_gradient_separation
            and not params.grid_based_segmentation):
        grid = rel.reshape(size_u, size_v)
        og = grid >= 0
        g = np.zeros((size_u, size_v), np.int64)
        du_ = np.abs(grid[1:, :] - grid[:-1, :])
        m = og[1:, :] & og[:-1, :]
        g[1:, :] = np.maximum(g[1:, :], np.where(m, du_, 0))
        g[:-1, :] = np.maximum(g[:-1, :], np.where(m, du_, 0))
        dv_ = np.abs(grid[:, 1:] - grid[:, :-1])
        m = og[:, 1:] & og[:, :-1]
        g[:, 1:] = np.maximum(g[:, 1:], np.where(m, dv_, 0))
        g[:, :-1] = np.maximum(g[:, :-1], np.where(m, dv_, 0))
        high = (og & (g > params.min_gradient)).reshape(-1)
        in_high = high[flat]
        if in_high.sum() >= params.min_num_high_gradient_points:
            hg_dropped = idx[in_high]
            rel[high] = -1
            occupied &= ~high
            if not occupied.any():
                return None

    # points covered: within surface_thickness of the D0 surface
    cell_rel = rel[flat]
    pt_rel = dd - d1
    covered = (cell_rel >= 0) & (pt_rel - cell_rel <= params.surface_thickness) & (
        pt_rel >= cell_rel
    ) & (pt_rel <= min(params.max_allowed_depth, params.max_size_d))
    if params.surface_separation and colors is not None:
        # surfaceSeparation: only color-similar points join the D0 column
        # (colorSimilarity threshold 128, PCCPatchSegmenter.h:158); the
        # dissimilar back surface stays missed and re-patches next round
        order = np.lexsort((dd, flat))
        uf, first = np.unique(flat[order], return_index=True)
        d0_idx = np.full(size_u * size_v, -1, np.int64)
        d0_idx[uf] = idx[order[first]]
        ref_idx = d0_idx[flat]
        ref_c = colors[np.clip(ref_idx, 0, len(colors) - 1)].astype(np.int16)
        own_c = colors[idx].astype(np.int16)
        similar = (np.abs(own_c - ref_c) < 128).all(axis=1)
        covered &= similar | (ref_idx < 0)
    if covered.sum() < params.min_point_count_per_cc_patch_segmentation:
        return None

    # D1: far layer — max covered depth per cell (the dual-map far surface,
    # PCCPatchSegmenter3 D0/D1 depth maps)
    d1_map = np.full(size_u * size_v, -(1 << 30), np.int64)
    np.maximum.at(d1_map, flat[covered], pt_rel[covered])
    rel1 = np.where(occupied, np.maximum(d1_map, rel), -1)

    # EOM bit masks: covered points strictly between D0 and D1
    from ..codec.eom import eom_bits_for_cells

    eom = eom_bits_for_cells(
        pt_rel[covered], flat[covered], rel, rel1,
        max_bits=params.eom_fix_bit_count,
    ).reshape(size_u, size_v)
    if params.eom_fix_bit_count < 7:
        # interior points beyond the EOM bit budget are not representable:
        # un-cover them so they rejoin the missed set (raw recovery)
        d0v = rel[flat]
        d1v = rel1.reshape(-1)[flat]
        interior = (d0v >= 0) & (pt_rel > d0v) & (pt_rel < d1v)
        over = interior & (pt_rel - d0v - 1 >= params.eom_fix_bit_count)
        covered &= ~over

    patch = Patch(
        index=patch_index,
        rotation_axis=rot,
        rot_offset=params.rot_offset,
        size_u=size_u,
        size_v=size_v,
        size_u0=(size_u + 15) // 16,
        size_v0=(size_v + 15) // 16,
        u1=u1,
        v1=v1,
        d1=d1 if mode == 0 else -d1,
        # minLevel>1 also quantizes the CODED depth range up (quantDD,
        # PCCDecoder.cpp:953: sizeD = quantDD*minLevel - 1) so both sides
        # carry the identical decoded value
        size_d=(
            _quantize_size_d(int(rel1.max()), params.min_level)
            if occupied.any() else 0
        ),
        normal_axis=normal,
        tangent_axis=tangent,
        bitangent_axis=bitangent,
        projection_mode=mode,
        patch_type=PatchType.INTRA,
        lod_x=lod_x,
        lod_y=lod_y,
    )
    return SegmentedPatch(
        patch=patch,
        depth0=rel.reshape(size_u, size_v).astype(np.int32),
        depth1=rel1.reshape(size_u, size_v).astype(np.int32),
        occupancy=occupied.reshape(size_u, size_v),
        point_indices=idx[covered],
        eom=eom,
        lod_dropped=lod_dropped,
        hg_dropped=hg_dropped,
    )


def _segmentation_normals(
    points: np.ndarray, params: SegmenterParams, nbr_idx: np.ndarray
) -> np.ndarray:
    """Normals with the configured orientation strategy (normalOrientation).
    Strategy 1 (spanning tree) is the default fast path shared with every
    earlier round; other strategies route through generate_normals."""
    if params.normal_orientation == 1:
        normals, _ = compute_normals(
            points, k=params.nn_normal_estimation,
            nbr_idx=nbr_idx[:, : params.nn_normal_estimation],
        )
        return normals
    from .normals import NormalsGenParams, generate_normals

    return generate_normals(
        points.astype(np.float32),
        NormalsGenParams(
            knn_normal_estimation=params.nn_normal_estimation,
            knn_normal_orientation=params.nn_normal_estimation,
            orientation_strategy=params.normal_orientation,
        ),
    )["normals"]


def _refine_dispatch(
    points: np.ndarray, normals: np.ndarray, ppi: np.ndarray,
    nbr_idx: np.ndarray, params: SegmenterParams,
) -> np.ndarray:
    if params.grid_based_refine_segmentation:
        return refine_segmentation_grid_based(points, normals, ppi, params)
    return refine_segmentation(normals, ppi, nbr_idx, params)


def segment_frame(
    points: np.ndarray, params: SegmenterParams | None = None,
    colors: np.ndarray | None = None,
) -> tuple[list[SegmentedPatch], np.ndarray]:
    """Full per-frame segmentation: normals -> PPI -> refine -> patches."""
    params = params or SegmenterParams()
    k = max(params.nn_normal_estimation,
            params.max_nn_count_refine_segmentation)
    if (params.grid_based_segmentation
            and len(points)
            > 4 * params.min_point_count_per_cc_patch_segmentation):
        # convertPointsToVoxels: normals/PPI/refine/CC on the voxel cloud
        vdim = max(1, params.voxel_dimension_grid_based_segmentation)
        vox = points.astype(np.int64) // vdim
        key = (vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2]
        _, first, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        vox_pos = vox[first].astype(np.int32)
        nbr_v = knn_indices(vox_pos, k)
        normals_v = _segmentation_normals(vox_pos, params, nbr_v)
        ppi_v = initial_segmentation(
            normals_v, params.additional_projection_mode,
            params.axis_weight,
        )
        ppi_v = _refine_dispatch(vox_pos, normals_v, ppi_v, nbr_v, params)
        return segment_patches(
            points, ppi_v[inv].astype(np.int32), nbr_v, params,
            voxel_map=(inv.astype(np.int32), vox_pos, ppi_v),
            colors=colors,
        )
    nbr = knn_indices(points, k)
    normals = _segmentation_normals(points, params, nbr)
    ppi = initial_segmentation(
        normals, params.additional_projection_mode, params.axis_weight
    )
    ppi = _refine_dispatch(points, normals, ppi, nbr, params)
    return segment_patches(points, ppi, nbr, params, normals=normals,
                           colors=colors)


def refine_occupancy(
    seg: SegmentedPatch,
    points: np.ndarray,
    occ_resolution: int,
    occ_precision: int,
    rot_offset: int = 1024,
) -> np.ndarray:
    """occupancyMapRefinement (PCCEncoder::refineOccupancyMap,
    PCCEncoder.cpp:3818-3905): drop precision tiles holding exactly ONE
    point (they become full occ_precision^2 junk blocks after downscale)
    and 16x16 blocks with fewer than 4 points.  Dropped points return as
    indices into the source cloud (they rejoin the missed set -> raw
    patch, strictly better than the reference which just loses them)."""
    patch = seg.patch
    if patch.lod_x > 1 or patch.lod_y > 1:
        return np.zeros(0, np.int64)
    occ = seg.occupancy
    su, sv = occ.shape
    work = occ.copy()
    drop = np.zeros((su, sv), bool)

    def _tile_mask(o: np.ndarray, ts: int, pred) -> np.ndarray:
        pu, pv = -(-su // ts) * ts, -(-sv // ts) * ts
        pad = np.zeros((pu, pv), bool)
        pad[:su, :sv] = o
        cnt = pad.reshape(pu // ts, ts, pv // ts, ts).sum(axis=(1, 3))
        m = pred(cnt)
        return np.repeat(np.repeat(m, ts, 0), ts, 1)[:su, :sv]

    if occ_precision > 1:
        m = _tile_mask(work, occ_precision, lambda c: c == 1)
        drop |= m & work
        work &= ~m
    m16 = _tile_mask(work, occ_resolution, lambda c: (c > 0) & (c < 4))
    drop |= m16 & work
    work &= ~m16
    if not drop.any() or not work.any():
        return np.zeros(0, np.int64)
    seg.occupancy = work
    seg.depth0[drop] = -1
    seg.depth1[drop] = -1
    if seg.eom is not None:
        seg.eom[drop] = 0
    # map covered points to their patch cells to find the dropped ones
    pts = (
        rotate45(points[seg.point_indices], patch.rotation_axis, rot_offset)
        if patch.rotation_axis
        else points[seg.point_indices]
    )
    uu = pts[:, patch.tangent_axis] - patch.u1
    vv = pts[:, patch.bitangent_axis] - patch.v1
    ok = (uu >= 0) & (uu < su) & (vv >= 0) & (vv < sv)
    in_drop = np.zeros(len(uu), bool)
    in_drop[ok] = drop[uu[ok], vv[ok]]
    dropped = seg.point_indices[in_drop]
    seg.point_indices = seg.point_indices[~in_drop]
    return dropped


def segment_frame_partial(
    points: np.ndarray, params: SegmenterParams, ratio: float,
    colors: np.ndarray | None = None,
) -> tuple[list[SegmentedPatch], np.ndarray]:
    """additionalProjectionPlaneMode 5 (PCCEncoder.cpp:8826-8901
    segmentationPartiallyAddtinalProjectionPlane): the whole cloud segments
    with the 6 canonical planes; the top `ratio` slice along the longest
    axis re-segments with the diagonal planes about that axis and only the
    DIAGONAL patches of that pass are kept (duplicates resolve at
    reconstruction dedup; the canonical pass defines the missed set, minus
    points the diagonal patches cover)."""
    import dataclasses as _dc

    base = _dc.replace(params, additional_projection_mode=0)
    segs, missed = segment_frame(points, base, colors=colors)

    spans = points.max(axis=0) - points.min(axis=0)
    axis = int(np.argmax(spans))          # 0=X, 1=Y, 2=Z (longest)
    # reference axis ids 1/2/3 -> diagonal mode: X->2, Y->1, Z->3
    mode = {0: 2, 1: 1, 2: 3}[axis]
    lo = points[:, axis].min()
    cut = lo + spans[axis] * (1.0 - ratio)
    slice_idx = np.nonzero(points[:, axis] > cut)[0]
    if len(slice_idx) >= params.min_point_count_per_cc_patch_segmentation:
        extra = _dc.replace(params, additional_projection_mode=mode)
        segs_a, _ = segment_frame(
            np.ascontiguousarray(points[slice_idx]), extra,
            colors=None if colors is None else colors[slice_idx],
        )
        covered_extra = []
        for seg in segs_a:
            if seg.patch.rotation_axis == 0:
                continue  # keep only the diagonal patches (reference :8888)
            seg.point_indices = slice_idx[seg.point_indices]
            if seg.lod_dropped is not None:
                seg.lod_dropped = slice_idx[seg.lod_dropped]
            seg.patch.index = len(segs)
            segs.append(seg)
            covered_extra.append(seg.point_indices)
        if covered_extra:
            missed = np.setdiff1d(
                missed, np.concatenate(covered_extra), assume_unique=False
            )
    return segs, missed
