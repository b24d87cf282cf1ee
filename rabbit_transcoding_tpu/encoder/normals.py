"""Normal estimation: PCA over KNN neighborhoods.

Capability parity with PCCNormalsGenerator3 (/root/reference/source/lib/
PccLibEncoder/source/PCCNormalsGenerator.cpp:61-533): per-point normals from
the eigen-decomposition of the local covariance, then sign orientation.

Host/device split: the KNN graph is built once on host (scipy cKDTree — the
nanoflann analog); the per-point covariance + eigh and every later
consumer of the graph (segmentation refinement) run batched on device.
Orientation uses viewpoint disambiguation (flip toward the outward ray from
the cloud centroid) followed by KNN sign-consistency voting sweeps — a
parallel-friendly substitute for the reference's sequential spanning-tree
propagation (orientNormals :178)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

# full float32 products: a float32 product may otherwise run in TF32 on
# a GPU, and these 3-wide dots gain nothing from it
_HIGHEST = jax.lax.Precision.HIGHEST


def _grid_knn(points: np.ndarray, k: int):
    """Native voxel-grid exact KNN when points are integral (V-PCC clouds
    always are); None -> caller falls back to cKDTree."""
    from .. import native

    if len(points) == 0:
        return None
    if not np.issubdtype(points.dtype, np.integer):
        if np.abs(points).max() >= 2**30 or (points != np.round(points)).any():
            return None
    try:
        return native.knn_grid(points, points, k)
    except (RuntimeError, ValueError, OverflowError):
        return None


def knn_indices(points: np.ndarray, k: int) -> np.ndarray:
    """(N, 3) -> (N, k) neighbor indices (self included as first column)."""
    got = _grid_knn(points, k)
    if got is not None:
        idx = got[0]
        return np.where(idx < 0, idx[:, :1], idx)  # tiny clouds: self pad
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)), workers=-1)
    if idx.ndim == 1:
        idx = idx[:, None]
    if idx.shape[1] < k:  # tiny clouds: pad with self
        pad = np.repeat(idx[:, :1], k - idx.shape[1], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return idx.astype(np.int32)


@jax.jit
def _pca_normals(points: jax.Array, nbr_idx: jax.Array) -> jax.Array:
    """Smallest-eigenvector normals of local covariance, batched per point."""
    nbrs = points[nbr_idx]                      # (N, k, 3)
    mean = nbrs.mean(axis=1, keepdims=True)
    centered = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered,
                     precision=_HIGHEST)
    # eigh returns ascending eigenvalues; the smallest's vector is the normal
    _, vecs = jnp.linalg.eigh(cov)
    return vecs[:, :, 0]


@jax.jit
def _orient_sweep(normals: jax.Array, nbr_idx: jax.Array) -> jax.Array:
    """One sign-consistency sweep: flip each normal if the majority of its
    neighbors' normals disagree in sign."""
    nbr_n = normals[nbr_idx]                    # (N, k, 3)
    agree = jnp.einsum("nkc,nc->nk", nbr_n, normals, precision=_HIGHEST)
    vote = agree.sum(axis=1)
    return jnp.where(vote[:, None] < 0, -normals, normals)


from functools import partial  # noqa: E402


@partial(jax.jit, static_argnames=("sweeps",))
def _orient_all(
    normals: jax.Array, points: jax.Array, nbr_idx: jax.Array, sweeps: int
) -> jax.Array:
    """Viewpoint disambiguation + all consistency sweeps + normalisation in
    ONE device program (one host round trip on high-latency links)."""
    centroid = points.mean(axis=0, keepdims=True)
    outward = points - centroid
    flip = jnp.einsum("nc,nc->n", normals, outward,
                      precision=_HIGHEST) < 0
    n = jnp.where(flip[:, None], -normals, normals)
    n = jax.lax.fori_loop(
        0, sweeps, lambda _, x: _orient_sweep(x, nbr_idx), n
    )
    return n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def orient_spanning_tree(
    normals: np.ndarray,
    points: np.ndarray,
    nbr_idx: np.ndarray,
    nbr_ok: np.ndarray | None = None,
    viewpoint: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """TRUE spanning-tree sign propagation (orientNormals,
    PCCNormalsGenerator.cpp:178-234): grow a maximum spanning tree over the
    KNN graph with |n_a.n_b| edge weights, flipping each point to agree
    with its tree parent; per-component seeding from visited neighbours
    and a final majority flip toward the viewpoint.

    Inherently sequential, so it runs in native C++
    (native/normals_tree.cpp); raises RuntimeError when the native library
    is unavailable — callers fall back to the sweep orientation."""
    from .. import native

    out = np.ascontiguousarray(normals, np.float32).copy()
    if nbr_ok is None:
        nbr_ok = np.ones(nbr_idx.shape, np.uint8)
    native.orient_normals_tree(
        out, points.astype(np.float32), nbr_idx, nbr_ok,
        np.asarray(viewpoint, np.float32),
    )
    return out


def compute_normals(
    points: np.ndarray,
    k: int = 16,
    orient_sweeps: int = 2,
    nbr_idx: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (normals (N,3) float32 unit, knn indices (N,k)).  The KNN graph is
    returned for reuse by segmentation refinement.

    Orientation: spanning-tree propagation (the reference's default — it
    follows the surface, so thin sheets and multi-body scenes keep outward
    normals where global-viewpoint sweeps mis-orient; see
    tests/test_normals_orientation.py for the A/B).  Falls back to the
    fused viewpoint+consistency-sweep device program when the native
    library is unavailable."""
    if nbr_idx is None:
        nbr_idx = knn_indices(points, k)
    pts = jnp.asarray(points.astype(np.float32))
    idx = jnp.asarray(nbr_idx)
    n = _pca_normals(pts, idx)
    try:
        n_np = orient_spanning_tree(np.asarray(n), points, nbr_idx)
        norm = np.linalg.norm(n_np, axis=1, keepdims=True)
        return (n_np / np.maximum(norm, 1e-12)).astype(np.float32), \
            np.asarray(nbr_idx)
    except RuntimeError:
        # viewpoint disambiguation + consistency sweeps, one device program
        n = _orient_all(n, pts, idx, orient_sweeps)
        return np.asarray(n), np.asarray(nbr_idx)


# ---------------------------------------------------------------------------
# Full PCCNormalsGenerator3 parameter surface (PccAppNormalGenerator analog).
#
# The reference (PCCNormalsGenerator.cpp:61-575 + PccAppNormalGenerator.cpp)
# exposes per-stage KNN counts, radius caps, iterative normal smoothing and
# four orientation strategies.  Same capabilities here, but each stage is one
# batched device program over a host-built KNN graph instead of per-point TBB
# loops.

import dataclasses  # noqa: E402


@dataclasses.dataclass
class NormalsGenParams:
    """PCCNormalsGenerator3Parameters analog (PCCNormalsGenerator.h)."""

    view_point: tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius_normal_smoothing: float = float("inf")
    radius_normal_estimation: float = float("inf")
    radius_normal_orientation: float = float("inf")
    weight_normal_smoothing: float = float("inf")  # MAX_VAL → pure neighbor avg
    knn_normal_smoothing: int = 16
    knn_normal_estimation: int = 16
    knn_normal_orientation: int = 16
    smoothing_iterations: int = 0
    # 0 NONE | 1 SPANNING_TREE | 2 VIEW_POINT | 3 CUBEMAP_PROJECTION
    orientation_strategy: int = 1
    store_eigenvalues: bool = False
    store_number_of_nearest_neighbors: bool = False
    store_centroids: bool = False


def knn_graph(points: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(N,3) -> ((N,k) indices incl. self, (N,k) distances)."""
    got = _grid_knn(points, k)
    if got is not None:
        idx, d2 = got
        return (np.where(idx < 0, idx[:, :1], idx),
                np.sqrt(d2))  # -1 pads carry inf distance already
    tree = cKDTree(points)
    dist, idx = tree.query(points, k=min(k, len(points)), workers=-1)
    if idx.ndim == 1:
        idx, dist = idx[:, None], dist[:, None]
    if idx.shape[1] < k:
        pad = k - idx.shape[1]
        idx = np.concatenate([idx, np.repeat(idx[:, :1], pad, axis=1)], axis=1)
        dist = np.concatenate(
            [dist, np.full((len(points), pad), np.inf)], axis=1
        )
    return idx.astype(np.int32), dist.astype(np.float32)


@jax.jit
def _pca_normals_full(
    points: jax.Array, nbr_idx: jax.Array, nbr_ok: jax.Array,
    view_point: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Radius-gated PCA normals + eigenvalues (ascending) + barycenters +
    per-point used-neighbor counts.  Estimation-time viewpoint sign flip
    matches the reference's computeNormal (PCCNormalsGenerator.cpp:148-151)."""
    nbrs = points[nbr_idx]                                # (N, k, 3)
    w = nbr_ok[..., None].astype(points.dtype)            # (N, k, 1)
    count = jnp.maximum(w.sum(axis=1), 1.0)               # (N, 1)
    bary = (nbrs * w).sum(axis=1) / count
    centered = (nbrs - bary[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", centered, centered,
                     precision=_HIGHEST)
    cov = cov / jnp.maximum(count - 1.0, 1.0)[..., None]
    vals, vecs = jnp.linalg.eigh(cov)                     # ascending
    n = vecs[:, :, 0]
    flip = jnp.einsum("nc,nc->n", n, view_point[None] - points,
                      precision=_HIGHEST) < 0
    n = jnp.where(flip[:, None], -n, n)
    return n, jnp.abs(vals), bary, count[:, 0]


@partial(jax.jit, static_argnames=("iterations",))
def _smooth_normals(
    normals: jax.Array, nbr_idx: jax.Array, nbr_ok: jax.Array,
    weight: jax.Array, iterations: int,
) -> jax.Array:
    """smoothNormals analog (PCCNormalsGenerator.cpp:533-573): per iteration
    each normal blends with the sign-aligned sum of its radius-gated
    neighbors: n <- normalize(w0*n + w2*normalize(sum sign*nbr))."""
    w2 = weight
    w0 = 1.0 - w2
    # neighbor column 0 is self — the reference sums i in [1, count)
    ok = nbr_ok.at[:, 0].set(False)[..., None].astype(normals.dtype)

    def body(_, n):
        nbr_n = n[nbr_idx]                                # (N, k, 3)
        sign = jnp.sign(jnp.einsum("nkc,nc->nk", nbr_n, n,
                                   precision=_HIGHEST))[..., None]
        acc = (nbr_n * jnp.where(sign == 0, 1.0, sign) * ok).sum(axis=1)
        acc = acc / jnp.maximum(jnp.linalg.norm(acc, axis=1, keepdims=True),
                                1e-12)
        out = w0 * n + w2 * acc
        return out / jnp.maximum(
            jnp.linalg.norm(out, axis=1, keepdims=True), 1e-12
        )

    return jax.lax.fori_loop(0, iterations, body, normals)


def _orient_cubemap(
    points: np.ndarray, normals: np.ndarray, nbr_idx: np.ndarray, sweeps: int = 8
) -> np.ndarray:
    """CUBEMAP_PROJECTION orientation (PCCNormalsGenerator.cpp:263-460):
    rasterize the cloud onto the 6 bounding-box faces; a point visible from a
    face gets its sign fixed toward that face's outward normal, then signs
    propagate to occluded points by majority vote over the KNN graph (the
    reference grows regions from visited seeds)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum((hi - lo).astype(np.int64) + 1, 1)
    face_normals = np.array(
        [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
        np.float32,
    )
    seed_sign = np.zeros(len(points), np.float32)
    seed_conf = np.zeros(len(points), np.float32)
    rel = (points - lo).astype(np.int64)
    for face in range(6):
        axis = face % 3
        u, v = (axis + 1) % 3, (axis + 2) % 3
        # the reference rasterizes 1:1 pixels (dense CTC clouds); coarsen the
        # plane for sparse clouds so columns actually occlude — without this
        # every point is "visible" from both opposing faces and the seeds
        # carry no information
        # target ~8 points per column: the surface is 2D, so a column must be
        # wide enough to catch both the front and back sheets before its
        # min-depth winner means "visible"
        shift = 0
        while ((span[u] >> shift) * (span[v] >> shift)
               > max(len(points) // 8, 1)):
            shift += 1
        pix = (rel[:, u] >> shift) * ((span[v] >> shift) + 1) + (
            rel[:, v] >> shift)
        depth = rel[:, axis] if face < 3 else span[axis] - 1 - rel[:, axis]
        order = np.lexsort((depth, pix))
        first = np.ones(len(points), bool)
        first[1:] = pix[order][1:] != pix[order][:-1]
        visible = order[first]
        # seed from the best-aligned face a point is visible from: a face
        # tangent to the surface says nothing about the sign
        agree = np.einsum("nc,c->n", normals[visible], face_normals[face])
        better = np.abs(agree) > seed_conf[visible]
        upd = visible[better]
        seed_sign[upd] = np.where(agree[better] >= 0, 1.0, -1.0)
        seed_conf[upd] = np.abs(agree[better])
    sign = seed_sign.copy()
    # only confident seeds (face nearly parallel to the normal) stay pinned;
    # tangent-face seeds are refined by propagation like unseeded points
    pinned = seed_conf > 0.5
    for _ in range(sweeps):
        # smoothness vote: neighbors' oriented normals should agree with ours
        nbr_n = normals[nbr_idx] * sign[nbr_idx][..., None]
        vote = np.einsum("nkc,nc->n", nbr_n, normals)
        new = np.where(vote != 0, np.sign(vote), sign)
        sign = np.where(pinned, seed_sign, new)
    sign = np.where(sign == 0, 1.0, sign)
    return normals * sign[:, None]


def generate_normals(
    points: np.ndarray, params: NormalsGenParams | None = None
) -> dict:
    """PCCNormalsGenerator3::compute analog: estimation → optional smoothing
    → orientation.  Returns {'normals', and optionally 'eigenvalues',
    'centroids', 'nn_counts'} per the store* flags."""
    params = params or NormalsGenParams()
    pts32 = points.astype(np.float32)
    idx_e, dist_e = knn_graph(pts32, params.knn_normal_estimation)
    ok_e = dist_e <= params.radius_normal_estimation
    ok_e[:, 0] = True
    pts = jnp.asarray(pts32)
    vp = jnp.asarray(np.asarray(params.view_point, np.float32))
    n, vals, bary, counts = _pca_normals_full(
        pts, jnp.asarray(idx_e), jnp.asarray(ok_e), vp
    )
    if params.smoothing_iterations > 0:
        if params.knn_normal_smoothing == params.knn_normal_estimation:
            idx_s, dist_s = idx_e, dist_e
        else:
            idx_s, dist_s = knn_graph(pts32, params.knn_normal_smoothing)
        ok_s = dist_s <= params.radius_normal_smoothing
        w2 = params.weight_normal_smoothing
        if not np.isfinite(w2):
            w2 = 1.0  # reference default MAX_VAL degenerates to neighbor avg
        n = _smooth_normals(
            n, jnp.asarray(idx_s), jnp.asarray(ok_s),
            jnp.float32(np.clip(w2, 0.0, 1.0)), params.smoothing_iterations,
        )
    strategy = params.orientation_strategy
    if strategy in (1, 2, 3):
        if params.knn_normal_orientation == params.knn_normal_estimation:
            idx_o, dist_o = idx_e, dist_e
        else:
            idx_o, dist_o = knn_graph(pts32, params.knn_normal_orientation)
        if strategy == 1:
            ok_o = dist_o <= params.radius_normal_orientation
            ok_o[:, 0] = True
            try:
                n = jnp.asarray(orient_spanning_tree(
                    np.asarray(n), pts32, idx_o, ok_o, params.view_point,
                ))
            except RuntimeError:  # no native lib: sweep fallback
                n = _orient_all(n, pts, jnp.asarray(idx_o), 2)
        elif strategy == 2:
            flip = np.einsum(
                "nc,nc->n", np.asarray(n),
                np.asarray(params.view_point, np.float32)[None] - pts32,
            ) < 0
            n = jnp.where(jnp.asarray(flip)[:, None], -n, n)
        else:
            n = jnp.asarray(_orient_cubemap(pts32, np.asarray(n), idx_o))
    n = np.asarray(n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True),
                                   1e-12))
    out = {"normals": n}
    if params.store_eigenvalues:
        out["eigenvalues"] = np.asarray(vals)
    if params.store_centroids:
        out["centroids"] = np.asarray(bary)
    if params.store_number_of_nearest_neighbors:
        out["nn_counts"] = np.asarray(counts).astype(np.uint32)
    return out
