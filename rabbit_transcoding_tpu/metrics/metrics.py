"""Quality metrics: D1/D2 PSNR, color PSNR, Hausdorff.

Capability parity with PCCMetrics (/root/reference/source/lib/PccLibMetrics/
source/PCCMetrics.cpp:44-292): symmetric A<->B nearest-neighbour error,
point-to-point (D1) and point-to-plane (D2), BT.709 color PSNR over NN
pairs, Hausdorff variants, PSNR peak = 3 * resolution^2 for geometry
(:44-47).  Reference semantics reproduced exactly:

 * **equidistant-NN D2 averaging** (:87-125): every reconstructed neighbour
   at the same (minimal) distance contributes a squared plane-projection,
   and D2 is their mean — capped at ``neighbors_d2`` neighbours
   (num_results_max=30, extended 5 at a time in the reference; here a
   vectorised two-step query);
 * **neighborsProc color modes** (:128-180): 0 first-NN, 1/2 average RGB of
   the equidistant set (rounded, then converted to YUV), 3/4 min/max YUV
   distance within the set;
 * **dropDuplicates modes** (PCCPointSet.cpp:169-218, default 2): 0 keep
   all, 1 keep the first co-located point, 2 keep the first but average the
   colors of all co-located points (integer floor division, as the C++).

One documented deviation: the reference projects D2 onto the *second*
cloud's normals in each direction (it computes normals for both clouds
first).  Reconstructed clouds here carry no normals, so both directions
project onto the source cloud's normals (the src->rec direction uses the
source point's own normal; rec->src uses the matched source neighbour's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

from ..core.pointset import PointSet


@dataclasses.dataclass
class MetricsParams:
    resolution: int = 1023         # peak geometry value (vox10 -> 1023)
    # 0 keep-all | 1 drop | 2 average colors of co-located points
    # (PCCMetricsParameters.cpp:50 default = 2)
    drop_duplicates: int = 2
    # max equidistant neighbours contributing to D2 averaging
    # (PCCMetrics.cpp:87 num_results_max = 30); 1 = single-NN
    neighbors_d2: int = 30
    # color over the equidistant set: 0 first | 1 average | 2 weighted
    # average | 3 min | 4 max (PCCMetricsParameters.cpp:51 default = 1)
    neighbors_proc: int = 1


@dataclasses.dataclass
class QualityMetrics:
    d1_mse: float = 0.0
    d1_psnr: float = 0.0
    d2_mse: float = 0.0
    d2_psnr: float = 0.0
    d1_hausdorff: float = 0.0
    d1_hausdorff_psnr: float = 0.0
    d2_hausdorff: float = 0.0
    d2_hausdorff_psnr: float = 0.0
    color_psnr: tuple[float, float, float] = (0.0, 0.0, 0.0)
    color_hausdorff_psnr: tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflectance_psnr: float = 0.0
    point_count_source: int = 0
    point_count_reconstructed: int = 0

    def print(self) -> str:
        y, u, v = self.color_psnr
        return (
            f"D1 (p2point) mse, PSNR : {self.d1_mse:.6f}, {self.d1_psnr:.4f} dB\n"
            f"D2 (p2plane) mse, PSNR : {self.d2_mse:.6f}, {self.d2_psnr:.4f} dB\n"
            f"D1 Hausdorff, PSNR     : {self.d1_hausdorff:.6f}, "
            f"{self.d1_hausdorff_psnr:.4f} dB\n"
            f"Color Y/U/V PSNR       : {y:.4f}, {u:.4f}, {v:.4f} dB"
            + (
                f"\nReflectance PSNR       : {self.reflectance_psnr:.4f} dB"
                if self.reflectance_psnr
                else ""
            )
        )

    def csv_line(self) -> str:
        y, u, v = self.color_psnr
        return (
            f"{self.d1_psnr:.4f};{self.d2_psnr:.4f};"
            f"{self.d1_hausdorff_psnr:.4f};{y:.4f};{u:.4f};{v:.4f}"
        )


def _geom_psnr(mse: float, resolution: int) -> float:
    if mse <= 0:
        return float("inf")
    peak = 3.0 * resolution * resolution
    return 10.0 * np.log10(peak / mse)


def _rgb_to_yuv709(rgb: np.ndarray) -> np.ndarray:
    """0-255 RGB (..., 3) -> BT.709 YUV in [0,1] — the exact coefficients of
    convertRGBtoYUVBT709 (PCCMetrics.cpp:49-54)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = (0.2126 * r + 0.7152 * g + 0.0722 * b) / 255.0
    u = (-0.1146 * r - 0.3854 * g + 0.5000 * b) / 255.0 + 0.5
    v = (0.5000 * r - 0.4542 * g - 0.0458 * b) / 255.0 + 0.5
    return np.stack([y, u, v], axis=-1)


class _NNBackend:
    """KNN provider for the metric queries: native voxel-grid exact KNN
    for integral clouds (decoded V-PCC clouds always are), cKDTree
    otherwise.  Same (dist, idx) contract as cKDTree.query."""

    def __init__(self, pts: np.ndarray):
        self.pts = np.asarray(pts)
        self.n = len(self.pts)
        self._tree = None
        self._integral = (
            self.n > 0
            and float(np.abs(self.pts).max()) < 2**30
            and not (self.pts != np.round(self.pts)).any()
        )

    def query(self, a: np.ndarray, k: int, workers: int = -1):
        if self._integral and not (a != np.round(a)).any():
            from .. import native

            try:
                idx, d2 = native.knn_grid(a, self.pts, k)
                return (np.sqrt(d2.astype(np.float64)),
                        idx.astype(np.int64))
            except (RuntimeError, ValueError, OverflowError):
                pass
        if self._tree is None:
            self._tree = cKDTree(self.pts)
        return self._tree.query(a, k=k, workers=workers)


def _query_equidistant(a_pos: np.ndarray, tree: "_NNBackend", cap: int):
    """-> (idx (N, k), ties (N, k) bool, d1 (N,) squared first-NN dists).

    Vectorised version of the reference's adaptive search (PCCMetrics.cpp:
    87-99): start with 5 neighbours, extend to `cap` only for query points
    whose whole first batch is equidistant; ties = |d^2 - d0^2| < 1e-8."""
    n_b = tree.n
    kmax = max(1, min(cap, n_b))
    k0 = min(5, kmax)
    dist, idx = tree.query(a_pos, k=k0, workers=-1)
    dist = dist.reshape(len(a_pos), -1)
    idx = idx.reshape(len(a_pos), -1)
    sq = dist * dist
    if kmax > k0:
        full = (sq[:, -1] - sq[:, 0]) < 1e-8
        if full.any():
            d_f, i_f = tree.query(a_pos[full], k=kmax, workers=-1)
            pad = kmax - k0
            dist = np.pad(dist, ((0, 0), (0, pad)),
                          constant_values=np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)))
            dist[full] = d_f
            idx[full] = i_f
            sq = dist * dist
    ties = (sq - sq[:, :1]) < 1e-8
    return idx, ties, sq[:, 0]


def _d2_direction(
    a_pos: np.ndarray,
    b_pos: np.ndarray,
    idx: np.ndarray,
    ties: np.ndarray,
    normals: np.ndarray,
    normals_on_b: bool,
) -> np.ndarray:
    """Per-A-point D2: mean squared plane projection over the equidistant
    neighbour set (PCCMetrics.cpp:112-125)."""
    err = b_pos[idx].astype(np.float64) - a_pos[:, None, :].astype(np.float64)
    if normals_on_b:
        nrm = normals[idx]
    else:
        nrm = np.broadcast_to(normals[:, None, :], err.shape)
    proj = np.einsum("nkc,nkc->nk", err, nrm) ** 2
    w = ties.astype(np.float64)
    return (proj * w).sum(axis=1) / w.sum(axis=1)


def _color_sq_direction(
    a_colors: np.ndarray,
    b_colors: np.ndarray,
    idx: np.ndarray,
    ties: np.ndarray,
    proc: int,
) -> np.ndarray:
    """Per-A-point, per-channel squared YUV error against the equidistant
    neighbour set per neighborsProc (PCCMetrics.cpp:128-180)."""
    yuv_a = _rgb_to_yuv709(a_colors)
    if proc in (1, 2):  # average / weighted average (nbdup == 1 here)
        w = ties.astype(np.float64)
        rgb = (b_colors[idx].astype(np.float64) * w[..., None]).sum(axis=1)
        rgb = np.round(rgb / w.sum(axis=1)[:, None])
        yuv_b = _rgb_to_yuv709(rgb)
    elif proc in (3, 4):  # min / max YUV distance within the set
        yuv_all = _rgb_to_yuv709(b_colors[idx])
        d = ((yuv_all - yuv_a[:, None, :]) ** 2).sum(axis=-1)
        d = np.where(ties, d, np.inf if proc == 3 else -np.inf)
        j = d.argmin(axis=1) if proc == 3 else d.argmax(axis=1)
        yuv_b = yuv_all[np.arange(len(idx)), j]
    else:  # first NN
        yuv_b = _rgb_to_yuv709(b_colors[idx[:, 0]])
    return (yuv_a - yuv_b) ** 2


def compute_metrics(
    source: PointSet,
    reconstructed: PointSet,
    params: MetricsParams | None = None,
    source_normals: np.ndarray | None = None,
) -> QualityMetrics:
    """Symmetric quality metrics between source and reconstruction."""
    params = params or MetricsParams()
    dd = int(params.drop_duplicates)
    src = source.remove_duplicates(dd) if dd else source
    rec = reconstructed.remove_duplicates(dd) if dd else reconstructed

    if source_normals is None and src.has_normals:
        source_normals = src.normals
    if source_normals is None:
        from ..encoder.normals import compute_normals

        source_normals, _ = compute_normals(src.positions.astype(np.float32))
    source_normals = np.asarray(source_normals, np.float64)

    cap = max(1, int(params.neighbors_d2))
    tree_rec = _NNBackend(rec.positions)
    tree_src = _NNBackend(src.positions)
    idx_ab, ties_ab, d1_ab = _query_equidistant(src.positions, tree_rec, cap)
    idx_ba, ties_ba, d1_ba = _query_equidistant(rec.positions, tree_src, cap)

    # src->rec: project onto the source point's own normal;
    # rec->src: onto the matched source neighbour's normal (see module doc)
    d2_ab = _d2_direction(
        src.positions, rec.positions, idx_ab, ties_ab, source_normals,
        normals_on_b=False,
    )
    d2_ba = _d2_direction(
        rec.positions, src.positions, idx_ba, ties_ba, source_normals,
        normals_on_b=True,
    )

    d1_mse = max(float(np.mean(d1_ab)), float(np.mean(d1_ba)))
    d2_mse = max(float(np.mean(d2_ab)), float(np.mean(d2_ba)))
    haus = max(float(np.max(d1_ab)), float(np.max(d1_ba)))
    haus2 = max(float(np.max(d2_ab)), float(np.max(d2_ba)))

    m = QualityMetrics(
        d1_mse=d1_mse,
        d1_psnr=_geom_psnr(d1_mse, params.resolution),
        d2_mse=d2_mse,
        d2_psnr=_geom_psnr(d2_mse, params.resolution),
        d1_hausdorff=haus,
        d1_hausdorff_psnr=_geom_psnr(haus, params.resolution),
        d2_hausdorff=haus2,
        d2_hausdorff_psnr=_geom_psnr(haus2, params.resolution),
        point_count_source=src.point_count,
        point_count_reconstructed=rec.point_count,
    )

    if src.has_reflectances and rec.has_reflectances:
        ra = src.reflectances.astype(np.float64)
        rb = rec.reflectances[idx_ab[:, 0]].astype(np.float64)
        rc = src.reflectances[idx_ba[:, 0]].astype(np.float64)
        rd = rec.reflectances.astype(np.float64)
        mse_r = max(float(np.mean((ra - rb) ** 2)),
                    float(np.mean((rd - rc) ** 2)))
        m.reflectance_psnr = (
            float("inf") if mse_r <= 0
            else 10.0 * np.log10(65535.0 ** 2 / mse_r)
        )

    if src.has_colors and rec.has_colors:
        sq_ab = _color_sq_direction(
            src.colors, rec.colors, idx_ab, ties_ab, params.neighbors_proc
        )
        sq_ba = _color_sq_direction(
            rec.colors, src.colors, idx_ba, ties_ba, params.neighbors_proc
        )
        psnrs, haus_psnrs = [], []
        for c in range(3):
            mse = max(float(np.mean(sq_ab[:, c])), float(np.mean(sq_ba[:, c])))
            psnrs.append(
                float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)
            )
            hv = max(float(np.max(sq_ab[:, c])), float(np.max(sq_ba[:, c])))
            haus_psnrs.append(
                float("inf") if hv <= 0 else 10.0 * np.log10(1.0 / hv)
            )
        m.color_psnr = tuple(psnrs)
        m.color_hausdorff_psnr = tuple(haus_psnrs)
    return m


def d1_psnr_sharded(
    source: PointSet,
    reconstructed: PointSet,
    mesh,
    params: MetricsParams | None = None,
    cell_bits: int = 3,
    cap: int = 64,
) -> float:
    """Multi-chip symmetric D1 PSNR: both NN passes run on the device
    grid-hash KNN with query points sharded over every mesh device and the
    (sum, count) partials reduced in one psum (parallel/pipeline.py — the
    multi-chip metrics reduction of SURVEY §2.7).

    This is the throughput path for monitoring at scale: plain
    nearest-neighbour D1 (the pcc_error default), WITHOUT the
    equidistant-tie / neighborsProc refinements of compute_metrics — use
    that for CTC-grade numbers.  Single-device vs multi-device results are
    asserted identical in tests/test_parallel.py."""
    from ..parallel.pipeline import make_sharded_nn_mse

    params = params or MetricsParams()
    dd = int(params.drop_duplicates)
    src = source.remove_duplicates(dd) if dd else source
    rec = reconstructed.remove_duplicates(dd) if dd else reconstructed
    grid_dim = max(2, (1 << 10) >> cell_bits)
    nn_mse = make_sharded_nn_mse(
        mesh, k_cell_bits=cell_bits, grid_dim=grid_dim, cap=cap
    )
    mse_ab = nn_mse(src.positions, rec.positions)
    mse_ba = nn_mse(rec.positions, src.positions)
    return _geom_psnr(max(mse_ab, mse_ba), params.resolution)


def compute_sequence_metrics(
    sources: list[PointSet],
    reconstructions: list[PointSet],
    params: MetricsParams | None = None,
) -> tuple[list[QualityMetrics], QualityMetrics]:
    """Per-frame metrics + sequence averages (PccAppMetrics behaviour)."""
    per_frame = [
        compute_metrics(s, r, params) for s, r in zip(sources, reconstructions)
    ]
    n = max(1, len(per_frame))

    def avg(vals):
        finite = [v for v in vals if np.isfinite(v)]
        return float(np.mean(finite)) if finite else float("inf")

    summary = QualityMetrics(
        d1_mse=avg([m.d1_mse for m in per_frame]),
        d1_psnr=avg([m.d1_psnr for m in per_frame]),
        d2_mse=avg([m.d2_mse for m in per_frame]),
        d2_psnr=avg([m.d2_psnr for m in per_frame]),
        d1_hausdorff=avg([m.d1_hausdorff for m in per_frame]),
        d1_hausdorff_psnr=avg([m.d1_hausdorff_psnr for m in per_frame]),
        d2_hausdorff=avg([m.d2_hausdorff for m in per_frame]),
        d2_hausdorff_psnr=avg([m.d2_hausdorff_psnr for m in per_frame]),
        color_psnr=(
            avg([m.color_psnr[0] for m in per_frame]),
            avg([m.color_psnr[1] for m in per_frame]),
            avg([m.color_psnr[2] for m in per_frame]),
        ),
        color_hausdorff_psnr=(
            avg([m.color_hausdorff_psnr[0] for m in per_frame]),
            avg([m.color_hausdorff_psnr[1] for m in per_frame]),
            avg([m.color_hausdorff_psnr[2] for m in per_frame]),
        ),
        reflectance_psnr=avg(
            [m.reflectance_psnr for m in per_frame if m.reflectance_psnr]
        )
        if any(m.reflectance_psnr for m in per_frame)
        else 0.0,
        point_count_source=sum(m.point_count_source for m in per_frame) // n,
        point_count_reconstructed=(
            sum(m.point_count_reconstructed for m in per_frame) // n
        ),
    )
    return per_frame, summary
