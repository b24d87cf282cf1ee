"""Attribute transfer (recoloring): source cloud -> reconstructed cloud.

Capability parity with the PCCPointSet3::transferColors* family
(/root/reference/source/lib/PccLibCommon/source/PCCPointSet.cpp:807-2097):
colors are transferred from the source cloud to the (geometry-compressed)
reconstructed cloud by nearest/KNN lookup with inverse-distance weighting.

Host KNN (scipy cKDTree, the nanoflann analog) builds the neighbor lists;
the weighted blend itself is a trivial vectorised op.  A device grid-hash
KNN (ops/knn.py) replaces the host tree for the batched multi-stream path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


def transfer_colors(
    src_points: np.ndarray,
    src_colors: np.ndarray,
    dst_points: np.ndarray,
    k: int = 1,
) -> np.ndarray:
    """-> (M, 3) uint8 colors for dst_points.

    k=1 nearest-neighbour transfer (the reference's base mode); k>1 applies
    inverse-distance weighting over the k nearest source points."""
    if len(dst_points) == 0:
        return np.zeros((0, 3), np.uint8)
    tree = cKDTree(src_points)
    if k == 1:
        _, idx = tree.query(dst_points, k=1, workers=-1)
        return src_colors[idx]
    dist, idx = tree.query(dst_points, k=min(k, len(src_points)), workers=-1)
    if idx.ndim == 1:
        return src_colors[idx]
    w = 1.0 / np.maximum(dist, 1e-9)
    w /= w.sum(axis=1, keepdims=True)
    blended = (src_colors[idx].astype(np.float64) * w[..., None]).sum(axis=1)
    return np.clip(np.round(blended), 0, 255).astype(np.uint8)


@dataclasses.dataclass
class RecolorParams:
    """The full transferColors knob set (PCCPointSet.cpp:807-1110 arguments;
    defaults are the CTC values from cfg/common/ctc-common.cfg:37-49)."""

    searchRange: int = 0                 # bestColorSearchRange
    losslessAttribute: bool = False
    numNeighborsFwd: int = 8             # numNeighborsColorTransferFwd
    numNeighborsBwd: int = 1             # numNeighborsColorTransferBwd
    useDistWeightedAverageFwd: bool = True
    useDistWeightedAverageBwd: bool = True
    skipAvgIfIdenticalSourcePointPresentFwd: bool = True
    skipAvgIfIdenticalSourcePointPresentBwd: bool = True
    distOffsetFwd: float = 4.0
    distOffsetBwd: float = 4.0
    maxGeometryDist2Fwd: float = 1000.0  # >=512 means "no threshold"
    maxGeometryDist2Bwd: float = 1000.0
    maxColorDist2Fwd: float = 1000.0
    maxColorDist2Bwd: float = 1000.0
    excludeColorOutlier: bool = False
    thresholdColorOutlierDist: float = 10.0


def _knn_query(query: np.ndarray, data: np.ndarray, k: int):
    """(d2 (N,k) float64, idx (N,k)) nearest `data` points per query, k <=
    len(data).  Native voxel-grid KNN when coordinates are integral (V-PCC
    clouds always are), cKDTree otherwise."""
    if (np.abs(data).max(initial=0.0) < 2**30
            and not (data != np.round(data)).any()
            and not (query != np.round(query)).any()):
        from .. import native

        try:
            idx, d2 = native.knn_grid(query, data, k)
            return d2.astype(np.float64), idx.astype(np.int64)
        except (RuntimeError, ValueError, OverflowError):
            pass
    d, idx = cKDTree(data).query(query, k=k, workers=-1)
    if k == 1:
        d, idx = d[:, None], idx[:, None]
    return d * d, idx


def _prefix_ok_count(colors: np.ndarray, limit: np.ndarray,
                     max_color_dist2: float) -> np.ndarray:
    """Longest prefix length n<=limit whose pairwise color dist2 stays
    <= max_color_dist2 (the reference's pop-from-the-back loop: candidates
    are distance-sorted, so popping the farthest until the spread fits is
    exactly the longest admissible prefix).  colors (N,K,3); limit (N,)."""
    n, k = colors.shape[:2]
    if k == 1:
        return np.minimum(limit, 1)
    lower = np.arange(k)[None, :, None] < np.arange(k)[None, None, :]
    out = np.empty(n, np.int64)
    # chunked + Gram-formula pairwise distances: the naive broadcasted
    # (N,K,K,3) difference tensor is multi-GB once the backward candidate
    # cap is reached (96^2 pairs x 35k targets thrashed a real encode)
    block = max(1, int(8_000_000 // (k * k)))
    for s in range(0, n, block):
        c = colors[s:s + block]
        sq = (c * c).sum(-1)                                # (B,K)
        pd = sq[:, :, None] + sq[:, None, :] - 2.0 * np.einsum(
            "bkc,bjc->bkj", c, c)
        # newmax[:, c] = max_{j<c} ||col_j - col_c||^2 (spread added by c)
        newmax = np.where(lower, pd, -np.inf).max(axis=1)   # (B,K)
        run = np.maximum.accumulate(newmax, axis=1)         # prefix spread
        ok = (run <= max_color_dist2) & (
            np.arange(k)[None, :] < limit[s:s + block, None])
        # run is non-decreasing so ok is prefix-true; length 1 always ok
        out[s:s + block] = np.maximum(ok.sum(axis=1), 1)
    return out


def _masked_weighted_avg(colors: np.ndarray, w: np.ndarray,
                         nstar: np.ndarray, exclude_outlier: bool,
                         thr_dist: float) -> np.ndarray:
    """Weighted color average over the first nstar candidates, with the
    optional exclude-outlier second pass (re-average without colors farther
    than thr from the first average, unless that excludes all or none)."""
    k = colors.shape[1]
    sel = np.arange(k)[None, :] < nstar[:, None]
    w = np.where(sel, w, 0.0)
    wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    avg = (colors * w[..., None]).sum(axis=1) / wsum
    if exclude_outlier:
        far = ((colors - avg[:, None, :]) ** 2).sum(-1) > thr_dist * thr_dist
        excl = (far & sel).sum(axis=1)
        redo = (excl > 0) & (excl < nstar)
        w2 = np.where(far, 0.0, w)
        w2sum = np.maximum(w2.sum(axis=1, keepdims=True), 1e-300)
        avg2 = (colors * w2[..., None]).sum(axis=1) / w2sum
        avg = np.where(redo[:, None], avg2, avg)
    return avg


def transfer_colors_fwd_bwd(
    src_points: np.ndarray,
    src_colors: np.ndarray,
    dst_points: np.ndarray,
    params: RecolorParams | None = None,
    max_bwd_candidates: int = 96,
) -> np.ndarray:
    """Full PCCPointSet3::transferColors parity, vectorised.

    Forward pass: per target point, KNN into the source, geometry-threshold
    prefix, identical-point short-circuit, color-spread prefix trimming,
    distance-weighted average with optional outlier exclusion
    (PCCPointSet.cpp:840-931).  Backward pass: per source point its nearest
    targets accumulate (dist2, color) candidates; per target the sorted
    candidate list is trimmed the same way and averaged with
    1/(sqrt(d2)+offset) weights (:935-1040).  The final color is the
    backward centroid (m42538 fixWeight, :1057-1077) refined by an optional
    +/-searchRange per-channel local search minimising
    max(e1_target, e2_source) (:1078-1110); targets with no backward
    candidate (or losslessAttribute) keep the forward color.

    max_bwd_candidates bounds the per-target candidate list (the reference
    list is unbounded; candidates are distance-sorted so the cap drops the
    farthest — beyond ~96 their 1/(sqrt(d2)+4) weight is noise)."""
    p = params or RecolorParams()
    n_dst = len(dst_points)
    if n_dst == 0:
        return np.zeros((0, 3), np.uint8)
    if len(src_points) == 0:
        return np.zeros((n_dst, 3), np.uint8)
    inf = np.inf
    geo2_f = p.maxGeometryDist2Fwd if p.maxGeometryDist2Fwd < 512 else inf
    geo2_b = p.maxGeometryDist2Bwd if p.maxGeometryDist2Bwd < 512 else inf
    col2_f = p.maxColorDist2Fwd if p.maxColorDist2Fwd < 512 else inf
    col2_b = p.maxColorDist2Bwd if p.maxColorDist2Bwd < 512 else inf
    src_pts = np.asarray(src_points, np.float64)
    dst_pts = np.asarray(dst_points, np.float64)
    scol = np.asarray(src_colors, np.float64)
    n_src = len(src_pts)

    # -- forward ----------------------------------------------------------
    kf = min(max(p.numNeighborsFwd, 1), n_src)
    d2, idx = _knn_query(dst_pts, src_pts, kf)
    fcol = scol[idx]                                        # (T,kf,3)
    n_geo = np.maximum((d2 <= geo2_f).sum(axis=1), 1)
    nstar = _prefix_ok_count(fcol, n_geo, col2_f)
    w = 1.0 / (d2 + p.distOffsetFwd) if p.useDistWeightedAverageFwd \
        else np.ones_like(d2)
    avg = _masked_weighted_avg(fcol, w, nstar, p.excludeColorOutlier,
                               p.thresholdColorOutlierDist)
    refined1 = np.clip(np.round(avg), 0.0, 255.0)
    if p.skipAvgIfIdenticalSourcePointPresentFwd:
        ident = d2[:, 0] < 0.0001
        refined1 = np.where(ident[:, None], fcol[:, 0], refined1)

    # -- backward ---------------------------------------------------------
    kb = min(max(p.numNeighborsBwd, 1), n_dst)
    d2b, ib = _knn_query(src_pts, dst_pts, kb)
    validb = d2b <= geo2_b
    tgt = ib[validb]
    dd = d2b[validb]
    ccol = np.broadcast_to(scol[:, None, :], (n_src, kb, 3))[validb]
    order = np.lexsort((dd, tgt))
    tgt, dd, ccol = tgt[order], dd[order], ccol[order]
    counts = np.bincount(tgt, minlength=n_dst)
    cmax = int(counts.max()) if len(counts) else 0
    cap = min(cmax, max_bwd_candidates) if cmax else 0
    out = refined1
    if cap > 0:
        starts = np.zeros(n_dst, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(len(tgt)) - np.repeat(starts, counts)
        keep = within < cap
        cand_n = np.minimum(counts, cap)

        in_bin = np.zeros(n_dst, bool)

        def backward_centroid(rows, bcap):
            """Backward trim + weighted centroid for the `rows` targets,
            candidate lanes padded to bcap (>= their counts).  Padding
            width does not change the result: the color-spread prefix and
            the weighted average both mask lanes >= the per-row count."""
            local = np.empty(n_dst, np.int64)
            local[rows] = np.arange(len(rows))
            if len(rows) < n_dst:
                in_bin[:] = False
                in_bin[rows] = True
                sel = keep & in_bin[tgt]
            else:
                sel = keep
            c_d2 = np.full((len(rows), bcap), inf)
            c_col = np.zeros((len(rows), bcap, 3))
            c_d2[local[tgt[sel]], within[sel]] = dd[sel]
            c_col[local[tgt[sel]], within[sel]] = ccol[sel]
            limit = np.maximum(cand_n[rows], 1)
            nst = _prefix_ok_count(c_col, limit, col2_b)
            if p.skipAvgIfIdenticalSourcePointPresentBwd:
                nst = np.where(c_d2[:, 0] < 0.0001, 1, nst)
            wb = 1.0 / (np.sqrt(np.where(np.isfinite(c_d2), c_d2, 0.0))
                        + p.distOffsetBwd) \
                if p.useDistWeightedAverageBwd else np.ones_like(c_d2)
            cen = _masked_weighted_avg(
                c_col, wb, nst, p.excludeColorOutlier,
                p.thresholdColorOutlierDist)
            return cen, nst, c_col

        if p.searchRange > 0 or cap <= 8:
            # dense path (the per-channel best-color search wants the full
            # candidate matrix; small caps don't pay the binning overhead)
            all_rows = np.arange(n_dst)
            centroid2, nstar_b, cand_col = backward_centroid(all_rows, cap)
            color0 = np.clip(np.round(centroid2), 0.0, 255.0)
            if p.searchRange > 0:
                color0 = _best_color_search(
                    color0, refined1, cand_col, nstar_b, p.searchRange,
                    n_src, n_dst)
        else:
            # count-binned path: the candidate-count distribution is
            # extremely skewed (median 1-2, tail to the cap), and the
            # O(cap^2) color-spread kernel over all-cap-wide rows
            # dominated dense encodes (85 of 153 s/frame measured);
            # processing each count bin at its own lane width collapses
            # that cost ~100x with bit-identical results
            color0 = np.zeros((n_dst, 3))
            lo = 0
            for bcap in (1, 4, 16, cap):
                bcap = min(bcap, cap)
                if bcap <= lo:
                    continue
                rows = np.nonzero((cand_n > lo) & (cand_n <= bcap))[0]
                lo = bcap
                if len(rows) == 0:
                    continue
                cen, _nst, _cc = backward_centroid(rows, bcap)
                color0[rows] = np.clip(np.round(cen), 0.0, 255.0)
        has_cand = cand_n > 0
        # m42538 fixWeight: w=0 -> the backward centroid wins outright
        if not p.losslessAttribute:
            out = np.where(has_cand[:, None], color0, refined1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _best_color_search(color0, refined1, cand_col, nstar_b, search_range,
                       n_src, n_dst):
    """+/-searchRange per-channel enumeration minimising
    max(e1/targetCount, e2/sourceCount) (PCCPointSet.cpp:1078-1110)."""
    sel = np.arange(cand_col.shape[1])[None, :] < nstar_b[:, None]
    r_t, r_s = 1.0 / n_dst, 1.0 / n_src
    best = color0.copy()
    best_err = np.full(len(color0), np.inf)
    offs = np.arange(-search_range, search_range + 1, dtype=np.float64)
    for s1 in offs:
        for s2 in offs:
            for s3 in offs:
                c = np.clip(color0 + np.array([s1, s2, s3]), 0.0, 255.0)
                e1 = ((c - refined1) ** 2).sum(axis=1) * r_t
                diff = ((cand_col - c[:, None, :]) ** 2).sum(-1)
                e2 = np.where(sel, diff, 0.0).sum(axis=1) * r_s
                err = np.maximum(e1, e2)
                better = err < best_err
                best[better] = c[better]
                best_err = np.where(better, err, best_err)
    return best


def transfer_colors_device(
    src_points: np.ndarray,
    src_colors: np.ndarray,
    dst_points: np.ndarray,
    k: int = 1,
    coord_bits: int = 10,
) -> np.ndarray:
    """Device grid-hash variant (ops/knn.py) of transfer_colors: the device path
    for batched multi-stream recoloring.  Falls back to the nearest found
    candidate; points with no in-radius neighbour take the globally nearest
    via a host fixup (rare: isolated outliers)."""
    from .knn import knn

    if len(dst_points) == 0:
        return np.zeros((0, 3), np.uint8)
    d2, idx = knn(
        dst_points.astype(np.int32), src_points.astype(np.int32), k=k,
        coord_bits=coord_bits,
    )
    unfound = idx[:, 0] < 0
    idx0 = np.where(unfound[:, None], 0, np.maximum(idx, 0))
    if k == 1:
        out = src_colors[idx0[:, 0]].copy()
    else:
        w = 1.0 / np.sqrt(np.maximum(d2, 1e-9))
        w = np.where(idx >= 0, w, 0.0)
        wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        blended = (
            src_colors[idx0].astype(np.float64) * (w / wsum)[..., None]
        ).sum(axis=1)
        out = np.clip(np.round(blended), 0, 255).astype(np.uint8)
    if unfound.any():
        tree = cKDTree(src_points)
        _, far_idx = tree.query(dst_points[unfound], k=1)
        out[unfound] = src_colors[far_idx]
    return out
