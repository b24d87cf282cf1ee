"""Shared 3D reconstruction engine (PCCCodec analog).

Capability parity with PCCCodec (/root/reference/source/lib/PccLibCommon/
source/PCCCodec.cpp): generateOccupancyMap (:1584), generateBlockToPatch
(:1712), generatePointCloud (:517), colorPointCloud (:1308) — used by the
decoder, the transcoder's self-check path, and encoder-side reconstruction.

Device design: the whole GOF's occupancy/geometry/attribute planes are
shipped to the device once; reprojection + coloring run as batched masked
ops (ops/reproject.py); only the final compaction of valid points back to
per-frame PointSets touches the host.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.image import Video
from ..core.patch import Patch
from ..core.pointset import PointSet
from ..ops import occupancy as occ_ops
from ..ops import reproject as repro_ops
from ..ops.color import yuv420_to_rgb8
from ..utils.enums import ColorFormat


@dataclasses.dataclass
class GeneratePointCloudParameters:
    """Reconstruction knobs (GeneratePointCloudParameters analog,
    PCCCodec.h:63-96)."""

    occupancy_resolution: int = 16
    occupancy_precision: int = 4
    flag_geometry_smoothing: bool = False
    grid_size: int = 8
    neighbor_count_smoothing: int = 64
    threshold_smoothing: float = 64.0
    flag_color_smoothing: bool = False
    threshold_color_smoothing: float = 10.0
    remove_duplicate_points: bool = True
    pixel_deinterleaving: bool = False
    point_local_reconstruction: bool = False
    # PLR mode table indexed by coded plrd mode value; entry 0 is the
    # implicit no-op mode, later entries come from the ASPS plri descriptors
    # (interpolate, filling, minimum_depth, neighbor) — PCCDecoder.cpp:
    # 528-541.  The default matches this framework's historical single
    # "+1 layer" mode (minD1=1).
    plr_modes: tuple = ((False, False, 0, 1), (False, False, 1, 1))
    # occupancy synthesis / PBF (from the SeiOccupancySynthesis SEI):
    # erode dilated occupancy rims whose geometry deviates off-surface
    pbf_enable: bool = False
    pbf_passes: int = 2
    pbf_filter_size: int = 3
    pbf_threshold: float = 4.0
    # full-KNN geometry smoothing (the reference's gridSmoothing=0 path,
    # PCCCodec::smoothPointCloud; knobs neighborCountSmoothing/
    # radius2Smoothing/radius2BoundaryDetection ride here since no SEI
    # carries them — both sides must configure identically, like the
    # reference's CLI-symmetric design)
    grid_smoothing: bool = True
    # b2p precedence (asps_patch_precedence_order_flag): True = first-coded
    # patch wins contested blocks; False = last-coded wins (reverse scan)
    patch_precedence: bool = True
    radius2_smoothing: float = 64.0
    radius2_boundary_detection: float = 64.0
    # post-smoothing attribute re-transfer selector (attrTransferFilterType;
    # 0 = geometry smoothing excluded from attribute transfer)
    attr_transfer_filter_type: int = 0
    # multi-chip: a jax.sharding.Mesh shards the per-frame reprojection
    # across devices (parallel/pipeline.py; bit-identical — frame-local
    # computation, only the device assignment changes).  None = one device.
    mesh: object = None


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def occupancy_boundary(occ: np.ndarray) -> np.ndarray:
    """(F, H, W) occupancy -> (F, H*W) bool marking occupied pixels missing
    an 8-neighbor (or on the atlas border) — the points the reference tags
    type 1 via identifyBoundaryPoints (PCCCodec.cpp:266-305, which checks
    the four axial AND four diagonal neighbors, then force-tags every
    border pixel).  Geometry smoothing only moves these; interior surface
    points stay put."""
    b = occ.astype(bool)
    interior = b.copy()
    interior[:, 1:, :] &= b[:, :-1, :]
    interior[:, :-1, :] &= b[:, 1:, :]
    interior[:, :, 1:] &= b[:, :, :-1]
    interior[:, :, :-1] &= b[:, :, 1:]
    # diagonals: a staircase contour pixel with all 4 axial neighbors
    # occupied is still a boundary point in the reference
    interior[:, 1:, 1:] &= b[:, :-1, :-1]
    interior[:, 1:, :-1] &= b[:, :-1, 1:]
    interior[:, :-1, 1:] &= b[:, 1:, :-1]
    interior[:, :-1, :-1] &= b[:, 1:, 1:]
    interior[:, 0, :] = False
    interior[:, -1, :] = False
    interior[:, :, 0] = False
    interior[:, :, -1] = False
    return (b & ~interior).reshape(occ.shape[0], -1)


def occupancy_near_boundary(occ: np.ndarray) -> np.ndarray:
    """Type-2 boundary ring (identifyBoundaryPoints' second layer,
    PCCCodec.cpp:306-320): occupied pixels NOT type 1 with an unoccupied
    pixel at chebyshev distance exactly 2 (the 16 ring offsets; out-of-
    bounds ring cells do not count).  Color pre-smoothing gates on this
    set (presmoothPointCloudColor, PCCEncoder.cpp:6590)."""
    b = occ.astype(bool)
    f, h, w = b.shape
    hole_near = np.zeros_like(b)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if abs(dy) <= 1 and abs(dx) <= 1:
                continue
            sy = slice(max(dy, 0), h + min(dy, 0))
            sx = slice(max(dx, 0), w + min(dx, 0))
            ty = slice(max(-dy, 0), h + min(-dy, 0))
            tx = slice(max(-dx, 0), w + min(-dx, 0))
            hole_near[:, ty, tx] |= ~b[:, sy, sx]
    type1 = occupancy_boundary(occ).reshape(b.shape)
    return (b & ~type1 & hole_near).reshape(f, -1)


def plr_mode_map(
    patch_lists: list[list[Patch]],
    h: int,
    w: int,
    owner: np.ndarray,
) -> np.ndarray:
    """(F, H*W) uint8 per-pixel PLR mode values.

    Patch-level modes (plrd_level=1) apply to every owned pixel; patches
    carrying plrd_block_modes (plrd_level=0) override per PATCH-LOCAL
    packing block.  owner is the (F, H*W) pixel-level patch index (-1 =
    none) — patch bounding boxes may interleave, so only pixels owned by the
    patch are touched.  Canvas pixels map to patch-local coords via
    canvas_to_patch, so the block grid is orientation-free — used
    identically by the decoder and the encoder's closed loop."""
    from ..utils.enums import PatchOrientation

    swapped = {
        PatchOrientation.SWAP, PatchOrientation.ROT90,
        PatchOrientation.ROT270, PatchOrientation.MROT90,
    }
    f = len(patch_lists)
    modes = np.zeros((f, h * w), np.uint8)
    for fi, pl in enumerate(patch_lists):
        if not pl:
            continue
        vals = np.zeros(len(pl) + 1, np.uint8)
        for pi, p in enumerate(pl):
            vals[pi] = 0 if p.plr_block_modes is not None else p.plr_mode
        own = owner[fi]
        modes[fi] = vals[np.clip(own, 0, len(pl) - 1)] * (own >= 0)
        frame_modes = modes[fi].reshape(h, w)
        frame_owner = own.reshape(h, w)
        for pi, p in enumerate(pl):
            if p.plr_block_modes is None or p.plr_mode == 0:
                continue
            res = p.occupancy_resolution
            x0 = p.u0 * res
            y0 = p.v0 * res
            if p.orientation in swapped:
                wc, hc = p.size_v_pix, p.size_u_pix
            else:
                wc, hc = p.size_u_pix, p.size_v_pix
            wc = min(wc, w - x0)
            hc = min(hc, h - y0)
            if wc <= 0 or hc <= 0:
                continue
            yy, xx = np.mgrid[y0:y0 + hc, x0:x0 + wc]
            u, v = p.canvas_to_patch(xx, yy)
            bv, bu = p.plr_block_modes.shape
            bi = np.clip(v // res, 0, bv - 1)
            bj = np.clip(u // res, 0, bu - 1)
            owned = frame_owner[y0:y0 + hc, x0:x0 + wc] == pi
            blk = p.plr_block_modes[bi, bj]
            frame_modes[y0:y0 + hc, x0:x0 + wc] = np.where(
                owned, blk, frame_modes[y0:y0 + hc, x0:x0 + wc]
            )
    return modes


_PLR_NEIGHBOR_THRESHOLD = 4  # g_neighborThreshold (PCCCommon.h:127)

# canonical PLR mode table, (interpolate, filling, minD1, neighbor) —
# g_pointLocalReconstructionMode (PCCEncoderParameters.cpp:40-44); entry 0
# is the implicit no-op mode, nbPlrmMode selects the first N entries
PLR_MODE_TABLE = (
    (False, False, 0, 1), (True, False, 0, 1), (True, True, 0, 1),
    (True, False, 0, 2), (True, True, 0, 2),
    (False, False, 1, 1), (True, False, 1, 1), (True, True, 1, 1),
    (True, False, 1, 2), (True, True, 1, 2),
)


def plr_delta_neighbors(geo: np.ndarray, radius: int) -> np.ndarray:
    """getDeltaNeighbors analog (PCCCodec.cpp:238-264), vectorised: per
    pixel, the largest positive depth step to any pixel within the
    (2r+1)^2 window that stays <= g_neighborThreshold, minus one.  Depths
    are patch-relative (rel domain: D1 >= D0 for both projection modes), so
    the projection-mode sign dance collapses."""
    f, h, w = geo.shape
    g = geo.astype(np.int32)
    delta = np.zeros((f, h, w), np.int32)
    pad = np.pad(g, ((0, 0), (radius, radius), (radius, radius)),
                 mode="edge")
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[:, radius + dy: radius + dy + h,
                     radius + dx: radius + dx + w]
            d = nb - g
            ok = d <= _PLR_NEIGHBOR_THRESHOLD
            delta = np.where(ok & (d > delta), d, delta)
    return np.where(delta > 0, delta - 1, 0)


def synthesize_plr_layers(
    patch_lists: list[list[Patch]],
    geo0: np.ndarray,            # (F, H, W) rel-depth map-0 DECODED plane
    valid: np.ndarray,           # (F, H*W) bool occupied-and-owned pixels
    b2p0: np.ndarray,            # (F, H/bs, W/bs) block ownership (1-based)
    occ_dev, table_dev, counts_dev,
    block: int,
    plr_modes,                   # mode table incl. implicit entry 0
    reverse: bool,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Shared PLR layer synthesis (generatePoints, PCCCodec.cpp:472-498):
    per pixel, delta = neighborhood depth step when the mode interpolates,
    clamped up to the mode's minD1; a point lands at rel depth + delta and
    intermediate depths fill when requested.  Returns [(points (F,H*W,3),
    mask (F,H*W))].  Called by BOTH the decoder and the encoder's closed
    loop so the reconstructions stay byte-identical."""
    f, h, w = geo0.shape
    owner = np.repeat(
        np.repeat(b2p0, block, axis=1), block, axis=2
    )[:, :h, :w].reshape(f, h * w) - 1
    mode_px = plr_mode_map(patch_lists, h, w, owner)
    table_m = np.asarray([list(m) for m in plr_modes], np.int32)
    top = int(mode_px.max()) if mode_px.size else 0
    if top >= len(table_m):
        # fail loudly (stream-driver containment catches it) rather than
        # silently synthesizing with a remapped mode
        raise ValueError(
            f"coded PLR mode {top} exceeds the ASPS mode table "
            f"({len(table_m)} entries)"
        )
    interp_px = table_m[mode_px, 0].astype(bool)
    fill_px = table_m[mode_px, 1].astype(bool)
    mind_px = table_m[mode_px, 2]
    neigh_px = table_m[mode_px, 3]
    delta_px = np.zeros((f, h * w), np.int32)
    if interp_px.any():
        for r in np.unique(neigh_px[interp_px]):
            dmap = plr_delta_neighbors(geo0, int(r)).reshape(f, -1)
            sel = interp_px & (neigh_px == r)
            delta_px = np.where(sel, dmap, delta_px)
    delta_px = np.maximum(delta_px, mind_px)
    delta_px = np.where(valid, delta_px, 0)
    layers: list[tuple[np.ndarray, np.ndarray]] = []
    max_delta = int(delta_px.max()) if delta_px.size else 0
    # ship the plane ONCE; per-layer +k happens on device (one transfer
    # instead of one per synthesized layer)
    geo_dev = jnp.asarray(geo0) if max_delta else None
    for k in range(1, max_delta + 1):
        mask_k = valid & ((delta_px == k) | (fill_px & (k < delta_px)))
        if not mask_k.any():
            continue
        pts_k, _, _ = repro_ops.reproject(
            geo_dev + k, occ_dev, table_dev, counts_dev,
            block, reverse=reverse,
        )
        layers.append((np.asarray(pts_k), mask_k))
    return layers


class ReconstructionEngine:
    def __init__(self, params: GeneratePointCloudParameters | None = None):
        self.params = params or GeneratePointCloudParameters()

    # ------------------------------------------------------------------
    def occupancy_maps(
        self, occ_video: Video, width: int, height: int,
        threshold: int = 0,
    ) -> np.ndarray:
        """Occupancy video (possibly precision-downscaled, possibly lossy)
        -> (F, H, W) binary maps at full atlas resolution.  `threshold` is
        the OI lossy-occupancy threshold (0 for lossless streams)."""
        plane = np.asarray(occ_video.planes[0])
        f, oh, ow = plane.shape
        factor = width // ow
        occ = occ_ops.binarize(jnp.asarray(plane), threshold)
        if factor > 1:
            occ = occ_ops.upsample_nearest(occ, factor)
        occ = np.asarray(occ)[:, :height, :width]
        return occ

    # ------------------------------------------------------------------
    def generate_point_clouds(
        self,
        patch_lists: list[list[Patch]],
        occ_maps: np.ndarray,          # (F, H, W) uint8
        geo_video: Video,              # F*map_count frames, map-interleaved
        attr_video: Video | None,      # F*map_count frames, map-interleaved
        max_patches: int | None = None,
        map_count: int = 1,
        refl_video: Video | None = None,  # reflectance plane, map-interleaved
    ) -> list[PointSet]:
        """Batched patch->3D reprojection + coloring for a whole GOF.

        Dual-map streams (vps_map_count_minus1=1, single-stream interleave:
        frames [D0_0, D1_0, D0_1, ...]) reproject once per map; the layers
        merge per frame (duplicates removed when enabled)."""
        f, h, w = occ_maps.shape
        if max_patches is None:
            raw_max = max((len(p) for p in patch_lists), default=1)
            max_patches = max(1, round_up(raw_max, 32))
        table, counts = repro_ops.build_patch_table(patch_lists, max_patches)
        # the first NON-EMPTY frame's resolution (frame 0 can be all-raw)
        block = next(
            (pl[0].occupancy_resolution for pl in patch_lists if pl), 16
        )

        if self.params.pbf_enable:
            geo0_pbf = np.asarray(
                geo_video.planes[0]
            )[::map_count][:f, :h, :w].astype(np.int32)
            b2p_blk = np.asarray(repro_ops.block_to_patch(
                jnp.asarray(occ_maps), jnp.asarray(table),
                jnp.asarray(counts), block,
                reverse=not self.params.patch_precedence,
            ))
            owner_px = np.repeat(
                np.repeat(b2p_blk, block, axis=1), block, axis=2
            )[:, :h, :w].astype(np.int32)
            occ_maps = np.asarray(occ_ops.pbf_refine(
                jnp.asarray(occ_maps), jnp.asarray(geo0_pbf),
                jnp.asarray(owner_px),
                jnp.float32(self.params.pbf_threshold),
                passes=self.params.pbf_passes,
                radius=max(1, self.params.pbf_filter_size // 2),
            )).astype(np.uint8)
        occ_dev = jnp.asarray(occ_maps)
        table_dev = jnp.asarray(table)
        counts_dev = jnp.asarray(counts)
        pts_maps = []
        valid = None
        b2p0 = None
        for m in range(map_count):
            geo = np.asarray(geo_video.planes[0])[m::map_count][:f, :h, :w]
            if self.params.mesh is not None:
                from ..parallel.pipeline import sharded_reproject

                pts_m, valid_m, b2p_m = sharded_reproject(
                    self.params.mesh, geo.astype(np.int32),
                    occ_maps, table, counts, block,
                    reverse=not self.params.patch_precedence,
                )
            else:
                pts_m, valid_m, b2p_m = repro_ops.reproject(
                    jnp.asarray(geo.astype(np.int32)),
                    occ_dev, table_dev, counts_dev, block,
                    reverse=not self.params.patch_precedence,
                )
            pts_maps.append(np.asarray(pts_m))
            if valid is None:
                valid = np.asarray(valid_m)
                b2p0 = np.asarray(b2p_m)

        # PLR: single-map streams synthesize extra layers per the coded mode
        # table (generatePoints, PCCCodec.cpp:472-498): delta = neighborhood
        # depth step when the mode interpolates, clamped up to minD1; the
        # point lands at rel depth + delta, with intermediate depths filled
        # when the mode requests filling.
        plr_layers: list[tuple[np.ndarray, np.ndarray]] = []
        if map_count == 1 and any(
            p.plr_mode for pl in patch_lists for p in pl
        ):
            geo0 = np.asarray(geo_video.planes[0])[:f, :h, :w].astype(np.int32)
            plr_layers = synthesize_plr_layers(
                patch_lists, geo0, valid, b2p0,
                occ_dev, table_dev, counts_dev, block,
                self.params.plr_modes,
                reverse=not self.params.patch_precedence,
            )

        refl_maps = None
        if refl_video is not None:
            rp = np.asarray(refl_video.planes[0])[:, :h, :w]
            refl_maps = [
                rp[m::map_count][:f].reshape(f, h * w)
                for m in range(map_count)
            ]

        colors_maps = None
        if attr_video is not None:
            if attr_video.format == ColorFormat.RGB444:
                # 444 streams carry RGB planes directly (attributeVideo444 /
                # colorTransform=0, no chroma round-trip)
                rgb = np.stack(
                    [np.asarray(pl) for pl in attr_video.planes], axis=-1
                )[:, :h, :w]
            else:
                rgb = np.asarray(
                    yuv420_to_rgb8(
                        jnp.asarray(attr_video.planes[0]),
                        jnp.asarray(attr_video.planes[1]),
                        jnp.asarray(attr_video.planes[2]),
                    )
                )[:, :h, :w]
            colors_maps = [
                rgb[m::map_count][:f].reshape(f, h * w, 3)
                for m in range(map_count)
            ]

        boundary = occupancy_boundary(occ_maps[:, :h, :w])
        # per-point patch index (the reference's partition vector): pixel
        # block ownership minus one, same source the PLR path uses
        owner_pt = (
            np.repeat(np.repeat(b2p0, block, axis=1), block, axis=2)
            [:, :h, :w].reshape(f, h * w).astype(np.int32) - 1
        )
        clouds: list[PointSet] = []
        for fi in range(f):
            msk = valid[fi]
            pos_parts = [pm[fi][msk] for pm in pts_maps[:map_count]]
            typ_parts = [
                boundary[fi][msk].astype(np.uint8)
            ] * map_count
            part_parts = [owner_pt[fi][msk]] * map_count
            col_parts = (
                [cm[fi][msk] for cm in colors_maps]
                if colors_maps is not None
                else None
            )
            for pts_k, mask_k in plr_layers:
                pmsk = mask_k[fi]
                if not pmsk.any():
                    continue
                pos_parts.append(pts_k[fi][pmsk])
                typ_parts.append(boundary[fi][pmsk].astype(np.uint8))
                part_parts.append(owner_pt[fi][pmsk])
                if col_parts is not None:
                    # PLR points take their pixel's (map-0) color
                    col_parts.append(colors_maps[0][fi][pmsk])
            pos = np.concatenate(pos_parts, axis=0)
            col = None if col_parts is None else np.concatenate(col_parts,
                                                                axis=0)
            refl = None
            if refl_maps is not None:
                refl_parts = [rm[fi][msk] for rm in refl_maps]
                for _, mask_k in plr_layers:
                    if mask_k[fi].any():
                        refl_parts.append(refl_maps[0][fi][mask_k[fi]])
                refl = np.concatenate(refl_parts, axis=0)
            ps = PointSet(positions=pos, colors=col, reflectances=refl,
                          types=np.concatenate(typ_parts),
                          partition=np.concatenate(part_parts))
            if self.params.remove_duplicate_points:
                ps = ps.remove_duplicates()
            clouds.append(ps)
        return clouds

    # ------------------------------------------------------------------
    def block_to_patch_maps(
        self,
        patch_lists: list[list[Patch]],
        occ_maps: np.ndarray,
        block_size: int = 16,
        max_patches: int | None = None,
    ) -> np.ndarray:
        """(F, H/bs, W/bs) int32 block ownership maps (0 = none)."""
        if max_patches is None:
            raw_max = max((len(p) for p in patch_lists), default=1)
            max_patches = max(1, round_up(raw_max, 32))
        table, counts = repro_ops.build_patch_table(patch_lists, max_patches)
        return np.asarray(
            repro_ops.block_to_patch(
                jnp.asarray(occ_maps), jnp.asarray(table), jnp.asarray(counts),
                block_size, reverse=not self.params.patch_precedence,
            )
        )
