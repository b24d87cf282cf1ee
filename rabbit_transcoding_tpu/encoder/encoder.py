"""The V-PCC encoder pipeline.

Capability parity with PCCEncoder (/root/reference/source/lib/PccLibEncoder/
source/PCCEncoder.cpp:69-477 stage loop): segmentation -> packing ->
occupancy/geometry video -> geometry-closed-loop reconstruction -> recolor ->
attribute video -> atlas tile layers + parameter sets.

Device layout: all per-pixel stages (padding fill, video transforms,
reprojection) run batched over the whole GOF on device; host does
segmentation graph work, packing, entropy and syntax.
"""

from __future__ import annotations

import sys

import numpy as np

from ..bitstream.hls import AtlasHLS, Context
from ..bitstream.syntax import (
    AtlasFrameParameterSetRbsp,
    AtlasSequenceParameterSetRbsp,
    AtlasTileDataUnit,
    AtlasTileHeader,
    AtlasTileLayerRbsp,
    AttributeInformation,
    PatchDataUnit,
    PatchInformationData,
    RefListStruct,
    V3CParameterSet,
)
from ..bitstream.video_bitstream import VideoBitstream
from ..codec.patch_frame import projection_id_of
from ..codec.reconstruct import GeneratePointCloudParameters, ReconstructionEngine
from ..core.gof import GroupOfFrames
from ..core.image import Video
from ..core.pointset import PointSet
from ..ops import reproject as repro_ops
from ..ops.color import rgb8_to_yuv420, yuv420_to_rgb8
from ..ops.dilate import pad_pow2, push_pull_fill
from ..ops.occupancy import downscale_maxpool
from ..ops.recolor import RecolorParams, transfer_colors, transfer_colors_fwd_bwd
from ..utils.enums import (
    AtlasTileType,
    ColorFormat,
    PatchModeITile,
    VideoType,
)
from ..utils.timing import StageTimer
from .matching import (
    align_matched_patch,
    match_patches,
    pad_seg_to_quantizer,
)
from .packing import (
    pack_gof_adaptive,
    pack_gof_global,
    pack_patches,
    pack_patches_consistent,
)
from .params import EncoderParameters
from .rasterize import rasterize_frame
from .segment import SegmenterParams, segment_frame

import jax.numpy as jnp


def _patch_id_map(
    frame_segs, width: int, height: int, block: int
) -> np.ndarray:
    """(F, height, width) int32 per-pixel patch owner (-1 background) from
    the packed patch footprints — the patch information the reference's
    patchColorSubsampling path consumes (PCCVideoEncoder.cpp:78)."""
    from .packing import _block_footprint, _oriented_footprint

    nbx, nby = width // block, height // block
    out = np.full((len(frame_segs), nby, nbx), -1, np.int32)
    for fi, segs in enumerate(frame_segs):
        for i, seg in enumerate(segs):
            cfp = _oriented_footprint(
                _block_footprint(seg, block), seg.patch.orientation
            )
            w_b, h_b = cfp.shape
            y1 = min(seg.patch.v0 + h_b, nby)
            x1 = min(seg.patch.u0 + w_b, nbx)
            region = out[fi, seg.patch.v0:y1, seg.patch.u0:x1]
            region[cfp.T[: region.shape[0], : region.shape[1]]] = i
    return np.repeat(
        np.repeat(out, block, axis=1), block, axis=2
    )[:, :height, :width]


_pad_seg_to_quantizer = pad_seg_to_quantizer


def _max_size_d(geom2d: int, geom3d: int, d_shift: int) -> int:
    """Largest decodable patch depth range: pdu_3d_range_d codes in
    max(1, min(geom2d, geom3d) - quantizer) bits, in quantDD units when the
    quantizer is non-zero (decoded sizeD = units*minLevel - 1)."""
    bits = max(1, min(geom2d, geom3d) - d_shift)
    q_max = (1 << bits) - 1
    return q_max * (1 << d_shift) - 1 if d_shift else q_max


def _plr_coded_modes(nb_plrm_mode: int):
    """The coded plri descriptors: canonical table entries 1..N-1 (entry 0
    is the implicit no-op mode)."""
    from ..codec.reconstruct import PLR_MODE_TABLE

    return PLR_MODE_TABLE[1:max(2, min(nb_plrm_mode, 10))]


def _roi_index(centroid, rois) -> int:
    """ROI containing the centroid; nearest ROI center when outside all."""
    best, best_d = 0, float("inf")
    for i, (x0, x1, y0, y1, z0, z1) in enumerate(rois):
        if (x0 <= centroid[0] <= x1 and y0 <= centroid[1] <= y1
                and z0 <= centroid[2] <= z1):
            return i
        cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
        d = (
            (centroid[0] - cx) ** 2
            + (centroid[1] - cy) ** 2
            + (centroid[2] - cz) ** 2
        )
        if d < best_d:
            best, best_d = i, d
    return best


class Encoder:
    def __init__(self, params: EncoderParameters | None = None):
        self.params = params or EncoderParameters()
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def _venc(self, role: str, lossless: bool = False):
        """Video encoder for one role, honoring the per-component codec
        selection (videoEncoder<Comp>CodecId; PCCVideoEncoder::compress ->
        PCCVirtualVideoEncoder dispatch, PCCVideoEncoder.cpp:282)."""
        from ..video.base import component_encoder

        return component_encoder(self.params, role, lossless)

    def _pbf_knobs(self) -> tuple[int, int, float]:
        """(passes, filter size, threshold) for patch-border filtering.
        0 means auto, derived exactly like the reference
        (PCCEncoderParameters.cpp:1132-1133: passes from occupancyPrecision,
        size = occupancyPrecision); clamped to the occupancy-synthesis SEI
        field widths so the decoder rederives the identical values."""
        p = self.params
        passes = p.pbfPassesCount or (
            1 if p.occupancyPrecision <= 2
            else 2 if p.occupancyPrecision == 4 else 4
        )
        size = p.pbfFilterSize or p.occupancyPrecision
        log2_thr = min(4, max(1, p.pbfLog2Threshold))
        return min(4, max(1, passes)), min(8, max(1, size)), float(1 << log2_thr)

    def _external(self, comp: str) -> bool:
        """True when an external (non-RBV) codec is selected for the
        component — the closed loop must then trust the binary's recon."""
        from ..utils.enums import CodecId
        from ..video.base import component_codec_id

        return component_codec_id(self.params, comp) not in (
            CodecId.RBV, CodecId.RBV_LOSSLESS,
        )

    # ------------------------------------------------------------------
    def _gpa_beneficial(self, frame_segs, width: int, p) -> bool:
        """The DATA-ADAPTIVE part of GPA (performDataAdaptiveGPAMethod,
        PCCEncoder.cpp:6792): trial-pack the GOF both globally (one chain-
        owned grid, positions stable all GOF) and per-frame (spatially
        consistent), then keep GPA only if its atlas height cost is within
        gpaHeightTolerance of the per-frame packing.  Trials run on deep
        copies; the winner is packed for real by the caller."""
        import copy

        d_shift = max(0, max(1, p.depthQuantizationStep).bit_length() - 1)
        kw = dict(
            block=p.occupancyResolution,
            try_orientations=p.useEightOrientations,
            safeguard=p.safeGuardDistance,
            low_delay=p.lowDelayEncoding,
        )
        min_h = max(p.minimumImageHeight, 64)
        trial_g = copy.deepcopy(frame_segs)
        for fi in range(1, len(trial_g)):
            match_patches(trial_g[fi - 1], trial_g[fi],
                          max_candidate_count=p.maxCandidateCount)
            # the real GPA path aligns matched patches (which GROWS them,
            # up to max_grow px/axis) before packing — the trial must do the
            # same or its height underestimates and the real pack can
            # overflow where the trial said it fit
            for seg in trial_g[fi]:
                ri = seg.patch.best_match_idx
                if ri >= 0:
                    align_matched_patch(
                        seg, trial_g[fi - 1][ri],
                        max_depth=(1 << p.geometryNominal2dBitdepth) - 1,
                        max_size_d=_max_size_d(
                            p.geometryNominal2dBitdepth,
                            p.geometry3dCoordinatesBitdepth, d_shift,
                        ),
                        qx=1 << max(0, p.log2QuantizerSizeX),
                        qy=1 << max(0, p.log2QuantizerSizeY),
                    )
        try:
            h_gpa = pack_gof_adaptive(
                trial_g, width, min_h,
                window=p.globalPackingStrategyGOF,
                reset_chains=p.globalPackingStrategyReset,
                area_ratio_threshold=p.globalPackingStrategyThreshold,
                **kw,
            )
        except RuntimeError:
            return False  # global grid overflowed: per-frame it is
        trial_f = copy.deepcopy(frame_segs)
        h_frame = 0
        for fi, segs in enumerate(trial_f):
            if fi > 0:
                match_patches(trial_f[fi - 1], segs,
                              max_candidate_count=p.maxCandidateCount)
                h = pack_patches_consistent(
                    segs, trial_f[fi - 1], width, min_h, **kw
                )
            else:
                h = pack_patches(segs, width, min_h, **kw)
            h_frame = max(h_frame, h)
        return h_gpa <= h_frame * p.gpaHeightTolerance

    # ------------------------------------------------------------------
    def encode(
        self, sources: GroupOfFrames
    ) -> tuple[Context, list[PointSet]]:
        """Encode one GOF -> (bitstream Context, decoder-identical recon)."""
        p = self.params
        if p.pointLocalReconstruction and p.mapCountMinus1 == 0 and (
            p.log2QuantizerSizeX == 0 and p.log2QuantizerSizeY == 0
        ):
            # The reference parser sizes every PLR block map by the CODED
            # patch size units directly (PCCBitstreamReader.cpp plrd
            # allocate), so PLR streams must code sizes in packing-block
            # units, exactly as TMC2 does.  Idempotent across GOFs.
            block_log2 = max(0, p.occupancyResolution.bit_length() - 1)
            p.log2QuantizerSizeX = block_log2
            p.log2QuantizerSizeY = block_log2
        # depthQuantizationStep rounds to a power of two: ath_pos_min_d is a
        # bit-shift quantizer (23090-5), so the effective minLevel is 1<<n
        d_shift = max(0, max(1, p.depthQuantizationStep).bit_length() - 1)
        seg_params = SegmenterParams(
            nn_normal_estimation=p.nnNormalEstimation,
            max_nn_count_refine_segmentation=p.maxNNCountRefineSegmentation,
            iteration_count_refine_segmentation=p.iterationCountRefineSegmentation,
            lambda_refine_segmentation=p.lambdaRefineSegmentation,
            normal_orientation=p.normalOrientation,
            grid_based_refine_segmentation=p.gridBasedRefineSegmentation,
            voxel_dimension_refine_segmentation=(
                p.voxelDimensionRefineSegmentation
            ),
            search_radius_refine_segmentation=(
                p.searchRadiusRefineSegmentation
            ),
            min_point_count_per_cc_patch_segmentation=(
                p.minPointCountPerCCPatchSegmentation
            ),
            surface_thickness=p.surfaceThickness,
            surface_separation=p.surfaceSeparation,
            max_patch_size=p.maxPatchSize,
            enable_patch_splitting=p.enablePatchSplitting,
            patch_expansion=p.patchExpansion,
            # the bit budget only un-covers interior points when EOM bits
            # are actually coded; without EOM the D0..D1 span covers them
            eom_fix_bit_count=(
                max(1, min(p.EOMFixBitCount, 7))
                if p.enhancedOccupancyMapCode else 7
            ),
            max_allowed_depth=(1 << p.geometryNominal2dBitdepth) - 1,
            min_level=1 << d_shift,
            # pdu_3d_range_d bit budget (see hls.syntax_context): the patch
            # depth range must stay codable or BitWriter.u would overflow
            max_size_d=_max_size_d(
                p.geometryNominal2dBitdepth, p.geometry3dCoordinatesBitdepth,
                d_shift,
            ),
            # mode 5 dispatches via segment_frame_partial (which sets the
            # per-pass modes itself); the plain path sees canonical
            additional_projection_mode=(
                0 if p.additionalProjectionPlaneMode == 5
                else p.additionalProjectionPlaneMode
            ),
            rot_offset=1 << p.geometry3dCoordinatesBitdepth,
            level_of_detail_x=p.levelOfDetailX,
            level_of_detail_y=p.levelOfDetailY,
            grid_based_segmentation=p.gridBasedSegmentation,
            voxel_dimension_grid_based_segmentation=(
                p.voxelDimensionGridBasedSegmentation
            ),
            high_gradient_separation=p.highGradientSeparation,
            min_gradient=p.minGradient,
            min_num_high_gradient_points=p.minNumHighGradientPoints,
            max_cc_edge_distance=p.maxCCEdgeDistance,
            max_nn_count_patch_segmentation=p.maxNNCountPatchSegmentation,
            max_allowed_dist2_raw_points_detection=(
                p.maxAllowedDist2RawPointsDetection
            ),
            # lossless completeness is exact-key based; selection 0 keeps
            # the segmentation missed set aligned with it
            max_allowed_dist2_raw_points_selection=(
                0.0 if p.losslessGeo else p.maxAllowedDist2RawPointsSelection
            ),
            partition_rois=(
                tuple(p.roi_boxes())
                if p.enablePointCloudPartitioning and p.roi_boxes()
                else ()
            ),
            partition_cuts=(
                p.numCutsAlong1stLongestAxis,
                p.numCutsAlong2ndLongestAxis,
                p.numCutsAlong3rdLongestAxis,
            ),
        )

        if p.apply3dMotionCompensation:
            # 3D-consistent motion rides the RBV MC search here
            p.motionEstimation = True
        if p.enhancedOccupancyMapCode and p.occupancyPrecision != 1:
            # EOM bit planes ride the occupancy samples; any downscale
            # destroys them (reference couples EOM with lossless occupancy)
            p.occupancyPrecision = 1
        if p.losslessGeo:
            # lossless geometry: exact occupancy (precision blocks would add
            # spurious points), no decoder-side point-moving post-processing,
            # no synthesis modes (the reference's lossless common cfg pins
            # the same couplings, ctc-common-lossless-geometry.cfg)
            p.occupancyPrecision = 1
            p.flagGeometrySmoothing = False
            p.flagColorSmoothing = False
            p.pbfEnableFlag = False
            p.pointLocalReconstruction = False
            p.singleMapPixelInterleaving = False
            p.lossyOccupancyMap = False
        if p.attributeVideo444:
            # 444 planes cannot checkerboard through the 420 interleave path
            p.singleMapPixelInterleaving = False
        if p.roi_boxes():
            # ROI tiling: one tile per ROI (generateTilesFromSegments)
            p.tileCount = max(p.tileCount, len(p.roi_boxes()))
        if p.tileSegmentationType >= 2:
            # fixed grid of numMaxTilePerFrame tiles
            p.tileCount = max(p.tileCount, max(1, p.numMaxTilePerFrame))
        elif p.tileSegmentationType == 0 and not p.roi_boxes():
            p.tileCount = max(1, p.tileCount)
        if p.multipleStreams:
            # per-map sub-streams exclude the single-map interleave modes
            p.singleMapPixelInterleaving = False
        if p.mapCountMinus1 == 0 or not p.multipleStreams:
            # predicted map coding only exists with 2 maps in own streams
            p.absoluteD1 = True
            p.absoluteT1 = True
        if p.absoluteT1 != p.absoluteD1:
            # ONE VPS flag (vps_map_absolute_coding_enabled_flag[1]) tells
            # the decoder whether map-1 streams are deltas; split settings
            # would mis-decode one component (the reference CTC couples
            # them too — D1-from-rec-D0 conditions always pair with T1)
            p.absoluteT1 = p.absoluteD1
        if p.losslessAttribute and not p.absoluteT1:
            # the predicted T1 residual clips its bias to [0,255]: any
            # map0/map1 color difference beyond +/-128 would be destroyed —
            # incompatible with a lossless attribute promise (one VPS flag
            # couples D1/T1, so both go absolute)
            print(
                "warning: losslessAttribute forces absolute map coding "
                "(the predicted-T1 residual clips large map deltas)",
                file=sys.stderr,
            )
            p.absoluteT1 = True
            p.absoluteD1 = True

        # 1. segmentation + packing (per frame; all-intra atlas)
        with self.timer.stage("generateSegments"):
            if p.enhancedProjectionPlane and len(sources):
                # per-GOF axis weights from the first frame's projected-face
                # coverage (the reference computes from sources[0] too)
                from .segment import calculate_weight_normal

                seg_params.axis_weight = tuple(calculate_weight_normal(
                    sources[0].positions, p.geometry3dCoordinatesBitdepth,
                    p.minWeightEPP,
                ))
            use_partial = (
                p.additionalProjectionPlaneMode == 5
                and 0.0 < p.partialAdditionalProjectionPlane < 1.0
            )
            frame_segs = []
            raw_points: list[np.ndarray] = []
            raw_colors: list[np.ndarray | None] = []
            for ps in sources:
                seg_colors = (
                    ps.colors
                    if ps.has_colors and p.surfaceSeparation
                    else None
                )
                if use_partial:
                    from .segment import segment_frame_partial

                    segs, missed = segment_frame_partial(
                        ps.positions.astype(np.int32), seg_params,
                        p.partialAdditionalProjectionPlane,
                        colors=seg_colors,
                    )
                else:
                    segs, missed = segment_frame(
                        ps.positions.astype(np.int32), seg_params,
                        colors=seg_colors,
                    )
                if p.occupancyMapRefinement:
                    # refineOccupancyMap: evict one-point precision tiles
                    # and <4-point packing blocks; their points go raw
                    from .segment import refine_occupancy

                    extra = [
                        refine_occupancy(
                            seg, ps.positions.astype(np.int32),
                            p.occupancyResolution, p.occupancyPrecision,
                            rot_offset=seg_params.rot_offset,
                        )
                        for seg in segs
                    ]
                    extra = [e for e in extra if len(e)]
                    if extra:
                        missed = np.unique(
                            np.concatenate([missed] + extra)
                        )
                frame_segs.append(segs)
                if p.rawPointsPatch and len(missed):
                    raw_points.append(ps.positions[missed].astype(np.int32))
                    raw_colors.append(
                        ps.colors[missed]
                        if ps.has_colors and not p.noAttributes
                        else None
                    )
                else:
                    raw_points.append(np.zeros((0, 3), np.int32))
                    raw_colors.append(None)
        # patch-size quantizer: pad every patch to (1<<log2QuantizerSize)
        # multiples BEFORE packing so coded sizes stay exact and placements
        # reserve the padded footprint
        qpx = 1 << max(0, p.log2QuantizerSizeX)
        qpy = 1 << max(0, p.log2QuantizerSizeY)
        if qpx > 1 or qpy > 1:
            for segs in frame_segs:
                for seg in segs:
                    _pad_seg_to_quantizer(seg, qpx, qpy)

        with self.timer.stage("placeSegments"):
            width = p.minimumImageWidth
            use_inter = p.constrainedPack and p.tileCount <= 1 and len(
                frame_segs
            ) > 1
            if use_inter and p.globalPatchAllocation and (
                self._gpa_beneficial(frame_segs, width, p)
            ):
                # GPA: match+align every adjacent pair, then pack the whole
                # GOF on one chain-owned grid; finally impose decode order
                # and remap reference indices through the permutations
                for fi in range(1, len(frame_segs)):
                    match_patches(frame_segs[fi - 1], frame_segs[fi],
                                  max_candidate_count=p.maxCandidateCount)
                    for seg in frame_segs[fi]:
                        ri = seg.patch.best_match_idx
                        if ri >= 0:
                            align_matched_patch(
                                seg, frame_segs[fi - 1][ri],
                                max_depth=(
                                    (1 << p.geometryNominal2dBitdepth) - 1
                                ),
                                max_size_d=_max_size_d(
                                    p.geometryNominal2dBitdepth,
                                    p.geometry3dCoordinatesBitdepth, d_shift,
                                ),
                                qx=qpx, qy=qpy,
                            )
                height = pack_gof_adaptive(
                    frame_segs, width, max(p.minimumImageHeight, 64),
                    block=p.occupancyResolution,
                    try_orientations=p.useEightOrientations,
                    safeguard=p.safeGuardDistance,
                    low_delay=p.lowDelayEncoding,
                    window=p.globalPackingStrategyGOF,
                    reset_chains=p.globalPackingStrategyReset,
                    area_ratio_threshold=p.globalPackingStrategyThreshold,
                )
                height = -(-height // 64) * 64
                tile_band = height
                # demote matches whose placement lost non-codeable inter
                # fields: InterPatchDataUnit does not code orientation, so
                # a matched patch packed with a different orientation than
                # its reference would decode with the wrong transform
                # (mirrors the per-frame branch's demotion below)
                for fi in range(1, len(frame_segs)):
                    prev = frame_segs[fi - 1]
                    for seg in frame_segs[fi]:
                        ri = seg.patch.best_match_idx
                        if ri >= 0 and (
                            seg.patch.orientation
                            != prev[ri].patch.orientation
                        ):
                            seg.patch.best_match_idx = -1
                prev_perm = list(range(len(frame_segs[0])))
                for fi in range(1, len(frame_segs)):
                    segs = frame_segs[fi]
                    old_to_new = {old: new for new, old in
                                  enumerate(prev_perm)}
                    for seg in segs:
                        ri = seg.patch.best_match_idx
                        if ri >= 0:
                            seg.patch.best_match_idx = old_to_new[ri]
                    order = sorted(
                        range(len(segs)),
                        key=lambda i: (
                            (0, segs[i].patch.best_match_idx)
                            if segs[i].patch.best_match_idx >= 0
                            else (1, i)
                        ),
                    )
                    frame_segs[fi] = [segs[i] for i in order]
                    prev_perm = order
                    for i2, seg in enumerate(frame_segs[fi]):
                        seg.patch.index = i2
            elif p.tileCount <= 1:
                height = p.minimumImageHeight
                for fi, segs in enumerate(frame_segs):
                    if use_inter and fi > 0:
                        prev = frame_segs[fi - 1]
                        match_patches(prev, segs,
                                      max_candidate_count=p.maxCandidateCount)
                        for seg in segs:
                            ri = seg.patch.best_match_idx
                            if ri >= 0:
                                align_matched_patch(
                                    seg, prev[ri],
                                    max_depth=(
                                        (1 << p.geometryNominal2dBitdepth) - 1
                                    ),
                                    max_size_d=_max_size_d(
                                        p.geometryNominal2dBitdepth,
                                        p.geometry3dCoordinatesBitdepth, d_shift,
                                    ),
                                    qx=qpx, qy=qpy,
                                )
                        h = pack_patches_consistent(
                            segs, prev, width, max(height, 64),
                            block=p.occupancyResolution,
                            try_orientations=p.useEightOrientations,
                            safeguard=p.safeGuardDistance,
                            low_delay=p.lowDelayEncoding,
                        )
                        # demote matches whose placement lost non-codeable
                        # inter fields (orientation is inherited, not coded)
                        for seg in segs:
                            ri = seg.patch.best_match_idx
                            if ri >= 0 and (
                                seg.patch.orientation
                                != prev[ri].patch.orientation
                            ):
                                seg.patch.best_match_idx = -1
                        # decode order: matched (by ref idx) first, then new —
                        # the video/b2p pipelines must see the same order the
                        # ATL will code
                        segs.sort(
                            key=lambda s: (
                                (0, s.patch.best_match_idx)
                                if s.patch.best_match_idx >= 0
                                else (1, s.patch.index)
                            )
                        )
                        for i, seg in enumerate(segs):
                            seg.patch.index = i
                    else:
                        h = pack_patches(
                            segs, width, max(height, 64),
                            block=p.occupancyResolution,
                            try_orientations=p.useEightOrientations,
                            safeguard=p.safeGuardDistance,
                            tetris=p.packingStrategy == 1,
                            low_delay=p.lowDelayEncoding,
                        )
                    height = max(height, h)
                height = -(-height // 64) * 64
                tile_band = height
            else:
                # uniform-band tiling: patches balanced over tiles by area,
                # each (frame, tile) packed independently; band = max height.
                # With roiBoundingBox* set, tiles ARE the ROIs and a patch
                # tiles by the ROI containing its 3D centroid
                # (generateTilesFromSegments, PCCEncoder.cpp:5108)
                band = 64
                rois = p.roi_boxes()
                for fi, segs in enumerate(frame_segs):
                    if rois:
                        pos = sources[fi].positions
                        for seg in segs:
                            c = pos[seg.point_indices].mean(axis=0)
                            seg.patch.tile_index = _roi_index(c, rois)
                    else:
                        order = sorted(
                            segs, key=lambda s: s.occupancy.sum(),
                            reverse=True,
                        )
                        for i, seg in enumerate(order):
                            seg.patch.tile_index = i % p.tileCount
                    for t in range(p.tileCount):
                        group = [s for s in segs if s.patch.tile_index == t]
                        if group:
                            h = pack_patches(
                                group, width, 64,
                                block=p.occupancyResolution,
                                try_orientations=p.useEightOrientations,
                                safeguard=p.safeGuardDistance,
                                tetris=p.packingStrategy == 1,
                                low_delay=p.lowDelayEncoding,
                            )
                            band = max(band, h)
                band = -(-band // 64) * 64
                band_blocks = band // p.occupancyResolution
                for segs in frame_segs:
                    for seg in segs:
                        seg.patch.v0 += seg.patch.tile_index * band_blocks
                height = band * p.tileCount
                tile_band = band

        # 1b. PLR search (single-map): per patch (or packing block) pick the
        # coded mode whose synthesized depth set best matches the true
        # second-layer depths (pointLocalReconstructionSearch analog,
        # PCCEncoder.cpp:5364-5527 — the reference measures 3D block
        # distances; here the same comparison runs per pixel along the
        # normal axis, vectorised over the whole patch)
        use_plr = p.pointLocalReconstruction and p.mapCountMinus1 == 0
        if use_plr:
            from ..codec.reconstruct import (
                PLR_MODE_TABLE,
                plr_delta_neighbors,
            )

            plr_table = PLR_MODE_TABLE[:max(2, min(p.nbPlrmMode, 10))]
            ppbs = p.occupancyResolution
            for segs in frame_segs:
                for seg in segs:
                    occ = seg.occupancy
                    if not occ.any():
                        continue
                    t = np.where(occ, seg.depth1 - seg.depth0, 0)
                    g = np.where(occ, seg.depth0, -(10 ** 6))[None]
                    # only the radii the active mode table interpolates with
                    radii = {m[3] for m in plr_table if m[0]}
                    dmaps = {
                        r: plr_delta_neighbors(g, r)[0] for r in radii
                    }
                    # per-mode squared-distance error along the normal axis:
                    # synthesized depths score their distance to the true
                    # set {0, t}; the true far layer scores its distance to
                    # the nearest synthesized depth (or 0) — the 1D
                    # equivalent of the reference's 3D block distances
                    tpos = t > 0
                    errs = []
                    for interp, fill, mind, neigh in plr_table:
                        dm = dmaps[neigh] if interp else np.zeros_like(t)
                        dm = np.minimum(np.maximum(dm, mind), 5)
                        if fill:
                            fwd = np.zeros(t.shape)
                            for s in range(1, 6):
                                c = np.minimum(s, np.abs(s - t)) ** 2
                                fwd += np.where(dm >= s, c, 0)
                            back = np.where(t <= dm, 0, (t - dm) ** 2)
                        else:
                            fwd = np.where(
                                dm > 0,
                                np.minimum(dm, np.abs(dm - t)) ** 2, 0,
                            )
                            back = np.where(
                                dm > 0,
                                np.minimum(t, np.abs(t - dm)) ** 2, t ** 2,
                            )
                        back = np.where(dm == 0, t ** 2, back)
                        err = fwd + np.where(tpos, back, 0)
                        errs.append(np.where(occ, err, 0))
                    errs = np.stack(errs)                    # (M, su, sv)
                    su, sv = occ.shape
                    bu = (su + ppbs - 1) // ppbs
                    bv = (sv + ppbs - 1) // ppbs
                    # small patches always decide at patch level
                    # (plri_block_threshold_per_patch, PCCEncoder.cpp:5418)
                    if p.plrLevel != 0 or bu * bv <= p.patchSize:
                        seg.patch.plr_mode = int(errs.sum((1, 2)).argmin())
                        seg.patch.plr_block_modes = None
                    else:
                        ep = np.zeros((len(plr_table), bu * ppbs, bv * ppbs),
                                      errs.dtype)
                        ep[:, :su, :sv] = errs
                        blk_err = ep.reshape(
                            len(plr_table), bu, ppbs, bv, ppbs
                        ).sum((2, 4))
                        # seg arrays are (size_u, size_v) u-major; the plrd
                        # grid is (size_v0, size_u0) v-major -> transpose
                        modes = blk_err.argmin(axis=0).astype(np.uint8).T
                        occ_p = np.zeros((bu * ppbs, bv * ppbs), bool)
                        occ_p[:su, :sv] = occ
                        occ_b = occ_p.reshape(bu, ppbs, bv, ppbs).any((1, 3))
                        modes = np.where(occ_b.T, modes, 0).astype(np.uint8)
                        seg.patch.plr_block_modes = modes
                        seg.patch.plr_mode = int(modes.any())

        # 2. rasterize occupancy + geometry planes (map-interleaved layout:
        # plane index = frame * M + map, the reference's single-stream
        # dual-map mode)
        n_frames = len(sources)
        n_maps = p.mapCountMinus1 + 1
        with self.timer.stage("generateOccupancyMapVideo"):
            geo_planes = np.zeros((n_frames * n_maps, height, width), np.uint16)
            occ_planes = np.zeros((n_frames, height, width), np.uint8)
            for i, segs in enumerate(frame_segs):
                g0, g1, occ_planes[i] = rasterize_frame(
                    segs, width, height,
                    with_eom=p.enhancedOccupancyMapCode,
                )
                geo_planes[i * n_maps] = g0
                if n_maps > 1:
                    geo_planes[i * n_maps + 1] = g1
        if True:
            # cross-patch block-ownership casualties: a pixel rasterized by
            # patch A inside a block that b2p precedence awards to patch B
            # reprojects through B's transform into a spurious point.  Drop
            # such pixels from occupancy (their source points fall to the
            # raw patch in the completeness passes below); clearing never
            # flips a surviving block's owner — remaining pixels belong to
            # the owner, whose bbox claim is unchanged.  Round 5: no longer
            # lossless-only — on high-curvature content the spurious points
            # measured 46..79 voxels off (rec->src mse 47, a 17 dB D1
            # collapse, results/endurance_drift_300f.csv); zeroing the
            # geometry before padding also parks the occupancy-precision
            # superset pixels on the owner's dilated surface.
            patch_lists0 = [[s.patch for s in segs] for segs in frame_segs]
            maxp0 = max(1, -(-max(len(pl) for pl in patch_lists0) // 32) * 32)
            tbl0, cnt0 = repro_ops.build_patch_table(patch_lists0, maxp0)
            b2p_blk0 = np.asarray(repro_ops.block_to_patch(
                jnp.asarray(occ_planes), jnp.asarray(tbl0), jnp.asarray(cnt0),
                p.occupancyResolution, reverse=not p.patchPrecedenceOrder,
            ))
            blk_owner_px = np.repeat(
                np.repeat(b2p_blk0, p.occupancyResolution, axis=1),
                p.occupancyResolution, axis=2,
            )[:, :height, :width]
            for i, segs in enumerate(frame_segs):
                pix_owner = np.zeros((height, width), np.int32)
                for k, seg in enumerate(segs):
                    u, v = np.nonzero(seg.occupancy)
                    if len(u):
                        x, y = seg.patch.patch_to_canvas(u, v)
                        pix_owner[y, x] = k + 1
                bad = (occ_planes[i] > 0) & (pix_owner != blk_owner_px[i])
                if bad.any():
                    occ_planes[i][bad] = 0
                    for m in range(n_maps):
                        geo_planes[i * n_maps + m][bad] = 0

        # 3. encode occupancy (precision-downscaled, lossless)
        from ..video import VideoDecoder, VideoEncoder, VideoEncoderParams
        from ..utils.enums import CodecId

        occ_small = np.asarray(
            downscale_maxpool(jnp.asarray(occ_planes), p.occupancyPrecision)
        )
        use_lossy_occ = p.lossyOccupancyMap and not p.enhancedOccupancyMapCode
        # occupied pixels code as offsetLossyOM (0 = full range, our DCT-
        # friendly default); decoder binarises at the OI-carried threshold
        # (thresholdLossyOM, 0 = half the offset) — PCCEncoder.cpp:901,973
        occ_fill = p.offsetLossyOM if p.offsetLossyOM > 0 else 255
        occ_threshold = (
            (p.thresholdLossyOM if p.thresholdLossyOM > 0 else occ_fill // 2)
            if use_lossy_occ else 0
        )
        if use_lossy_occ:
            occ_plane = (occ_small > 0).astype(np.uint8) * np.uint8(occ_fill)
            if p.prefilterLossyOM:
                from ..ops.occupancy import prefilter_lossy_om

                occ_plane = np.asarray(
                    prefilter_lossy_om(jnp.asarray(occ_plane))
                )
            occ_video = Video(
                width // p.occupancyPrecision, height // p.occupancyPrecision,
                8, ColorFormat.YUV400, [occ_plane],
            )
            occ_payload, occ_recon = self._venc("occupancy").encode(
                occ_video,
                VideoEncoderParams(qp=p.occupancyMapQP, all_intra=True),
            )
            occ_small_dec = (
                np.asarray(occ_recon.planes[0]) > occ_threshold
            ).astype(np.uint8)
        else:
            occ_video = Video(
                width // p.occupancyPrecision, height // p.occupancyPrecision,
                8, ColorFormat.YUV400, [occ_small],
            )
            occ_payload, occ_recon = self._venc(
                "occupancy", lossless=True
            ).encode(occ_video, VideoEncoderParams(lossless=True, qp=0))
            if self._external("Occupancy"):
                # external binaries may not be exactly lossless (their cfg
                # decides): the closed loop consumes the binary's recon,
                # binarised the way a decoder binarises occupancy
                occ_small_dec = (
                    np.asarray(occ_recon.planes[0]) > 0
                ).astype(np.uint8)
            else:
                occ_small_dec = occ_small
        # decoder-side occupancy: precision blocks become fully occupied —
        # the closed loop below must reconstruct exactly what a decoder sees
        from ..ops.occupancy import upsample_nearest

        occ_decoded = np.asarray(
            upsample_nearest(jnp.asarray(occ_small_dec), p.occupancyPrecision)
        )[:, :height, :width]

        # 4. geometry video: background fill + lossy encode (closed loop)
        with self.timer.stage("generateGeometryVideo"):
            if p.losslessGeo:
                # no background fill: occupied pixels must survive exactly
                # and all-zero background deflates to nothing
                filled = geo_planes.astype(np.float32)
            else:
                occ_rep = np.repeat(occ_planes, n_maps, axis=0)
                gpad, opad, (oh, ow) = pad_pow2(
                    geo_planes.astype(np.float32), occ_rep
                )
                filled = np.asarray(
                    push_pull_fill(jnp.asarray(gpad), jnp.asarray(opad))
                )[:, :oh, :ow]
                if p.geometryPadding == 1:
                    # dilate3DPadding analog (PCCEncoder.cpp:5989): pixels
                    # the DECODED occupancy claims but the original does not
                    # become real points, so give them near-surface depths
                    # (4-neighbour propagation from occupied pixels) instead
                    # of wide-area push-pull averages
                    from ..ops.dilate import dilate

                    near = np.asarray(dilate(
                        jnp.asarray(gpad), jnp.asarray(opad),
                        iterations=max(2, p.occupancyPrecision),
                    ))[:, :oh, :ow]
                    rim = (np.repeat(occ_decoded, n_maps, axis=0) > 0) & (
                        occ_rep == 0)
                    filled = np.where(rim, near, filled)
                if (p.groupDilation and p.absoluteD1 and n_maps == 2
                        and not p.multipleStreams
                        and not p.singleMapPixelInterleaving):
                    from ..ops.dilate import group_dilation

                    filled = group_dilation(filled, occ_planes, n_maps)
            geo_video = Video(
                width, height, p.geometryNominal2dBitdepth, ColorFormat.YUV400,
                [np.clip(np.round(filled), 0,
                         (1 << p.geometryNominal2dBitdepth) - 1).astype(np.uint16)],
            )
            # with interleaved maps, the GOP spans videoGopSize source
            # frames x n_maps planes: D1 predicts D0 and (with consistent
            # packing) the next frame's D0 predicts the previous D1
            geo_gop = n_maps * (1 if p.allIntra else p.videoGopSize)
            geo_gop = max(1, geo_gop)
            use_pi = p.singleMapPixelInterleaving and n_maps == 2
            if use_pi:
                # single-map pixel interleaving: both maps checkerboard
                # into ONE F-frame video (asps_pixel_deinterleaving_flag)
                from ..ops.interleave import interleave_maps

                gpl = geo_video.planes[0]
                geo_video = Video(
                    width, height, p.geometryNominal2dBitdepth,
                    ColorFormat.YUV400,
                    [np.asarray(interleave_maps(
                        jnp.asarray(gpl[0::2]), jnp.asarray(gpl[1::2])
                    ))],
                )
                geo_gop = max(1, 1 if p.allIntra else p.videoGopSize)
            use_ms = p.multipleStreams and n_maps == 2 and not use_pi
            if p.attributeDimensionPartitions > 1 and (use_ms or use_pi):
                raise ValueError(
                    "attributeDimensionPartitions cannot combine with "
                    "multipleStreams or singleMapPixelInterleaving"
                )
            geo_payload_maps = None
            if use_ms:
                # one GVD sub-stream per map (multipleStreams); map 1 codes
                # a biased delta vs the RECONSTRUCTED map 0 when absoluteD1
                # is off (the D1-from-rec-D0 condition)
                from ..codec.mapstream import geo_bias, make_delta

                gpl = geo_video.planes[0]
                # per-map encoders: geometry0Config/geometry1Config attach
                # to the respective map sub-streams (PccAppEncoder names)
                geo_venc = self._venc("geometry0", lossless=p.losslessGeo)
                geo_venc1 = self._venc("geometry1", lossless=p.losslessGeo)

                def _geo_vep(delta: int) -> VideoEncoderParams:
                    if p.losslessGeo:
                        return VideoEncoderParams(lossless=True, qp=0)
                    gop_v = max(1, 1 if p.allIntra else p.videoGopSize)
                    return VideoEncoderParams(
                        qp=p.geometryQP + delta,
                        gop_size=gop_v,
                        motion=p.motionEstimation,
                        coeff_threshold=p.geometryCoeffThreshold,
                        # long P chains predicting from the planar-smoothed
                        # I recon give back the gain (A/B gop8 +6.1%) —
                        # intra ships for gop <= 4 (geometry -2..-15%)
                        intra=p.geometryIntraPrediction and gop_v <= 4,
                    )

                maxv = (1 << p.geometryNominal2dBitdepth) - 1
                d0_payload, d0_recon = geo_venc.encode(
                    Video(width, height, p.geometryNominal2dBitdepth,
                          ColorFormat.YUV400, [gpl[0::2].copy()]),
                    _geo_vep(p.deltaQPD0),
                )
                rec0 = np.asarray(d0_recon.planes[0]).astype(np.uint16)
                if p.absoluteD1:
                    d1_plane = gpl[1::2].copy()
                else:
                    d1_plane = make_delta(
                        gpl[1::2], rec0,
                        geo_bias(p.geometryNominal2dBitdepth), maxv,
                    )
                d1_payload, d1_recon = geo_venc1.encode(
                    Video(width, height, p.geometryNominal2dBitdepth,
                          ColorFormat.YUV400, [d1_plane]),
                    _geo_vep(p.deltaQPD1),
                )
                rec1 = np.asarray(d1_recon.planes[0]).astype(np.uint16)
                if not p.absoluteD1:
                    from ..codec.mapstream import combine_map1

                    rec1 = combine_map1(
                        rec1, rec0,
                        geo_bias(p.geometryNominal2dBitdepth), maxv,
                    )
                from ..codec.mapstream import interleave_maps_np

                geo_recon = Video(
                    width, height, p.geometryNominal2dBitdepth,
                    ColorFormat.YUV400, [interleave_maps_np(rec0, rec1)],
                )
                geo_payload = None
                geo_payload_maps = (d0_payload, d1_payload)
            elif p.losslessGeo:
                geo_payload, geo_recon = self._venc(
                    "geometry", lossless=True
                ).encode(geo_video, VideoEncoderParams(lossless=True, qp=0))
            else:
                # usePccRDO analog: occupancy-masked MC distortion — only
                # pixels that become points drive the motion choice
                geo_w = None
                if p.usePccRDO and p.motionEstimation and not use_pi:
                    # uint8 mask: it crosses the host-device link
                    geo_w = np.repeat(occ_decoded, n_maps, axis=0)
                geo_payload, geo_recon = self._venc("geometry").encode(
                    geo_video,
                    VideoEncoderParams(qp=p.geometryQP, gop_size=geo_gop,
                                       motion=p.motionEstimation,
                                       mc_weight=geo_w,
                                       coeff_threshold=
                                       p.geometryCoeffThreshold,
                                       intra=p.geometryIntraPrediction
                                       and geo_gop <= 4),
                )
            if use_pi:
                # closed loop continues in dual-map layout: de-interleave
                # the DECODED plane exactly as the decoder will
                from ..ops.interleave import deinterleave_maps

                m0, m1 = deinterleave_maps(
                    jnp.asarray(geo_recon.planes[0]),
                    occ=jnp.asarray(occ_decoded),
                    thickness=p.surfaceThickness,
                )
                rec = np.empty(
                    (2 * n_frames, height, width),
                    np.asarray(geo_recon.planes[0]).dtype,
                )
                rec[0::2] = np.asarray(m0)
                rec[1::2] = np.asarray(m1)
                geo_recon = Video(
                    width, height, p.geometryNominal2dBitdepth,
                    ColorFormat.YUV400, [rec],
                )

        # 5. reconstruct geometry from *decoded* planes (decoder-identical)
        with self.timer.stage("reconstructGeometry"):
            patch_lists = [[s.patch for s in segs] for segs in frame_segs]
            max_patches = max(
                1, -(-max(len(pl) for pl in patch_lists) // 32) * 32
            )
            table, counts = repro_ops.build_patch_table(patch_lists, max_patches)
            geo_rec_p0 = np.asarray(geo_recon.planes[0], np.int32)
            if p.pbfEnableFlag:
                # occupancy synthesis (PBF): erode dilated rims whose decoded
                # geometry is off-surface — EXACTLY as the decoder will (the
                # SEI emitted below carries the same passes/size/threshold)
                from ..ops.occupancy import pbf_refine

                b2p_blk = np.asarray(repro_ops.block_to_patch(
                    jnp.asarray(occ_decoded), jnp.asarray(table),
                    jnp.asarray(counts), p.occupancyResolution,
                    reverse=not p.patchPrecedenceOrder,
                ))
                owner_px = np.repeat(
                    np.repeat(b2p_blk, p.occupancyResolution, axis=1),
                    p.occupancyResolution, axis=2,
                )[:, :height, :width].astype(np.int32)
                pbf_passes, pbf_size, pbf_thr = self._pbf_knobs()
                occ_decoded = np.asarray(pbf_refine(
                    jnp.asarray(occ_decoded),
                    jnp.asarray(geo_rec_p0[::n_maps][:n_frames]),
                    jnp.asarray(owner_px),
                    jnp.float32(pbf_thr), passes=pbf_passes,
                    radius=max(1, pbf_size // 2),
                )).astype(np.uint8)
            occ_dev = jnp.asarray(occ_decoded)
            table_dev = jnp.asarray(table)
            counts_dev = jnp.asarray(counts)
            geo_rec_planes = geo_rec_p0
            pts_maps = []
            valid = None
            b2p0 = None
            for m in range(n_maps):
                pts_m, valid_m, b2p_m = repro_ops.reproject(
                    jnp.asarray(geo_rec_planes[m::n_maps]),
                    occ_dev, table_dev, counts_dev,
                    p.occupancyResolution,
                    reverse=not p.patchPrecedenceOrder,
                )
                pts_maps.append(np.asarray(pts_m))
                if valid is None:
                    valid = np.asarray(valid_m)
                    b2p0 = np.asarray(b2p_m)

        # 5b. EOM points (between-layer) from the occupancy bit planes,
        # enumerated against the DECODED D0 plane (decoder-identical)
        eom_points = [np.zeros((0, 3), np.int32) for _ in range(n_frames)]
        eom_colors: list[np.ndarray | None] = [None] * n_frames
        if p.enhancedOccupancyMapCode:
            from ..codec.eom import enumerate_frame_eom_points

            for i in range(n_frames):
                eom_plane = occ_planes[i] >> 1
                if not eom_plane.any():
                    continue
                owner_pix = np.repeat(
                    np.repeat(b2p0[i], p.occupancyResolution, 0),
                    p.occupancyResolution, 1,
                )[:height, :width]
                pts = enumerate_frame_eom_points(
                    patch_lists[i], eom_plane,
                    geo_rec_planes[i * n_maps], owner_pix,
                )
                eom_points[i] = pts
                src = sources[i]
                if len(pts) and src.has_colors and not p.noAttributes:
                    eom_colors[i] = transfer_colors(
                        src.positions.astype(np.float32), src.colors,
                        pts.astype(np.float32), k=p.recolorNeighborCount,
                    )

        # 5c. lossless completeness: any source point absent from the
        # closed-loop reconstruction (patch maps + EOM + raw) joins the raw
        # patch — the reference's maxAllowedDist2RawPointsSelection=0
        # post-reconstruction sweep (PCCPatchSegmenter.cpp missed-points
        # selection + PCCEncoder::generateRawPointsPatch)
        if p.losslessGeo and p.rawPointsPatch:

            def _keys(a: np.ndarray) -> np.ndarray:
                a = a.astype(np.int64)
                return (a[:, 0] << 42) | (a[:, 1] << 21) | a[:, 2]

            for i, src in enumerate(sources):
                have = [pts_maps[m][i][valid[i]] for m in range(n_maps)]
                have.append(eom_points[i])
                have.append(raw_points[i])
                have = [h for h in have if len(h)]
                have_k = (
                    np.unique(np.concatenate([_keys(h) for h in have]))
                    if have else np.zeros(0, np.int64)
                )
                src_pos = src.positions.astype(np.int32)
                miss = ~np.isin(_keys(src_pos), have_k)
                if not miss.any():
                    continue
                prev_n = len(raw_points[i])
                raw_points[i] = np.concatenate([raw_points[i], src_pos[miss]])
                if src.has_colors and not p.noAttributes:
                    prev_c = (
                        raw_colors[i]
                        if raw_colors[i] is not None
                        else np.zeros((prev_n, 3), np.uint8)
                    )
                    raw_colors[i] = np.concatenate([prev_c, src.colors[miss]])

        elif p.rawPointsPatch and not p.losslessGeo:
            # 5c'. LOSSY completeness sweep (round 5): packing precedence,
            # block-ownership cleanup and depth clipping can silently drop
            # pixels of points the segmentation claimed (measured: ~2% of
            # source points landing > 4 voxels from the reconstruction on
            # high-curvature deformation phases — a 17 dB D1 collapse,
            # results/endurance_drift_300f.csv).  Source points farther
            # than the detection radius from the closed-loop recon go to
            # the raw patch.  The radius scales with the geometry
            # quantiser so ordinary video quantisation noise never
            # triggers it (maxAllowedDist2RawPointsDetection role,
            # PCCPatchSegmenter.cpp:778 applied post-reconstruction).
            from ..ops.recolor import _knn_query
            from ..video.rbv import qstep_of

            # radius floor = surfaceThickness: points INSIDE the coded
            # thickness band are intentionally lossy-dropped (EOM/PLR
            # exist for them, and sweeping them to raw both inflates the
            # rate and erases those tools' gains); the sweep only catches
            # points lost OUTSIDE any coded surface
            thr2 = max(float(p.maxAllowedDist2RawPointsDetection),
                       float(p.surfaceThickness) ** 2,
                       (qstep_of(p.geometryQP) / 2.0) ** 2)
            for i, src in enumerate(sources):
                have = [pts_maps[m][i][valid[i]] for m in range(n_maps)]
                have.append(eom_points[i])
                have.append(raw_points[i])
                have = [np.asarray(h) for h in have if len(h)]
                src_pos = src.positions.astype(np.int32)
                if not have:
                    miss = np.ones(len(src_pos), bool)
                else:
                    d2, _ = _knn_query(
                        src_pos.astype(np.float64),
                        np.concatenate(have).astype(np.float64), 1,
                    )
                    miss = d2[:, 0] > thr2
                if not miss.any():
                    continue
                prev_n = len(raw_points[i])
                raw_points[i] = np.concatenate(
                    [raw_points[i], src_pos[miss]]
                )
                if src.has_colors and not p.noAttributes:
                    prev_c = (
                        raw_colors[i]
                        if raw_colors[i] is not None
                        else np.zeros((prev_n, 3), np.uint8)
                    )
                    raw_colors[i] = np.concatenate(
                        [prev_c, src.colors[miss]]
                    )

        if (p.lossyRawPointsPatch and p.rawPointsPatch
                and not p.losslessGeo):
            # lossy raw patches: prune isolated raw points — noise is not
            # worth lossy aux-video samples (minNormSumOfInvDist4MPSelection,
            # PCCEncoder.cpp:4271-4292)
            from ..codec.raw_points import prune_isolated_raw_points

            for i in range(n_frames):
                if len(raw_points[i]) == 0:
                    continue
                keep = prune_isolated_raw_points(
                    raw_points[i].astype(np.float32),
                    p.minNormSumOfInvDist4MPSelection,
                )
                raw_points[i] = raw_points[i][keep]
                if raw_colors[i] is not None:
                    raw_colors[i] = raw_colors[i][keep]

        if p.mortonOrderSortRawPoints and p.rawPointsPatch:
            from ..codec.raw_points import morton_order

            for i in range(n_frames):
                if len(raw_points[i]) > 1:
                    order = morton_order(raw_points[i])
                    raw_points[i] = raw_points[i][order]
                    if raw_colors[i] is not None:
                        raw_colors[i] = raw_colors[i][order]

        # 6. recolor reconstructed points from the source cloud (per map)
        attr_payload = None
        attr_recon = None
        attr_payload_maps = None
        attr_payload_parts = None  # partitions 1.. when dimension-partitioned
        attr_boundary = None  # lazy: only when flagColorPreSmoothing
        with self.timer.stage("generateAttributeVideo"):
          if not p.noAttributes:
            attr_rgb = np.zeros(
                (n_frames * n_maps, height, width, 3), np.uint8
            )
            for i, src in enumerate(sources):
                msk = valid[i]
                if not (src.has_colors and msk.any()):
                    continue
                recolor_k = p.numNeighborsColorTransferFwd or (
                    p.recolorNeighborCount
                )
                for m in range(n_maps):
                    if p.useFwdBwdColorTransfer:
                        colors = transfer_colors_fwd_bwd(
                            src.positions.astype(np.float32),
                            src.colors,
                            pts_maps[m][i][msk].astype(np.float32),
                            RecolorParams(
                                searchRange=p.bestColorSearchRange,
                                losslessAttribute=p.losslessAttribute,
                                numNeighborsFwd=recolor_k,
                                numNeighborsBwd=p.numNeighborsColorTransferBwd,
                                useDistWeightedAverageFwd=p.useDistWeightedAverageFwd,
                                useDistWeightedAverageBwd=p.useDistWeightedAverageBwd,
                                skipAvgIfIdenticalSourcePointPresentFwd=p.skipAvgIfIdenticalSourcePointPresentFwd,
                                skipAvgIfIdenticalSourcePointPresentBwd=p.skipAvgIfIdenticalSourcePointPresentBwd,
                                distOffsetFwd=p.distOffsetFwd,
                                distOffsetBwd=p.distOffsetBwd,
                                maxGeometryDist2Fwd=p.maxGeometryDist2Fwd,
                                maxGeometryDist2Bwd=p.maxGeometryDist2Bwd,
                                maxColorDist2Fwd=p.maxColorDist2Fwd,
                                maxColorDist2Bwd=p.maxColorDist2Bwd,
                                excludeColorOutlier=p.excludeColorOutlier,
                                thresholdColorOutlierDist=p.thresholdColorOutlierDist,
                            ),
                        )
                    else:
                        colors = transfer_colors(
                            src.positions.astype(np.float32),
                            src.colors,
                            pts_maps[m][i][msk].astype(np.float32),
                            k=recolor_k,
                        )
                    if p.flagColorPreSmoothing and len(colors):
                        # encoder-side pre-smoothing of the transferred
                        # colors on the reconstructed positions
                        # (presmoothPointCloudColor, PCCEncoder.cpp:6578):
                        # radius-KNN centroid, local-luma-entropy gated
                        from ..ops.smoothing import presmooth_colors

                        from ..codec.reconstruct import (
                            occupancy_near_boundary,
                        )

                        if attr_boundary is None:
                            attr_boundary = occupancy_near_boundary(
                                occ_decoded[:, :height, :width]
                            )
                        colors, _ = presmooth_colors(
                            pts_maps[m][i][msk], colors,
                            # only the TYPE-2 near-boundary ring presmooths
                            # (presmoothPointCloudColor processes
                            # boundaryPointType==2, PCCEncoder.cpp:6590)
                            eligible=attr_boundary[i][msk],
                            radius2=p.radius2ColorPreSmoothing,
                            max_neighbors=p.neighborCountColorPreSmoothing,
                            threshold=p.thresholdColorPreSmoothing,
                            entropy_threshold=(
                                p.thresholdColorPreSmoothingLocalEntropy
                            ),
                        )
                    canvas = attr_rgb[i * n_maps + m].reshape(-1, 3)
                    canvas[np.nonzero(msk)[0]] = colors
            # fill unoccupied, convert to YUV420, encode; the "trusted color"
            # mask is the per-pixel valid set (decoded-occupancy ∧ patch-owned)
            if p.losslessAttribute:
                # no background fill: occupied pixels survive exactly and
                # all-zero background deflates to nothing
                filled_rgb = attr_rgb.astype(np.float32)
            else:
                valid_mask = np.repeat(
                    valid.reshape(n_frames, height, width).astype(np.uint8),
                    n_maps, axis=0,
                )
                from ..ops.dilate import background_fill

                filled_rgb = background_fill(
                    attr_rgb.astype(np.float32).transpose(3, 0, 1, 2).reshape(
                        -1, height, width
                    ),
                    np.tile(valid_mask, (3, 1, 1)),
                    p.attributeBGFill,
                )
                filled_rgb = (
                    filled_rgb.reshape(3, n_frames * n_maps, height, width)
                    .transpose(1, 2, 3, 0)
                )
                if (p.groupDilation and p.absoluteT1 and n_maps == 2
                        and not p.multipleStreams
                        and not p.singleMapPixelInterleaving):
                    from ..ops.dilate import group_dilation

                    filled_rgb = group_dilation(
                        filled_rgb,
                        valid.reshape(n_frames, height, width),
                        n_maps,
                    )
            rgb_u8 = jnp.asarray(
                np.clip(np.round(filled_rgb), 0, 255).astype(np.uint8)
            )
            if p.attributeVideo444:
                # RGB444: one full-res plane per component, no color
                # transform (reference colorTransform=0 + attributeVideo444)
                arr = np.asarray(rgb_u8)
                attr_video = Video(
                    width, height, 8, ColorFormat.RGB444,
                    [arr[..., 0], arr[..., 1], arr[..., 2]],
                )
            elif p.patchColorSubsampling:
                # per-patch chroma subsampling (PCCVideoEncoder.cpp:70-130):
                # keep 444->420 filter taps inside the owning patch
                from ..ops.color import rgb8_to_yuv420_patch_aware

                pid = np.repeat(
                    _patch_id_map(frame_segs, width, height,
                                  p.occupancyResolution),
                    n_maps, axis=0,
                )
                y, u, v = rgb8_to_yuv420_patch_aware(
                    rgb_u8, jnp.asarray(pid), p.chromaDownsampleFilter
                )
                attr_video = Video(
                    width, height, 8, ColorFormat.YUV420,
                    [np.asarray(y), np.asarray(u), np.asarray(v)],
                )
            elif p.colorSpaceConversionPath and p.colorSpaceConversionConfig:
                # external HDRConvert RGB444->YUV420 (colorSpaceConversion*
                # options; PCCVirtualColorConverter HDRTOOLS path)
                from ..video.hdrtools import ExternalColorConverter

                arr = np.asarray(rgb_u8)
                attr_video = ExternalColorConverter(
                    p.colorSpaceConversionPath, p.colorSpaceConversionConfig
                ).convert(Video(
                    width, height, 8, ColorFormat.RGB444,
                    [arr[..., 0], arr[..., 1], arr[..., 2]],
                ))
            else:
                y, u, v = rgb8_to_yuv420(rgb_u8, p.chromaDownsampleFilter)
                attr_video = Video(
                    width, height, 8, ColorFormat.YUV420,
                    [np.asarray(y), np.asarray(u), np.asarray(v)],
                )
            attr_gop = max(1, n_maps * (1 if p.allIntra else p.videoGopSize))
            if use_pi:
                from ..ops.interleave import interleave_maps

                attr_video = Video(
                    width, height, 8, ColorFormat.YUV420,
                    [
                        np.asarray(interleave_maps(
                            jnp.asarray(pl[0::2]), jnp.asarray(pl[1::2])
                        ))
                        for pl in attr_video.planes
                    ],
                )
                attr_gop = max(1, 1 if p.allIntra else p.videoGopSize)
            if use_ms:
                # one AVD sub-stream per map; map 1 codes a biased delta vs
                # the reconstructed map 0 when absoluteT1 is off (the
                # T1-from-rec-T0 condition)
                from ..codec.mapstream import (
                    attr_bias,
                    combine_map1,
                    interleave_maps_np,
                    make_delta,
                )

                attr_venc = self._venc(
                    "attribute0", lossless=p.losslessAttribute
                )
                attr_venc1 = self._venc(
                    "attribute1", lossless=p.losslessAttribute
                )

                def _attr_vep(delta: int) -> VideoEncoderParams:
                    if p.losslessAttribute:
                        return VideoEncoderParams(lossless=True, qp=0)
                    gop_v = max(1, 1 if p.allIntra else p.videoGopSize)
                    return VideoEncoderParams(
                        qp=p.attributeQP + delta,
                        gop_size=gop_v,
                        motion=p.motionEstimation,
                        intra=p.attributeIntraPrediction and gop_v <= 4,
                    )

                t0_planes = [pl[0::2].copy() for pl in attr_video.planes]
                t0_payload, t0_recon = attr_venc.encode(
                    Video(width, height, 8, attr_video.format, t0_planes),
                    _attr_vep(p.deltaQPT0),
                )
                rec0p = [np.asarray(pl) for pl in t0_recon.planes]
                if p.absoluteT1:
                    t1_planes = [pl[1::2].copy() for pl in attr_video.planes]
                else:
                    t1_planes = [
                        make_delta(pl[1::2], r0, attr_bias(8), 255)
                        for pl, r0 in zip(attr_video.planes, rec0p)
                    ]
                t1_payload, t1_recon = attr_venc1.encode(
                    Video(width, height, 8, attr_video.format, t1_planes),
                    _attr_vep(p.deltaQPT1),
                )
                rec1p = [np.asarray(pl) for pl in t1_recon.planes]
                if not p.absoluteT1:
                    rec1p = [
                        combine_map1(r1, r0, attr_bias(8), 255)
                        for r1, r0 in zip(rec1p, rec0p)
                    ]
                attr_recon = Video(
                    width, height, 8, attr_video.format,
                    [interleave_maps_np(r0, r1)
                     for r0, r1 in zip(rec0p, rec1p)],
                )
                attr_payload_maps = (t0_payload, t1_payload)
            elif p.attributeDimensionPartitions > 1:
                # dimension-partitioned AVD: one single-channel RBV
                # sub-stream per color plane (23090-5 partitions; the
                # reference decodes per-partition videos routed by
                # vuh_attribute_partition_index, PCCDecoder.cpp:208-300).
                # Chroma partitions ride at their native (subsampled)
                # resolution — no cross-channel packing needed.
                if p.attributeDimensionPartitions != 3:
                    raise ValueError(
                        "attributeDimensionPartitions supports 1 (single "
                        "stream) or 3 (one partition per channel)"
                    )
                if use_pi:
                    raise ValueError(
                        "attribute dimension partitions cannot combine with "
                        "pixel interleaving"
                    )
                if p.attributeVideo444:
                    raise ValueError(
                        "attribute dimension partitions require YUV420 "
                        "attribute video (attributeVideo444 off)"
                    )
                part_venc = self._venc(
                    "attribute", lossless=p.losslessAttribute
                )
                part_vep = (
                    VideoEncoderParams(lossless=True, qp=0)
                    if p.losslessAttribute
                    else VideoEncoderParams(
                        qp=p.attributeQP, gop_size=attr_gop,
                        motion=p.motionEstimation,
                        intra=p.attributeIntraPrediction and attr_gop <= 4,
                    )
                )
                part_payloads = []
                part_recons = []
                for pl in attr_video.planes:
                    pv = Video(
                        pl.shape[2], pl.shape[1], 8, ColorFormat.YUV400,
                        [pl],
                    )
                    pay, rec = part_venc.encode(pv, part_vep)
                    part_payloads.append(pay)
                    part_recons.append(np.asarray(rec.planes[0]))
                attr_payload = part_payloads[0]
                attr_payload_parts = part_payloads[1:]
                attr_recon = Video(
                    width, height, 8, attr_video.format, part_recons
                )
            elif p.losslessAttribute:
                attr_payload, attr_recon = self._venc(
                    "attribute", lossless=True
                ).encode(attr_video, VideoEncoderParams(lossless=True, qp=0))
            else:
                # usePccRDO: luma-plane MC distortion masks to the valid
                # (decoded-occupancy ∧ patch-owned) pixels; chroma planes
                # skip automatically (shape mismatch at half resolution)
                attr_w = None
                if (p.usePccRDO and p.motionEstimation
                        and not p.singleMapPixelInterleaving):
                    attr_w = np.repeat(
                        valid.reshape(n_frames, height, width)
                        .astype(np.uint8),
                        n_maps, axis=0,
                    )
                attr_payload, attr_recon = self._venc("attribute").encode(
                    attr_video,
                    VideoEncoderParams(qp=p.attributeQP, gop_size=attr_gop,
                                       motion=p.motionEstimation,
                                       mc_weight=attr_w,
                                       intra=p.attributeIntraPrediction
                                       and attr_gop <= 4),
                )
            if use_pi:
                from ..ops.interleave import deinterleave_maps

                rec_planes = []
                for pl in attr_recon.planes:
                    # luma gates on occupancy; half-res chroma stays plain
                    m0, m1 = deinterleave_maps(
                        jnp.asarray(pl),
                        occ=(
                            jnp.asarray(occ_decoded)
                            if pl.shape[1:] == occ_decoded.shape[1:]
                            else None
                        ),
                    )
                    rec = np.empty(
                        (2 * n_frames,) + pl.shape[1:], np.asarray(pl).dtype
                    )
                    rec[0::2] = np.asarray(m0)
                    rec[1::2] = np.asarray(m1)
                    rec_planes.append(rec)
                attr_recon = Video(
                    width, height, 8, ColorFormat.YUV420, rec_planes,
                )

        # 6b. reflectance attribute (second attribute sub-stream, lossless)
        refl_payload = None
        refl_recon_planes = None
        has_refl = all(s2.has_reflectances for s2 in sources)
        if has_refl:
            from scipy.spatial import cKDTree

            refl_planes = np.zeros(
                (n_frames * n_maps, height, width), np.uint16
            )
            for i, src in enumerate(sources):
                msk = valid[i]
                if not msk.any():
                    continue
                tree = cKDTree(src.positions.astype(np.float32))
                for m in range(n_maps):
                    _, idx = tree.query(
                        pts_maps[m][i][msk].astype(np.float32), k=1
                    )
                    plane = refl_planes[i * n_maps + m].reshape(-1)
                    plane[np.nonzero(msk)[0]] = src.reflectances[idx]
            refl_video = Video(
                width, height, 16, ColorFormat.YUV400, [refl_planes]
            )
            # reflectance is a semantic attribute: always RBV-lossless even
            # when the main attribute rides an external codec (whose cfg
            # would need SCC-lossless we cannot validate binary-less here);
            # the decoder dispatches per payload, so mixing is safe
            refl_payload, refl_recon = VideoEncoder.create(
                CodecId.RBV_LOSSLESS
            ).encode(refl_video, VideoEncoderParams(lossless=True, qp=0))
            refl_recon_planes = np.asarray(refl_recon.planes[0])

        # 6c. raw-points + EOM aux videos — BEFORE reconstruction so the
        # closed loop consumes DECODED raw coords/colors when they are coded
        # lossy (lossyRawPointsPatch at the aux QPs; lossless otherwise)
        raw_geo_payload = raw_attr_payload = None
        raw_points_rec = raw_points
        raw_colors_rec = raw_colors
        eom_colors_rec = eom_colors
        use_lossy_raw = (
            p.lossyRawPointsPatch and not p.losslessGeo
            and not p.losslessAttribute
        )
        if (p.rawPointsPatch and any(len(r) for r in raw_points)) or any(
            len(e) for e in eom_points
        ):
            from ..codec.raw_points import build_raw_videos

            raw_geo_video, raw_attr_video = build_raw_videos(
                # raw points carry ABSOLUTE 3D coords: the aux video bitdepth
                # is the 3D coordinate depth, not the nominal 2D depth
                # (vox11 content codes depth at 8 bits but coords at 11)
                raw_points, raw_colors,
                max(p.geometryNominal2dBitdepth,
                    p.geometry3dCoordinatesBitdepth),
                extra_colors=eom_colors,
                width=max(16, p.attributeRawSeparateVideoWidth),
            )
            if use_lossy_raw:
                raw_geo_payload, rg_rec = self._venc("geometryMP").encode(
                    raw_geo_video, VideoEncoderParams(
                        qp=p.auxGeometryQP, all_intra=True,
                    ))
            else:
                raw_geo_payload, rg_rec = self._venc(
                    "geometryMP", lossless=True
                ).encode(raw_geo_video, VideoEncoderParams(lossless=True, qp=0))
            ra_rec = None
            if not p.noAttributes:
                if use_lossy_raw:
                    raw_attr_payload, ra_rec = self._venc(
                        "attributeMP"
                    ).encode(raw_attr_video, VideoEncoderParams(
                        qp=p.auxAttributeQP, all_intra=True,
                    ))
                else:
                    raw_attr_payload, ra_rec = self._venc(
                        "attributeMP", lossless=True
                    ).encode(raw_attr_video,
                             VideoEncoderParams(lossless=True, qp=0))
            if use_lossy_raw:
                # closed loop: reconstruct EXACTLY what the decoder recovers
                cmax = (1 << p.geometry3dCoordinatesBitdepth) - 1
                gp = np.asarray(rg_rec.planes[0])
                ap = (
                    None if ra_rec is None
                    else np.stack(
                        [np.asarray(pl) for pl in ra_rec.planes], axis=-1
                    )
                )
                raw_points_rec = list(raw_points)
                raw_colors_rec = list(raw_colors)
                eom_colors_rec = list(eom_colors)
                for i in range(n_frames):
                    n_raw = len(raw_points[i])
                    if n_raw:
                        raw_points_rec[i] = np.clip(
                            gp[i].reshape(-1)[: 3 * n_raw]
                            .reshape(n_raw, 3).astype(np.int32),
                            0, cmax,
                        )
                        if ap is not None and raw_colors[i] is not None:
                            raw_colors_rec[i] = (
                                ap[i].reshape(-1, 3)[:n_raw].astype(np.uint8)
                            )
                    if ap is not None and eom_colors[i] is not None:
                        ne = len(eom_colors[i])
                        eom_colors_rec[i] = ap[i].reshape(-1, 3)[
                            n_raw : n_raw + ne
                        ].astype(np.uint8)

        # smoothing SEIs (decoder applies them; the closed loop below must too)
        smoothing_sei = None
        if p.flagGeometrySmoothing and p.gridSmoothing:
            from ..bitstream.sei import SeiGeometrySmoothing

            smoothing_sei = SeiGeometrySmoothing(
                gs_smoothing_method_type=1,
                gs_smoothing_grid_size_minus2=p.gridSize - 2,
                gs_smoothing_threshold=int(p.thresholdSmoothing),
            )
        color_sei = None
        if p.flagColorSmoothing:
            from ..bitstream.sei import SeiAttributeSmoothing

            color_sei = SeiAttributeSmoothing(
                as_smoothing_grid_size_minus2=p.cgridSize - 2,
                as_smoothing_threshold=int(p.thresholdColorSmoothing),
                as_smoothing_threshold_variation=int(
                    p.thresholdColorVariation
                ),
                as_smoothing_threshold_difference=int(
                    p.thresholdColorDifference
                ),
            )

        # 7. decoder-identical reconstructed clouds (colors from decoded attr)
        with self.timer.stage("reconstructClouds"):
            if attr_recon is None:
                rgb_rec = None
            elif attr_recon.format == ColorFormat.RGB444:
                rgb_rec = np.stack(
                    [np.asarray(pl) for pl in attr_recon.planes], axis=-1
                )
            elif (
                p.colorSpaceConversionPath
                and p.inverseColorSpaceConversionConfig
            ):
                # closed loop mirrors the decoder's HDRConvert inverse
                from ..video.hdrtools import ExternalColorConverter

                conv = ExternalColorConverter(
                    p.colorSpaceConversionPath,
                    p.inverseColorSpaceConversionConfig,
                ).convert(attr_recon)
                rgb_rec = np.stack(
                    [np.asarray(pl) for pl in conv.planes], axis=-1
                )
            else:
                rgb_rec = np.asarray(
                    yuv420_to_rgb8(
                        jnp.asarray(attr_recon.planes[0]),
                        jnp.asarray(attr_recon.planes[1]),
                        jnp.asarray(attr_recon.planes[2]),
                    )
                )
            # PLR layer synthesis: the exact function the decoder runs, on
            # the identical decoded plane (byte-identical closed loop)
            plr_layers = []
            if use_plr and any(
                s2.patch.plr_mode for segs in frame_segs for s2 in segs
            ):
                from ..codec.reconstruct import (
                    PLR_MODE_TABLE,
                    synthesize_plr_layers,
                )

                plr_layers = synthesize_plr_layers(
                    [[s2.patch for s2 in segs] for segs in frame_segs],
                    np.asarray(
                        geo_rec_planes[::n_maps][:n_frames]
                    ).astype(np.int32)[:, :height, :width],
                    valid, b2p0, occ_dev, table_dev, counts_dev,
                    p.occupancyResolution,
                    PLR_MODE_TABLE[:max(2, min(p.nbPlrmMode, 10))],
                    reverse=not p.patchPrecedenceOrder,
                )

            from ..codec.reconstruct import occupancy_boundary

            boundary = occupancy_boundary(occ_decoded[:, :height, :width])
            # per-point patch index (the reference's partition vector;
            # decoder side: ReconstructionEngine computes the identical
            # ownership from its own b2p) — feeds the gated color smoothing
            owner_pt = (
                np.repeat(
                    np.repeat(b2p0, p.occupancyResolution, axis=1),
                    p.occupancyResolution, axis=2,
                )[:, :height, :width]
                .reshape(n_frames, height * width).astype(np.int32) - 1
            )
            recon_clouds = []
            for i in range(n_frames):
                msk = valid[i]
                pos_list = [pts_maps[m][i][msk] for m in range(n_maps)]
                typ_list = [boundary[i][msk].astype(np.uint8)] * n_maps
                part_list = [owner_pt[i][msk]] * n_maps
                for plr_pts_k, plr_mask_k in plr_layers:
                    if not plr_mask_k[i].any():
                        continue
                    pos_list.append(plr_pts_k[i][plr_mask_k[i]])
                    typ_list.append(
                        boundary[i][plr_mask_k[i]].astype(np.uint8)
                    )
                    part_list.append(owner_pt[i][plr_mask_k[i]])
                typ_list.append(np.zeros(
                    len(raw_points_rec[i]) + len(eom_points[i]), np.uint8
                ))
                # raw/EOM points belong to no projected patch
                part_list.append(np.full(
                    len(raw_points_rec[i]) + len(eom_points[i]), -1, np.int32
                ))
                pos = np.concatenate(
                    pos_list + [raw_points_rec[i], eom_points[i]],
                    axis=0,
                )
                if rgb_rec is None:
                    col = None
                else:
                    col_parts = [
                        rgb_rec[i * n_maps + m].reshape(-1, 3)[msk]
                        for m in range(n_maps)
                    ]
                    for _, plr_mask_k in plr_layers:
                        if plr_mask_k[i].any():
                            col_parts.append(
                                rgb_rec[i * n_maps].reshape(-1, 3)[
                                    plr_mask_k[i]
                                ]
                            )
                    col_parts.append(
                        raw_colors_rec[i]
                        if raw_colors_rec[i] is not None
                        else np.zeros((len(raw_points_rec[i]), 3), np.uint8)
                    )
                    col_parts.append(
                        eom_colors_rec[i]
                        if eom_colors_rec[i] is not None
                        else np.zeros((len(eom_points[i]), 3), np.uint8)
                    )
                    col = np.concatenate(col_parts, axis=0)
                refl = None
                if refl_recon_planes is not None:
                    refl_parts = [
                        refl_recon_planes[i * n_maps + m].reshape(-1)[msk]
                        for m in range(n_maps)
                    ]
                    for _, plr_mask_k in plr_layers:
                        if plr_mask_k[i].any():
                            refl_parts.append(
                                refl_recon_planes[i * n_maps].reshape(-1)[
                                    plr_mask_k[i]
                                ]
                            )
                    refl_parts.append(
                        np.zeros(
                            len(raw_points_rec[i]) + len(eom_points[i]), np.uint16
                        )
                    )
                    refl = np.concatenate(refl_parts)
                ps = PointSet(positions=pos, colors=col, reflectances=refl,
                              types=np.concatenate(typ_list),
                              partition=np.concatenate(part_list))
                if p.removeDuplicatePoints:
                    ps = ps.remove_duplicates()
                recon_clouds.append(ps)
            if smoothing_sei is not None or (
                p.flagGeometrySmoothing and not p.gridSmoothing
            ):
                from ..codec.postprocess import (
                    KnnSmoothingParams,
                    apply_geometry_smoothing,
                )

                recon_clouds = apply_geometry_smoothing(
                    recon_clouds, smoothing_sei,
                    coord_bits=p.geometry3dCoordinatesBitdepth,
                    # gridSmoothing=0: the reference runs full-KNN smoothing
                    # in the encoder closed loop and writes NO SEI (only the
                    # grid method is signalled, PCCEncoder.cpp:8456); the
                    # decoder consequently does not smooth — an intentional
                    # reference asymmetry this path reproduces
                    knn=KnnSmoothingParams(
                        flag=p.flagGeometrySmoothing,
                        grid=p.gridSmoothing,
                        neighbor_count=p.neighborCountSmoothing,
                        radius2=p.radius2Smoothing,
                        radius2_boundary=p.radius2BoundaryDetection,
                        threshold=p.thresholdSmoothing,
                    ),
                    # post-smoothing attribute re-transfer: active only
                    # under Rec1 (the reference squashes it under Rec0/Rec2,
                    # PCCEncoderParameters.cpp:740-796); the decoder derives
                    # the same setting from the stream's PTL
                    attr_transfer_filter_type=(
                        p.attributeTransferFilterType
                        if p.profileReconstructionIdc == 1 else 0
                    ),
                )
            if color_sei is not None:
                from ..codec.postprocess import apply_color_smoothing

                recon_clouds = apply_color_smoothing(
                    recon_clouds, color_sei,
                    coord_bits=p.geometry3dCoordinatesBitdepth,
                )

        # 9. high-level syntax
        with self.timer.stage("createPatchFrameDataStructure"):
            context = self._build_context(
                frame_segs, width, height,
                occ_payload, geo_payload, attr_payload,
                raw_points, raw_geo_payload, raw_attr_payload,
                tile_band=tile_band, eom_points=eom_points,
                refl_payload=refl_payload, use_pi=use_pi,
                geo_payload_maps=geo_payload_maps,
                attr_payload_maps=attr_payload_maps,
                attr_payload_parts=attr_payload_parts,
            )
            if p.pbfEnableFlag:
                from ..bitstream.sei import SeiOccupancySynthesis

                # the SEI carries the same knobs the closed loop above used
                # (decoder rederives passes/size/threshold from these)
                pbf_passes, pbf_size, pbf_thr = self._pbf_knobs()
                context.atlas(0).seis_prefix.append(SeiOccupancySynthesis(
                    os_pbf_log2_threshold_minus1=int(pbf_thr).bit_length() - 2,
                    os_pbf_passes_count_minus1=pbf_passes - 1,
                    os_pbf_filter_size_minus1=pbf_size - 1,
                ))
            if smoothing_sei is not None:
                context.atlas(0).seis_prefix.append(smoothing_sei)
            if color_sei is not None:
                context.atlas(0).seis_prefix.append(color_sei)
        return context, recon_clouds

    # ------------------------------------------------------------------
    def _build_context(
        self, frame_segs, width, height, occ_payload, geo_payload, attr_payload,
        raw_points=None, raw_geo_payload=None, raw_attr_payload=None,
        tile_band=None, eom_points=None, refl_payload=None, use_pi=False,
        geo_payload_maps=None, attr_payload_maps=None,
        attr_payload_parts=None,
    ) -> Context:
        from ..video import codec_group as cg
        from ..video.base import component_codec_id

        p = self.params
        # coded-size / min-d quantizer units (must match encode()'s padding)
        qpx = 1 << max(0, p.log2QuantizerSizeX)
        qpy = 1 << max(0, p.log2QuantizerSizeY)
        d_shift = max(0, max(1, p.depthQuantizationStep).bit_length() - 1)
        context = Context()
        vps = V3CParameterSet()
        ptl = vps.profile_tier_level
        ptl.ptl_tier_flag = p.tierFlag
        # codec-group signalling (PCCBitstreamCommon.h:169-173): derived
        # from the per-component codec selection unless the user pinned a
        # group explicitly.  All-RBV streams are CODEC_GROUP_MP4RA with an
        # 'rbv1' Component Codec Mapping SEI entry; external codecs signal
        # their family's group (getCodedCodecId inverse).
        from ..utils.enums import CodecId

        sig = cg.signalling(
            component_codec_id(p, "Occupancy"),
            component_codec_id(p, "Geometry"),
            component_codec_id(p, "Attribute"),
            pinned_group=p.profileCodecGroupIdc or None,
            codec_id_index={
                CodecId.JM_APP: p.avcCodecIdIndex,
                CodecId.HM_APP: p.hevcCodecIdIndex,
                CodecId.FFMPEG_APP: p.hevcCodecIdIndex,
                CodecId.SHM_APP: p.shvcCodecIdIndex,
                CodecId.VTM_APP: p.vvcCodecIdIndex,
            },
        )
        ptl.ptl_profile_codec_group_idc = (
            p.profileCodecGroupIdc if p.profileCodecGroupIdc
            else sig.profile_codec_group_idc
        )
        ptl.ptl_profile_toolset_idc = p.profileToolsetIdc
        ptl.ptl_profile_reconstruction_idc = p.profileReconstructionIdc
        ptl.ptl_level_idc = p.levelIdc
        if p.oneV3CFrameOnlyFlag:
            from ..bitstream.syntax import (
                ProfileToolsetConstraintsInformation,
            )

            ptl.ptl_tool_constraints_present_flag = True
            ptl.ptl_toolset_constraints = (
                ProfileToolsetConstraintsInformation(
                    ptc_one_v3c_frame_only_flag=True,
                )
            )
        va = vps.atlas(0)
        va.vps_frame_width = width
        va.vps_frame_height = height
        va.vps_map_count_minus1 = p.mapCountMinus1
        va.vps_map_absolute_coding_enabled_flag = [True] * (p.mapCountMinus1 + 1)
        va.vps_map_predictor_index_diff = [0] * (p.mapCountMinus1 + 1)
        if geo_payload_maps is not None or attr_payload_maps is not None:
            va.vps_multiple_map_streams_present_flag = True
            if p.mapCountMinus1 >= 1:
                # absoluteD1/absoluteT1 ride the map-1 absolute-coding flag
                va.vps_map_absolute_coding_enabled_flag[1] = p.absoluteD1
        va.occupancy_information.oi_occupancy_2d_bitdepth_minus1 = 7
        va.occupancy_information.oi_occupancy_codec_id = (
            sig.component_ids["occupancy"]
        )
        if p.lossyOccupancyMap and not p.enhancedOccupancyMapCode:
            # must match the closed loop's binarisation threshold above
            # (thresholdLossyOM, or half the coded offset when unset)
            fill = p.offsetLossyOM if p.offsetLossyOM > 0 else 255
            va.occupancy_information.oi_lossy_occupancy_compression_threshold = (
                p.thresholdLossyOM if p.thresholdLossyOM > 0 else fill // 2
            )
        va.geometry_information.gi_geometry_codec_id = (
            sig.component_ids["geometry"]
        )
        va.geometry_information.gi_auxiliary_geometry_codec_id = (
            sig.component_ids["geometry"]
        )
        va.geometry_information.gi_geometry_2d_bitdepth_minus1 = (
            p.geometryNominal2dBitdepth - 1
        )
        va.geometry_information.gi_geometry_3d_coordinates_bitdepth_minus1 = (
            p.geometry3dCoordinatesBitdepth - 1
        )
        if attr_payload is None and attr_payload_maps is None:
            # geometry-only stream (reference: noAttributes)
            va.attribute_information = AttributeInformation(
                ai_attribute_count=0,
                ai_attribute_type_id=[],
                ai_attribute_codec_id=[],
                ai_attribute_dimension_minus1=[],
                ai_attribute_2d_bitdepth_minus1=[],
                ai_attribute_msb_align_flag=[],
            )
        else:
            n_parts = 1 + (
                len(attr_payload_parts) if attr_payload_parts else 0
            )
            va.attribute_information = AttributeInformation(
                ai_attribute_count=1,
                ai_attribute_type_id=[0],
                ai_attribute_codec_id=[sig.component_ids["attribute"]],
                ai_attribute_dimension_minus1=[2],
                # one single-channel partition per coded sub-stream when
                # dimension-partitioned (channel counts are fully inferred
                # by the spec rule: zero extra bits on the wire)
                ai_attribute_dimension_partitions_minus1=[n_parts - 1],
                ai_attribute_partition_channels_minus1=[
                    [0] * n_parts if n_parts > 1 else [2]
                ],
                ai_attribute_2d_bitdepth_minus1=[7],
                ai_attribute_msb_align_flag=[False],
            )
        context.vps_list.append(vps)

        atlas = context.atlas(0)
        # reflectance is ALWAYS RBV-lossless (a semantic attribute): under
        # an external codec group its AI entry must map to rbv1 through the
        # CCM SEI, not inherit the group codec's id 0
        refl_cid = 0
        if refl_payload is not None:
            refl_cid = next(
                (c for c, f in sig.ccm_entries if f == cg.RBV_4CC), None
            )
            if refl_cid is None:
                # a fresh id: distinct from every group-component id AND
                # every CCM-mapped id, or the mapping would relabel them
                used = set(sig.component_ids.values()) | {
                    c for c, _ in sig.ccm_entries
                }
                refl_cid = max(used, default=-1) + 1
                sig.ccm_entries.append((refl_cid, cg.RBV_4CC))
        if sig.ccm_entries:
            from ..bitstream.sei import SeiComponentCodecMapping

            atlas.seis_prefix.append(SeiComponentCodecMapping(
                ccm_codec_mappings_count_minus1=len(sig.ccm_entries) - 1,
                ccm_codec_id=[e[0] for e in sig.ccm_entries],
                ccm_codec_4cc=[e[1] for e in sig.ccm_entries],
            ))
        # rotated-space coordinates span one extra bit when 45-degree
        # projections are active
        geom3d_bits = p.geometry3dCoordinatesBitdepth + (
            1 if p.additionalProjectionPlaneMode > 0 else 0
        )
        asps = AtlasSequenceParameterSetRbsp(
            asps_frame_width=width,
            asps_frame_height=height,
            # the packing block size IS occupancyResolution (the reference
            # couples them the same way); default 16 -> log2 4
            asps_log2_patch_packing_block_size=max(
                0, p.occupancyResolution.bit_length() - 1
            ),
            asps_geometry_3d_bitdepth_minus1=geom3d_bits - 1,
            asps_extended_projection_enabled_flag=(
                p.additionalProjectionPlaneMode > 0
            ),
            asps_max_number_projections_minus1=(
                {0: 5, 1: 9, 2: 13, 3: 17, 4: 17, 5: 17}[
                    p.additionalProjectionPlaneMode
                ]
            ),
            asps_geometry_2d_bitdepth_minus1=p.geometryNominal2dBitdepth - 1,
            asps_patch_size_quantizer_present_flag=True,
            # minLevel>1 also quantizes the coded depth range (quantDD):
            # ath_pos_delta_max_d_quantizer rides the same shift
            asps_normal_axis_max_delta_value_enabled_flag=d_shift > 0,
            asps_use_eight_orientations_flag=p.useEightOrientations,
            asps_patch_precedence_order_flag=p.patchPrecedenceOrder,
            asps_map_count_minus1=p.mapCountMinus1,
            asps_pixel_deinterleaving_flag=use_pi,
            # the decoder's PI deinterleave clamp derives thickness from
            # this field — it must carry the encoder's actual setting
            asps_vpcc_surface_thickness_minus1=max(
                0, p.surfaceThickness - 1
            ),
            asps_raw_patch_enabled_flag=raw_geo_payload is not None,
            asps_eom_patch_enabled_flag=p.enhancedOccupancyMapCode,
            asps_eom_fix_bit_count_minus1=max(1, min(p.EOMFixBitCount, 7)) - 1,
            asps_plr_enabled_flag=(
                p.pointLocalReconstruction and p.mapCountMinus1 == 0
            ),
            # plri descriptors: coded modes 1..N-1 from the canonical table
            # (setPointLocalReconstruction, PCCEncoder.cpp:7829-7846)
            asps_plr_number_of_modes_minus1=(
                max(2, min(p.nbPlrmMode, 10)) - 1
            ),
            plri_interpolate_flag=[
                m[0] for m in _plr_coded_modes(p.nbPlrmMode)
            ],
            plri_filling_flag=[
                m[1] for m in _plr_coded_modes(p.nbPlrmMode)
            ],
            plri_minimum_depth=[
                m[2] for m in _plr_coded_modes(p.nbPlrmMode)
            ],
            plri_neighbour_minus1=[
                m[3] - 1 for m in _plr_coded_modes(p.nbPlrmMode)
            ],
            plri_block_threshold_per_patch_minus1=max(
                0, min(p.patchSize - 1, 63)
            ),
            asps_auxiliary_video_enabled_flag=raw_geo_payload is not None,
            # constructAspsRefListStruct parity (PCCEncoderParameters.cpp:
            # 1227-1246): maxNumRefAtalsList lists of maxNumRefAtlasFrame
            # short-term entries at afoc deltas 1..N (sign flag true =
            # reference frame precedes, matching the reference's
            # afocDiff>0 encoding)
            ref_list_structs=[
                RefListStruct(
                    num_ref_entries=max(1, p.maxNumRefAtlasFrame),
                    abs_delta_afoc_st=[
                        1 + i for i in range(max(1, p.maxNumRefAtlasFrame))
                    ],
                    straf_entry_sign_flag=[True]
                    * max(1, p.maxNumRefAtlasFrame),
                )
                for _ in range(max(1, p.maxNumRefAtalsList))
            ],
        )
        atlas.asps_list.append(asps)
        afps = AtlasFrameParameterSetRbsp(
            afps_lod_mode_enabled_flag=(
                p.levelOfDetailX > 1 or p.levelOfDetailY > 1
            ),
        )
        n_tiles = max(1, p.tileCount)
        if n_tiles > 1:
            afti = afps.atlas_frame_tile_information
            afti.afti_single_tile_in_atlas_frame_flag = False
            afti.afti_single_partition_per_tile_flag = True
            # the read side DERIVES tile count from the partition grid in
            # single-partition-per-tile mode; the writer's ath_id bit width
            # (ath_id_bits) must see the same count
            afti.afti_num_tiles_in_atlas_frame_minus1 = n_tiles - 1
            band64 = (tile_band or height) // 64
            if not p.uniformPartitionSpacing and (
                p.tilePartitionWidthList or p.tilePartitionHeightList
            ):
                # explicit per-column/row partition lists (64px units).
                # Patch positions are coded relative to tile*band origins,
                # so the coded rows MUST equal the packed band — user lists
                # that disagree would silently shift every tile at decode
                cols = [int(v) for v in p.tilePartitionWidthList] or [
                    width // 64
                ]
                rows = [int(v) for v in p.tilePartitionHeightList]
                if len(rows) != n_tiles or any(r != band64 for r in rows):
                    if rows:
                        print(
                            "warning: tilePartitionHeightList does not "
                            f"match the packed tile band ({band64}x64 px); "
                            "using the packed band",
                            file=sys.stderr,
                        )
                    rows = [band64] * n_tiles
                afti.afti_uniform_partition_spacing_flag = False
                afti.afti_num_partition_columns_minus1 = len(cols) - 1
                afti.afti_num_partition_rows_minus1 = len(rows) - 1
                afti.afti_partition_column_widths_minus1 = [
                    c - 1 for c in cols
                ]
                afti.afti_partition_row_heights_minus1 = [
                    r - 1 for r in rows
                ]
            else:
                if p.tilePartitionHeight > 0 and p.tilePartitionHeight != band64:
                    print(
                        "warning: tilePartitionHeight does not match the "
                        f"packed tile band ({band64}x64 px); using the band",
                        file=sys.stderr,
                    )
                afti.afti_uniform_partition_spacing_flag = True
                afti.afti_partition_cols_width_minus1 = (
                    p.tilePartitionWidth - 1 if p.tilePartitionWidth > 0
                    else width // 64 - 1
                )
                afti.afti_partition_rows_height_minus1 = band64 - 1
        if raw_geo_payload is not None:
            # aux sub-rows (PCCCodec.cpp:1869-1871 analog): tile 0 carries
            # every raw/EOM aux patch (see the raw-unit emission below), and
            # a nonzero row height is what gates the coded
            # rpdu/epdu_patch_in_auxiliary_video_flag on the read side.  Our
            # decoder takes the real aux dims from the RBV sub-stream
            # header, so the height here is the 64-px presence gate only.
            afti = afps.atlas_frame_tile_information
            aux_w = max(16, p.attributeRawSeparateVideoWidth)
            afti.afti_auxiliary_video_tile_row_width_minus1 = max(
                0, aux_w // 64 - 1
            )
            afti.afti_auxiliary_video_tile_row_height = [1] + [0] * (
                n_tiles - 1
            )
        atlas.afps_list.append(afps)

        band_blocks = (
            (tile_band or height) // p.occupancyResolution if n_tiles > 1 else 0
        )
        use_inter = p.constrainedPack and n_tiles <= 1 and len(frame_segs) > 1
        use_plr = p.pointLocalReconstruction and p.mapCountMinus1 == 0
        from ..bitstream.syntax import InterPatchDataUnit
        from ..utils.enums import PatchModePTile

        def _np_eq(a, b):
            return (a is None) == (b is None) and (
                a is None or np.array_equal(a, b)
            )

        for fi, segs in enumerate(frame_segs):
          inter_frame = use_inter and fi > 0
          prev_segs = frame_segs[fi - 1] if fi > 0 else []
          for tile in range(n_tiles):
            header = AtlasTileHeader(
                ath_type=(
                    AtlasTileType.P_TILE if inter_frame else AtlasTileType.I_TILE
                ),
                ath_id=tile,
                ath_atlas_frm_order_cnt_lsb=fi % 256,
                ath_patch_size_x_info_quantizer=max(0, p.log2QuantizerSizeX),
                ath_patch_size_y_info_quantizer=max(0, p.log2QuantizerSizeY),
                ath_pos_min_d_quantizer=d_shift,
                ath_pos_delta_max_d_quantizer=d_shift,
                # afps explicit-mode flag is 0, so this value is NOT coded;
                # it must equal the reader-side inference
                # max(0, g3d_m1 - g2d_m1) - 1 (PCCBitstreamReader.cpp:869,
                # PCCEncoder.cpp:8049) or the rpdu/epdu bit widths desync.
                # Our raw units carry zero 3D offsets (codec/raw_points.py),
                # so a 0-bit width is always sufficient.
                ath_raw_3d_offset_axis_bit_count_minus1=(
                    max(
                        0,
                        asps.asps_geometry_3d_bitdepth_minus1
                        - asps.asps_geometry_2d_bitdepth_minus1,
                    )
                    - 1
                ),
            )
            du = AtlasTileDataUnit()
            pred_idx = 0
            for seg in segs:
                patch = seg.patch
                if n_tiles > 1 and patch.tile_index != tile:
                    continue
                ref_i = patch.best_match_idx if inter_frame else -1
                if ref_i >= 0:
                    ref = prev_segs[ref_i].patch
                    if (
                        ref_i == pred_idx
                        and patch.u0 == ref.u0 and patch.v0 == ref.v0
                        and patch.size_u == ref.size_u
                        and patch.size_v == ref.size_v
                        and patch.u1 == ref.u1 and patch.v1 == ref.v1
                        and patch.d1 == ref.d1 and patch.size_d == ref.size_d
                        # a SKIP patch carries no plrData, so the decoder
                        # would inherit the REFERENCE frame's PLR modes;
                        # with PLR active, code INTER (which carries this
                        # frame's searched modes) unless they too match
                        and (not use_plr or (
                            patch.plr_mode == ref.plr_mode
                            and _np_eq(patch.plr_block_modes,
                                       ref.plr_block_modes)
                        ))
                    ):
                        # identical to the running reference -> SKIP (0 bits
                        # of payload, the cheapest patch mode)
                        from ..bitstream.syntax import SkipPatchDataUnit

                        du.patches.append(
                            PatchInformationData(
                                patch_mode=int(PatchModePTile.P_SKIP),
                                data=SkipPatchDataUnit(),
                            )
                        )
                        pred_idx = ref_i + 1
                        continue
                    du.patches.append(
                        PatchInformationData(
                            patch_mode=int(PatchModePTile.P_INTER),
                            data=InterPatchDataUnit(
                                ipdu_patch_index=ref_i - pred_idx,
                                ipdu_2d_pos_x=patch.u0 - ref.u0,
                                ipdu_2d_pos_y=patch.v0 - ref.v0,
                                ipdu_2d_delta_size_x=(
                                    (patch.size_u - ref.size_u) // qpx
                                ),
                                ipdu_2d_delta_size_y=(
                                    (patch.size_v - ref.size_v) // qpy
                                ),
                                ipdu_3d_offset_u=patch.u1 - ref.u1,
                                ipdu_3d_offset_v=patch.v1 - ref.v1,
                                ipdu_3d_offset_d=(
                                    (patch.d1 - ref.d1) >> d_shift
                                ),
                                ipdu_3d_range_d=(
                                    (patch.size_d - ref.size_d) >> d_shift
                                ),
                                # inter patches carry their own plrData
                                # sized from the ref patch's block map +
                                # the 2D deltas (PCCBitstreamReader.cpp
                                # :1182-1218); block modes flatten v-major
                                # like the intra path below
                                plrd_mode=(
                                    patch.plr_mode if use_plr else 0
                                ),
                                plrd_block_modes=(
                                    patch.plr_block_modes.flatten().tolist()
                                    if use_plr
                                    and patch.plr_block_modes is not None
                                    else None
                                ),
                            ),
                        )
                    )
                    pred_idx = ref_i + 1
                    continue
                du.patches.append(
                    PatchInformationData(
                        patch_mode=int(
                            PatchModePTile.P_INTRA
                            if inter_frame
                            else PatchModeITile.I_INTRA
                        ),
                        data=PatchDataUnit(
                            pdu_2d_pos_x=patch.u0,
                            pdu_2d_pos_y=patch.v0 - tile * band_blocks,
                            pdu_2d_size_x_minus1=patch.size_u // qpx - 1,
                            pdu_2d_size_y_minus1=patch.size_v // qpy - 1,
                            pdu_3d_offset_u=patch.u1,
                            pdu_3d_offset_v=patch.v1,
                            pdu_3d_offset_d=patch.d1 >> d_shift,
                            # quantDD units when minLevel>1 (identity at 0)
                            pdu_3d_range_d=(
                                (patch.size_d + 1) >> d_shift
                                if d_shift else patch.size_d
                            ),
                            pdu_projection_id=projection_id_of(
                                patch.normal_axis, patch.projection_mode,
                                patch.rotation_axis,
                            ),
                            pdu_orientation_index=int(patch.orientation),
                            pdu_lod_enabled_flag=(
                                patch.lod_x > 1 or patch.lod_y > 1
                            ),
                            pdu_lod_scale_x_minus1=patch.lod_x - 1,
                            pdu_lod_scale_y_idc=patch.lod_y - 1,
                            plrd_mode=patch.plr_mode,
                            plrd_block_modes=(
                                patch.plr_block_modes.flatten().tolist()
                                if patch.plr_block_modes is not None
                                else None
                            ),
                        ),
                    )
                )
            if tile == 0 and raw_geo_payload is not None and (
                raw_points is not None
            ) and len(raw_points[fi]):
                from ..codec.raw_points import make_raw_patch_unit

                du.patches.append(
                    PatchInformationData(
                        patch_mode=int(
                            PatchModePTile.P_RAW
                            if inter_frame
                            else PatchModeITile.I_RAW
                        ),
                        data=make_raw_patch_unit(
                            len(raw_points[fi]),
                            width=max(16, p.attributeRawSeparateVideoWidth),
                        ),
                    )
                )
            if tile == 0 and eom_points is not None and len(
                eom_points[fi]
            ) and p.enhancedOccupancyMapCode:
                from ..codec.eom import make_eom_patch_unit

                du.patches.append(
                    PatchInformationData(
                        patch_mode=int(
                            PatchModePTile.P_EOM
                            if inter_frame
                            else PatchModeITile.I_EOM
                        ),
                        data=make_eom_patch_unit(len(eom_points[fi])),
                    )
                )
            atl = AtlasTileLayerRbsp(header=header, data_unit=du)
            atl.afoc = fi
            atlas.atlas_tile_layers.append(atl)

        atlas.set_video_bitstream(
            VideoBitstream(VideoType.OCCUPANCY, occ_payload)
        )
        if geo_payload_maps is not None:
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.GEOMETRY_D0, geo_payload_maps[0])
            )
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.GEOMETRY_D1, geo_payload_maps[1])
            )
        else:
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.GEOMETRY, geo_payload)
            )
        if attr_payload_maps is not None:
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.ATTRIBUTE_T0, attr_payload_maps[0])
            )
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.ATTRIBUTE_T1, attr_payload_maps[1])
            )
        elif attr_payload is not None:
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.ATTRIBUTE, attr_payload)
            )
            if attr_payload_parts:
                # partitions 1..n of attribute 0 ride dedicated AVD units
                # keyed by vuh_attribute_partition_index (partition 0 is
                # the ATTRIBUTE slot above)
                for pi, pay in enumerate(attr_payload_parts, start=1):
                    atlas.attr_ext[(0, pi, 0)] = VideoBitstream(
                        VideoType.ATTRIBUTE, pay
                    )
        if refl_payload is not None:
            va.attribute_information.ai_attribute_count += 1
            va.attribute_information.ai_attribute_type_id.append(3)  # reflectance
            va.attribute_information.ai_attribute_codec_id.append(refl_cid)
            va.attribute_information.ai_attribute_dimension_minus1.append(0)
            va.attribute_information.ai_attribute_2d_bitdepth_minus1.append(15)
            va.attribute_information.ai_attribute_msb_align_flag.append(False)
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.ATTRIBUTE_REFL, refl_payload)
            )
        if raw_geo_payload is not None:
            va.vps_auxiliary_video_present_flag = True
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.GEOMETRY_RAW, raw_geo_payload)
            )
            if raw_attr_payload is not None:
                atlas.set_video_bitstream(
                    VideoBitstream(VideoType.ATTRIBUTE_RAW, raw_attr_payload)
                )
        return context
