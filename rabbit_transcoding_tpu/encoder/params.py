"""Encoder parameters.

Option names mirror the reference's PCCEncoderParameters / PccAppEncoder CLI
(~196 options, PccAppEncoder.cpp) for the subset implemented; the cfg
cascade (utils.config) binds these fields by name.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EncoderParameters:
    # I/O
    uncompressedDataPath: str = ""
    compressedStreamPath: str = "out.bin"
    reconstructedDataPath: str = ""
    startFrameNumber: int = 0
    frameCount: int = 32
    groupOfFramesSize: int = 32

    # atlas geometry
    minimumImageWidth: int = 1024
    minimumImageHeight: int = 64
    occupancyResolution: int = 16
    occupancyPrecision: int = 4
    geometry3dCoordinatesBitdepth: int = 10
    geometryNominal2dBitdepth: int = 10
    mapCountMinus1: int = 1   # 2 maps (D0 near + D1 far), the reference default
    # one video sub-stream PER MAP (reference: multipleStreams; V3C
    # vps_multiple_map_streams_present_flag + vuh_map_index GVD/AVD units)
    multipleStreams: bool = False
    # absolute vs predicted map coding (reference: absoluteD1/absoluteT1,
    # the ctc-*-D1-from-rec-D0 / T1-from-rec-T0 conditions): when False,
    # the map-1 stream codes a biased delta against the RECONSTRUCTED map 0
    # (vps_map_absolute_coding_enabled_flag[1]=0); requires multipleStreams
    absoluteD1: bool = True
    absoluteT1: bool = True
    # background padding family (PCCEncoder.cpp:371-443, 5749, 5989):
    # attributeBGFill 0 dilate | 1 smoothed push-pull | 2 harmonic | 3 none;
    # geometryPadding 1 refines decoded-occupancy rim pixels with
    # nearest-surface depths (dilate3DPadding analog); groupDilation averages
    # the dual-map background pair so T1/D1 predicts it for free
    attributeBGFill: int = 1
    geometryPadding: int = 0
    groupDilation: bool = True
    rawPointsPatch: bool = True  # missed points -> raw patches in aux video
    # sort raw points along the Morton curve before aux-video packing:
    # spatial locality becomes sequence locality the entropy coder rewards
    # (reference mortonOrderSortRawPoints)
    mortonOrderSortRawPoints: bool = False
    # code the aux raw videos LOSSY at the aux QPs (reference:
    # lossyRawPointsPatch + auxGeometryQP/auxAttributeQP); the closed loop
    # and decoder both consume the decoded coords/colors
    lossyRawPointsPatch: bool = False
    auxGeometryQP: int = 4
    auxAttributeQP: int = 4
    # EOM: code between-layer points in the occupancy bit planes (reference:
    # enhancedOccupancyMapCode; forces occupancyPrecision 1)
    enhancedOccupancyMapCode: bool = False
    # EOMFixBitCount (asps_eom_fix_bit_count): between-layer depth bits per
    # EOM cell.  The reference defaults to 2; this framework's lossless
    # occupancy plane carries up to 7, kept as the default so deep interiors
    # stay in EOM instead of spilling to the raw patch
    EOMFixBitCount: int = 7
    # patchExpansion (PCCPatchSegmenter.cpp:578): grow components (largest
    # first) across partition seams within dist^2 <= 2
    patchExpansion: bool = False
    # enablePatchSplitting gates the maxPatchSize component splitting
    enablePatchSplitting: bool = True
    # patch-size quantizers (ath_patch_size_{x,y}_info_quantizer): patch
    # sizes pad up to multiples of 1<<log2QuantizerSize* and code in those
    # units.  0 = exact pixel sizes (this framework's default — the
    # placement-orientation inverses then need no padding at all)
    log2QuantizerSizeX: int = 0
    log2QuantizerSizeY: int = 0
    # depthQuantizationStep (minLevel): power-of-two step for the patch D1
    # reference; codes pdu_3d_offset_d in ath_pos_min_d_quantizer units
    depthQuantizationStep: int = 1
    # useRawPointsSeparateVideo: accepted for cfg compatibility — this
    # framework always carries raw/EOM samples in the auxiliary video
    # (rpdu_patch_in_auxiliary_video_flag=1), which is lossless under RBV by
    # default, so both settings give bit-exact raw points
    useRawPointsSeparateVideo: bool = True
    # attributeRawSeparateVideoWidth: width of the auxiliary raw videos
    attributeRawSeparateVideoWidth: int = 256
    # PLR: synthesize a second layer per patch in single-map mode (reference:
    # pointLocalReconstruction + PLR search, PCCEncoder.cpp:350,5364)
    pointLocalReconstruction: bool = False
    # plrd_level_flag: 1 = one PLR mode per patch (default), 0 = one mode per
    # packing block (finer rate/quality trade, 23090-5 8.3.7.9 block level)
    plrLevel: int = 1
    # nbPlrmMode: number of PLR modes incl. the implicit no-op (the first N
    # entries of the canonical g_pointLocalReconstructionMode table,
    # PCCEncoderParameters.cpp:40-44,168)
    nbPlrmMode: int = 6
    # patchSize: patches with at most this many packing blocks always code
    # PLR at patch level (plri_block_threshold_per_patch,
    # PCCEncoder.cpp:5418,7837)
    patchSize: int = 9
    # single-map pixel interleaving (PCCEncoderParameters.h:218): both depth
    # maps checkerboard into ONE geometry/attribute video
    # (asps_pixel_deinterleaving_flag); requires mapCountMinus1 = 1
    singleMapPixelInterleaving: bool = False
    # lossy occupancy: occupancy coded as a lossy video, binarised at the
    # OI threshold (reference: lossyOccupancyMap + occupancyMapQP)
    lossyOccupancyMap: bool = False
    occupancyMapQP: int = 38
    # lossy-OM shaping knobs (PCCEncoder.cpp:901,920,973): occupied pixels
    # code as `offsetLossyOM` (0 = full range), the decoder binarises at the
    # OI-carried threshold (`thresholdLossyOM`, 0 = half the offset), and
    # `prefilterLossyOM` runs the 3x3 kernel {12,28,12;28,96,28;12,28,12}>>8
    # over the occupancy video before encoding (PCCEncoderConstant.h:40)
    offsetLossyOM: int = 0
    thresholdLossyOM: int = 0
    prefilterLossyOM: bool = False
    # 45-degree extended projection planes (reference name):
    # 0 off · 1 about Y · 2 about X · 3 about Z · 4 all three ·
    # 5 partial (top partialAdditionalProjectionPlane slice of the longest
    # axis re-segments with that axis's diagonal planes)
    additionalProjectionPlaneMode: int = 0
    partialAdditionalProjectionPlane: float = 0.0
    # enhancedProjectionPlane: weight axial PPI scores by per-axis
    # projected-face coverage (calculateWeightNormal, PCCEncoder.cpp:3601)
    enhancedProjectionPlane: bool = False
    minWeightEPP: float = 0.6

    # lossless coding (reference: cfg/common/ctc-common-lossless-geometry*.cfg
    # + PCCEncoderParameters.h:180-183 noAttributes_/rawPointsPatch_/
    # attributeVideo444_; video-level losslessness comes from the HM SCC
    # lossless cfgs there — here it selects the RBV lossless backend)
    losslessGeo: bool = False        # geometry video coded lossless
    losslessAttribute: bool = False  # attribute video coded lossless
    noAttributes: bool = False       # geometry-only stream (ai_attribute_count=0)
    attributeVideo444: bool = False  # attribute video RGB444 (no 420 subsample)
    # dimension-partitioned attribute sub-streams (23090-5
    # attribute_information partitions; reference PCCDecoder.cpp:208-300
    # decodes per-partition videos routed by vuh_attribute_partition_index).
    # 1 = single AVD stream (default); 3 = one single-channel sub-stream per
    # color plane (partition 0 carries channel 0 in the ATTRIBUTE slot,
    # partitions 1/2 ride attr_ext AVD units).
    attributeDimensionPartitions: int = 1

    # per-component video codec selection (reference names,
    # PccAppEncoder.cpp:477-499): RBV (the device codec, default) or an external
    # app family (HM_APP / JM_APP / SHM_APP / VTM_APP / FFMPEG_APP); the
    # *Path options pin the binary (else RABBIT_<ID>_ENCODER env, else PATH)
    videoEncoderOccupancyCodecId: str = "RBV"
    videoEncoderGeometryCodecId: str = "RBV"
    videoEncoderAttributeCodecId: str = "RBV"
    videoEncoderOccupancyPath: str = ""
    videoEncoderGeometryPath: str = ""
    videoEncoderAttributePath: str = ""
    # external-codec cfg files (the cfg/hm, cfg/jm, cfg/shm, cfg/vtm corpus;
    # reference names PccAppEncoder.cpp:298-556) — ignored by RBV, inserted
    # as -c/-d ahead of the CLI options for external encoders
    occupancyMapConfig: str = ""
    geometryConfig: str = ""
    geometryMPConfig: str = ""    # raw-points aux geometry video
    attributeConfig: str = ""
    attributeMPConfig: str = ""   # raw-points aux attribute video

    # rate points
    geometryQP: int = 28
    attributeQP: int = 37
    allIntra: bool = False
    videoGopSize: int = 2
    # motion-compensated P frames in the video codec (HM-ME analog)
    motionEstimation: bool = True
    # usePccRDO analog: occupancy-aware RDO — the video motion search masks
    # its distortion with the decoded occupancy so only pixels that become
    # points drive MV choice.  Default ON (the reference defaults off only
    # because its version needs a patched HM; with the native RBV codec it
    # is free and measured -5.2% geometry / -1.7% attribute bytes at equal
    # D1/color MSE on the bench content)
    usePccRDO: bool = True
    # RBV coefficient-level RDO for GEOMETRY payloads: zero +/-1 quantised
    # coefficients at zigzag rank >= this (0 = off).  Depth maps are
    # piecewise smooth, so isolated high-frequency +/-1s are quantisation
    # noise that costs entropy bits (A/B: scripts/rbv_rd.py, RESULTS.md);
    # attributes keep every coefficient (textured content).
    geometryCoeffThreshold: int = 0
    # RBV intra prediction (mosaic DC/planar) on GEOMETRY I-frames: the
    # HEVC intra role in block-parallel form.  BD-rate A/B
    # (RBV_RD_INTRA_AB=1 scripts/rbv_rd.py): geometry -21.6% all-intra /
    # -3.2% gop2 — ships ON for geometry; attribute measured +-1% (side
    # info cancels the gain on textured content) so it stays OFF there
    geometryIntraPrediction: bool = True
    # same tool on attribute payloads (A/B: -1.8% gop2, ~0 gop4;
    # +1.7% at gop8 — gated to gop <= 4 like geometry)
    attributeIntraPrediction: bool = True
    # apply3dMotionCompensation: exploit 3D-consistent motion in the video
    # layer; with the native RBV codec this turns on its MC P-frame search
    # (the reference writes blockinfo files to steer HM's search instead)
    apply3dMotionCompensation: bool = False
    # 444->420 chroma downsample filter (ops/color._DOWN_FILTERS bank:
    # 0 DF_F0, 1 DF_F1, 2 DF_TM5, 3 DF_FV — PCCInternalColorConverter.cpp:37)
    chromaDownsampleFilter: int = 1
    # per-patch chroma subsampling: filter taps stay inside the owning
    # patch (patchColorSubsampling, PCCVideoEncoder.cpp:70-130)
    patchColorSubsampling: bool = False

    # segmentation
    surfaceThickness: int = 4
    # surfaceSeparation: only color-similar points join a patch's D0..D1
    # column; dissimilar back surfaces re-patch separately (reference name)
    surfaceSeparation: bool = False
    # components wider than this (tangent/bitangent px) split at the median
    # of the longer axis (reference maxPatchSize / enablePatchSplitting)
    maxPatchSize: int = 1024
    # LoD patch subsampling (levelOfDetailX/Y): code every Nth tangent /
    # bitangent sample; off-grid points fall to the raw patch when
    # rawPointsPatch is on (lossy otherwise)
    levelOfDetailX: int = 1
    levelOfDetailY: int = 1
    # gridBasedSegmentation: voxelize before normals/PPI/refine/CC
    # (PCCEncoderParameters.h:101-102) — big encode speedup on dense clouds
    gridBasedSegmentation: bool = False
    voxelDimensionGridBasedSegmentation: int = 2
    # highGradientSeparation (PCCEncoderParameters.h:223-225): evict
    # edge-on cells from patches and repartition to a non-parallel axis
    highGradientSeparation: bool = False
    minGradient: float = 15.0
    minNumHighGradientPoints: int = 256
    minPointCountPerCCPatchSegmentation: int = 16
    maxNNCountRefineSegmentation: int = 48
    iterationCountRefineSegmentation: int = 10
    lambdaRefineSegmentation: float = 3.0
    nnNormalEstimation: int = 16
    # normalOrientation (PCCPatchSegmenter.cpp:88): 0 none | 1 spanning tree
    # | 2 viewpoint | 3 cubemap projection
    normalOrientation: int = 1
    # gridBasedRefineSegmentation (refineSegmentationGridBased,
    # PCCPatchSegmenter.cpp:1334): PPI smoothing over voxel-level score
    # histograms within searchRadius instead of the point KNN graph
    gridBasedRefineSegmentation: bool = False
    voxelDimensionRefineSegmentation: int = 4
    searchRadiusRefineSegmentation: int = 192
    # lossyRawPointsPatch density pruning threshold (PCCEncoder.cpp:4274)
    minNormSumOfInvDist4MPSelection: float = 0.35
    # CC adjacency KNN width (distinct from the refine pass's);
    # 0 = reuse the refine graph width
    maxNNCountPatchSegmentation: int = 16
    # raw-points thresholds (PCCPatchSegmenter.cpp:526-527): a point whose
    # NN dist^2 to the resampled reconstruction exceeds `selection` stays
    # missed; a missed component is only re-patched when some member
    # exceeds `detection`.  Lossless cfgs set selection to 0.
    maxAllowedDist2RawPointsDetection: float = 9.0
    maxAllowedDist2RawPointsSelection: float = 1.0
    # KNN edges longer than this never join a connected component
    maxCCEdgeDistance: float = 5.0

    # packing
    # orientation search width (reference name useEightOrientations): all 8
    # placement orientations vs DEFAULT+SWAP only.  We default ON (denser
    # packing; the reference defaults off, PCCEncoderParameters.cpp:181) and
    # signal the choice in asps_use_eight_orientations_flag.
    useEightOrientations: bool = True
    # conservative placement: a patch claims its whole bounding box
    # (PCCEncoder.cpp:1469-1474) so no later patch interleaves into it
    lowDelayEncoding: bool = False
    # b2p precedence (asps_patch_precedence_order_flag): True = first-coded
    # patch wins contested blocks (our native order — the closed loop and
    # decoder both honor the signalled flag); False = reference-default
    # last-coded-wins (PCCCodec.cpp:2068-2072)
    patchPrecedenceOrder: bool = True
    # GPA window knobs (PCCEncoder.cpp:1843,1857,1768): window size in
    # frames (0 = whole GOF), chain reset at window boundaries, and the
    # matched-pair area-ratio below which a temporal chain is broken
    globalPackingStrategyGOF: int = 0
    globalPackingStrategyReset: bool = False
    globalPackingStrategyThreshold: float = 0.0
    # multi-tile atlas: uniform horizontal bands, one ATL per tile per frame
    # (reference: tile options of PCCEncoderParameters / AFTI)
    tileCount: int = 1
    # tileSegmentationType (PCCEncoderParameters.h): 0 = single tile,
    # 1 = tiles from point-cloud partitioning (the ROI path), 2 = fixed
    # grid of numMaxTilePerFrame tiles
    tileSegmentationType: int = 0
    numMaxTilePerFrame: int = 1
    # AFTI partition grid: uniform spacing (width/height in 64px units) or
    # explicit per-column/row lists
    uniformPartitionSpacing: bool = True
    tilePartitionWidth: int = 0
    tilePartitionHeight: int = 0
    tilePartitionWidthList: list = dataclasses.field(default_factory=list)
    tilePartitionHeightList: list = dataclasses.field(default_factory=list)
    # point-cloud partitioning (PCCPatchSegmenter.cpp:585-660): each ROI is
    # cut along its sorted-longest axes into chunks and connected
    # components never span a chunk boundary
    enablePointCloudPartitioning: bool = False
    numTilesHor: int = 2
    tileHeightToWidthRatio: float = 1.0
    numCutsAlong1stLongestAxis: int = 0
    numCutsAlong2ndLongestAxis: int = 0
    numCutsAlong3rdLongestAxis: int = 0
    # ROI-driven tiling (reference: roiBoundingBox* sequence options +
    # generateTilesFromSegments, PCCEncoder.cpp:5108): comma-separated
    # per-ROI bounds; when set, patches tile by the ROI containing their
    # 3D centroid and tileCount becomes the ROI count
    roiBoundingBoxMinX: str = ""
    roiBoundingBoxMaxX: str = ""
    roiBoundingBoxMinY: str = ""
    roiBoundingBoxMaxY: str = ""
    roiBoundingBoxMinZ: str = ""
    roiBoundingBoxMaxZ: str = ""
    # temporally consistent packing + inter patch coding (reference:
    # constrainedPack / spatialConsistencyPackFlexible)
    constrainedPack: bool = True
    # one packing grid for the whole GOF; matched chains own their blocks
    # (reference: globalPatchAllocation / performDataAdaptiveGPAMethod)
    globalPatchAllocation: bool = False
    # adaptive GPA decision: keep the global packing unless its atlas
    # height blows past per-frame packing x this factor (GOF-stable
    # positions are worth real extra area — chains reserve space across
    # frames — but not unbounded), or the global grid overflows outright
    gpaHeightTolerance: float = 2.0
    # packTetris-style lowest-skyline placement instead of first-fit
    packingStrategy: int = 0  # 0 = flexible/first-fit, 1 = tetris
    # free blocks kept between different patches (PCCPatch.cpp:318); >0
    # trades atlas height for less fill bleeding into dilated occupancy
    safeGuardDistance: int = 0
    # occupancyMapRefinement (refineOccupancyMap, PCCEncoder.cpp:3818):
    # drop one-point precision tiles and <4-point packing blocks from
    # patch occupancy; the evicted points rejoin the raw patch
    occupancyMapRefinement: bool = False
    # occupancy synthesis / patch-border filtering (PatchBlockFiltering,
    # PCCPatch.h:301-435): emit the SEI and erode dilated occupancy rims
    # whose decoded geometry deviates off-surface (decoder applies the same)
    pbfEnableFlag: bool = False
    # PBF knobs (reference defaults + auto-derivation,
    # PCCEncoderParameters.cpp:222-224,1132-1133): 0 passes = auto from
    # occupancyPrecision (<=2 -> 1, ==4 -> 2, else 4); 0 size = precision
    pbfPassesCount: int = 0
    pbfFilterSize: int = 0
    pbfLog2Threshold: int = 2

    # reconstruction / attribute
    removeDuplicatePoints: bool = True
    recolorNeighborCount: int = 1
    # reference recolor knob (numNeighborsColorTransferFwd): neighbor count
    # of the source->reconstruction transfer; 0 = use recolorNeighborCount
    numNeighborsColorTransferFwd: int = 0
    # the rest of the transferColors knob set (PCCPointSet.cpp:807-1110;
    # reference CLI names kept, defaults = PCCEncoderParameters.cpp /
    # ctc-common.cfg values).  Setting any non-default value routes the
    # attribute transfer through ops/recolor.transfer_colors_fwd_bwd.
    numNeighborsColorTransferBwd: int = 1
    useDistWeightedAverageFwd: bool = True
    useDistWeightedAverageBwd: bool = True
    skipAvgIfIdenticalSourcePointPresentFwd: bool = True
    skipAvgIfIdenticalSourcePointPresentBwd: bool = True
    distOffsetFwd: float = 4.0
    distOffsetBwd: float = 4.0
    maxGeometryDist2Fwd: float = 1000.0
    maxGeometryDist2Bwd: float = 1000.0
    maxColorDist2Fwd: float = 1000.0
    maxColorDist2Bwd: float = 1000.0
    excludeColorOutlier: bool = False
    thresholdColorOutlierDist: float = 10.0
    bestColorSearchRange: int = 0
    # reference-parity default: the fwd+bwd transfer IS transferColors;
    # turn off to fall back to the fast fwd-only KNN blend
    useFwdBwdColorTransfer: bool = True
    # encoder-side color pre-smoothing before the attribute video
    # (presmoothPointCloudColor, PCCEncoder.cpp:6578): damps color outliers
    # that would cost attribute bits; decoder-invisible
    flagColorPreSmoothing: bool = False
    thresholdColorPreSmoothing: float = 10.0

    # decoder-side smoothing, signalled via geometry-smoothing SEI
    # (reference names: flagGeometrySmoothing/gridSmoothing/thresholdSmoothing)
    flagGeometrySmoothing: bool = True
    gridSmoothing: bool = True
    gridSize: int = 8
    thresholdSmoothing: float = 64.0
    minNeighborsSmoothing: int = 4
    # full-KNN smoothing knobs (the gridSmoothing=0 path,
    # PCCCodec::smoothPointCloud; defaults PCCEncoderParameters.cpp:92-94).
    # Like the reference, this variant is NOT SEI-carried and the closed
    # loop/decoder only smooth on the SEI — the knobs configure the library
    # capability (ops/smoothing.knn_smooth via codec/postprocess).
    neighborCountSmoothing: int = 64
    radius2Smoothing: float = 64.0
    radius2BoundaryDetection: float = 64.0
    flagColorSmoothing: bool = False
    thresholdColorSmoothing: float = 10.0
    # grid color smoothing knobs (cgridSize/thresholdColorDifference/
    # thresholdColorVariation -> the attribute-smoothing SEI fields;
    # defaults PCCEncoderParameters.cpp:147-150)
    cgridSize: int = 4
    thresholdColorDifference: float = 10.0
    thresholdColorVariation: float = 6.0
    # post-smoothing attribute re-transfer selector (attrTransferFilterType,
    # PCCEncoderParameters.cpp:270; active only under
    # profileReconstructionIdc=1, squashed to 0 under Rec0/Rec2 like the
    # reference :740-796)
    attributeTransferFilterType: int = 1
    # color pre-smoothing knobs (presmoothPointCloudColor; defaults
    # PCCEncoderParameters.cpp:152-154)
    thresholdColorPreSmoothingLocalEntropy: float = 4.5
    radius2ColorPreSmoothing: float = 64.0
    neighborCountColorPreSmoothing: int = 64

    # profile/tier/level signalling (reference names; land in the VPS PTL)
    profileCodecGroupIdc: int = 0
    profileToolsetIdc: int = 0
    profileReconstructionIdc: int = 0
    levelIdc: int = 30
    tierFlag: bool = False

    # rate offsets per map stream (reference deltaQPD0/D1/T0/T1; the D1/T1
    # offsets apply in multipleStreams mode where each map is its own video)
    deltaQPD0: int = 0
    deltaQPD1: int = 0
    deltaQPT0: int = 0
    deltaQPT1: int = 0

    # self-checks
    decodedAtlasInformationHash: int = 1  # 0=off, 1=MD5

    # --- stream-level signalling plumbing (reference names) ---
    # force the sample-stream size-field width (ssvh_unit_size_precision_
    # bytes_minus1 + 1); 0 = derive from the largest unit (PccAppEncoder
    # forcedSsvhUnitSizePrecisionBytes, PCCBitstreamWriter precision arg)
    forcedSsvhUnitSizePrecisionBytes: int = 0
    # ptc_one_v3c_frame_only_flag in the PTL toolset constraints
    # (PCCEncoderParameters.cpp:251 "V-PCC Basic")
    oneV3CFrameOnlyFlag: bool = False
    # coded codec-id indices used by the Component Codec Mapping SEI under
    # the MP4RA codec group (PCCEncoderParameters.cpp:245-248,
    # getCodecIdIndex :1248-1276); only consulted when profileCodecGroupIdc
    # is pinned to MP4RA (127) with external codec components
    avcCodecIdIndex: int = 0
    hevcCodecIdIndex: int = 1
    shvcCodecIdIndex: int = 2
    vvcCodecIdIndex: int = 3
    # keep external-codec intermediate files (YUV/bin/cfg) for inspection
    # (keepIntermediateFiles, PCCVideoEncoder.cpp:346-402)
    keepIntermediateFiles: bool = False
    # hand Annex-B byte streams to external codec binaries (default) or
    # NAL sample streams (byteStreamVideoEncoder*, PccAppEncoder.cpp;
    # reference default true, PCCEncoderParameters.cpp:117-119)
    byteStreamVideoEncoderOccupancy: bool = True
    byteStreamVideoEncoderGeometry: bool = True
    byteStreamVideoEncoderAttribute: bool = True
    # color transform applied to source colors at load time and inverted on
    # reconstruction write (0 none | 1 RGB->YCbCr Rec.709; reference
    # COLOR_TRANSFORM_* PCCCommon.h:92)
    colorTransform: int = 0
    # HDRConvert binary + cfgs: when set, the attribute 444<->420
    # conversions route through the external converter instead of the
    # internal filter banks (PCCVirtualColorConverter, cfg/hdrconvert)
    colorSpaceConversionPath: str = ""
    colorSpaceConversionConfig: str = ""
    inverseColorSpaceConversionConfig: str = ""
    # per-map external-codec cfgs in multipleStreams mode (geometry0Config/
    # geometry1Config/attribute0Config/attribute1Config); fall back to the
    # single-stream geometryConfig/attributeConfig when empty
    geometry0Config: str = ""
    geometry1Config: str = ""
    attribute0Config: str = ""
    attribute1Config: str = ""
    # spatial-consistency matching: max candidate patches examined per
    # patch (maxCandidateCount, PCCEncoderParameters.cpp:82)
    maxCandidateCount: int = 4
    # ATL reference-list signalling (constructAspsRefListStruct,
    # PCCEncoderParameters.cpp:1227-1246; reference option keeps the
    # historical 'Atals' typo)
    maxNumRefAtalsList: int = 1
    maxNumRefAtlasFrame: int = 1
    # SHVC layered coding via the SHM external encoder (shvcLayerIndex/
    # shvcRateX/shvcRateY, PCCEncoderParameters.cpp:274-276): rateX/rateY
    # are the per-layer downscale divisors passed to the SHM template
    shvcLayerIndex: int = 8
    shvcRateX: int = 0
    shvcRateY: int = 0

    # ------------------------------------------------------------------
    def roi_boxes(self) -> list[tuple[int, int, int, int, int, int]]:
        """Parsed ROI bounding boxes [(minx, maxx, miny, maxy, minz, maxz)];
        empty when the roiBoundingBox* options are unset."""
        raw = [
            self.roiBoundingBoxMinX, self.roiBoundingBoxMaxX,
            self.roiBoundingBoxMinY, self.roiBoundingBoxMaxY,
            self.roiBoundingBoxMinZ, self.roiBoundingBoxMaxZ,
        ]
        if not all(str(r).strip() for r in raw):
            return []
        cols = [[int(v) for v in str(r).split(",")] for r in raw]
        n = min(len(c) for c in cols)
        return [tuple(c[i] for c in cols) for i in range(n)]
