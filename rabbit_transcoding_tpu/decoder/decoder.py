"""The V-PCC decoder pipeline.

Capability parity with PCCDecoder (/root/reference/source/lib/PccLibDecoder/
source/PCCDecoder.cpp:77-421): parse ATLs -> patch lists -> decode the three
video sub-streams -> occupancy maps -> batched patch->3D reprojection +
coloring -> (optional SEI-driven smoothing) -> point clouds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bitstream.hls import Context
from ..codec.patch_frame import decode_patch_frames
from ..codec.reconstruct import GeneratePointCloudParameters, ReconstructionEngine
from ..core.pointset import PointSet
from ..utils.enums import CodecId, VideoType
from ..utils.timing import StageTimer
from ..video import VideoDecoder


@dataclasses.dataclass
class DecoderParameters:
    compressedStreamPath: str = ""
    reconstructedDataPath: str = ""
    startFrameNumber: int = 0
    keepIntermediateFiles: bool = False
    computeChecksum: bool = True
    computeMetrics: bool = False
    uncompressedDataPath: str = ""
    # external decoder binaries for foreign (Annex-B) sub-streams
    # (reference names, PccAppDecoder.cpp:124-134); the codec family comes
    # from the stream's codec-group / CCM SEI signalling, the binary from
    # these paths, then RABBIT_<ID>_DECODER env, then PATH
    videoDecoderOccupancyPath: str = ""
    videoDecoderGeometryPath: str = ""
    videoDecoderAttributePath: str = ""
    # external decoder binaries consume Annex-B (default) or NAL sample
    # streams (byteStreamVideoCoder*, PccAppDecoder.cpp:136-147)
    byteStreamVideoCoderOccupancy: bool = True
    byteStreamVideoCoderGeometry: bool = True
    byteStreamVideoCoderAttribute: bool = True
    # colour transform applied to the output clouds (0 none | 1 RGB->YCbCr
    # Rec.709; PccAppDecoder.cpp:111-115)
    colorTransform: int = 0
    # multi-chip: a jax.sharding.Mesh shards the reconstruction's per-frame
    # reprojection across devices (no reference analog — the multi-device
    # scaling axis, parallel/pipeline.py).  None = single device.
    shardingMesh: object = None
    # HDRConvert for the attribute YUV420->RGB444 inverse conversion
    # (colorSpaceConversionPath + inverseColorSpaceConversionConfig)
    colorSpaceConversionPath: str = ""
    inverseColorSpaceConversionConfig: str = ""
    # post-smoothing attribute transfer selector (decoder-side
    # attributeTransferFilterType, PccAppDecoder.cpp:152-155; -1 = derive
    # from the stream's reconstruction profile like the reference,
    # PCCDecoderParameters.cpp:60,115-145; 0 excludes geometry smoothing
    # from attribute transfer)
    attributeTransferFilterType: int = -1
    # patchColorSubsampling (PccAppDecoder.cpp:166-169): accepted for cfg
    # compatibility but a NO-OP here — the encoder's closed loop
    # reconstructs with the shared standard 420 up-sampling even when it
    # down-sampled patch-aware, so the decoder must use the same standard
    # up-sampling for checksums to match; a per-patch up-sample would
    # DIVERGE from the coded closed loop
    patchColorSubsampling: bool = False
    # SHVC layer to decode from layered sub-streams (PccAppDecoder.cpp:160)
    shvcLayerIndex: int = 8


class Decoder:
    def __init__(self, params: DecoderParameters | None = None):
        self.params = params or DecoderParameters()
        self.timer = StageTimer()
        self._ctx: Context | None = None
        self._sei_atlas = None

    # ------------------------------------------------------------------
    def _vdec(self, vtype: VideoType, data: bytes,
              output_bitdepth: int | None = None):
        """Decode one video sub-stream, dispatching on its actual codec:
        RBV payloads decode natively; Annex-B payloads resolve an external
        decoder from the stream's codec-group/CCM signalling
        (PCCTranscoder::getCodedCodecId analog; decoder-side routing of
        PCCDecoder.cpp:108-300 via PCCVideoDecoder::decompress)."""
        from ..video import codec_group as cg
        from ..video import rbv as rbv_mod

        if data[:4] == rbv_mod._MAGIC:
            return VideoDecoder.create(CodecId.RBV).decode(
                data, output_bitdepth
            )
        if not cg.is_annexb(data):
            raise ValueError(
                f"unrecognised {vtype.name} video payload (neither RBV nor "
                f"Annex-B)"
            )
        from ..video import base as video_base
        from ..video.external import decode_annexb_probed

        ctx = self._ctx
        comp = cg.component_of(vtype)
        codec = cg.signalled_codec(ctx, self._sei_atlas, vtype, data)
        if codec in (CodecId.RBV, CodecId.RBV_LOSSLESS):
            # signalled RBV but the payload is Annex-B (e.g. legacy stream
            # with default group): assume the HEVC family like the
            # transcoder's foreign route does
            codec = CodecId.HM_APP
        suffix = {"occupancy": "Occupancy", "geometry": "Geometry",
                  "attribute": "Attribute"}[comp]
        explicit = getattr(self.params, f"videoDecoder{suffix}Path", "")
        if codec == CodecId.FFMPEG_APP:
            name, template = "ffmpeg", video_base.FFMPEG_DECODER_TEMPLATE
        else:
            from ..video import external as external_mod

            _, name, _, tmpl_name = video_base._EXTERNAL_APPS[codec]
            template = getattr(external_mod, tmpl_name)
        binary = video_base._resolve_binary(codec, name, "DECODER", explicit)
        fb_w = fb_h = 0
        if ctx is not None and ctx.vps_list and comp != "occupancy":
            fb_w = ctx.vps.atlas(0).vps_frame_width
            fb_h = ctx.vps.atlas(0).vps_frame_height
        # SHVC layered payloads: keep NALs up to the requested layer before
        # decoding (shvcLayerIndex, PccAppDecoder.cpp:160-163)
        from ..video.hevc_probe import filter_hevc_layers, hevc_layer_ids

        if (
            self.params.shvcLayerIndex >= 0
            and len(hevc_layer_ids(data)) > 1
        ):
            data = filter_hevc_layers(data, self.params.shvcLayerIndex)
        video = decode_annexb_probed(
            data, binary, template, fb_w, fb_h,
            byte_stream=bool(getattr(
                self.params, f"byteStreamVideoCoder{suffix}", True
            )),
            keep_files=self.params.keepIntermediateFiles,
        )
        if output_bitdepth is not None and output_bitdepth != video.bitdepth:
            video = video.convert_bitdepth(output_bitdepth)
        return video

    def decode(self, context: Context, atlas_id: int = 0) -> list[PointSet]:
        atlas = context.atlas(atlas_id)
        vps_atlas = context.vps.atlas(0)
        width = vps_atlas.vps_frame_width
        height = vps_atlas.vps_frame_height
        self._ctx = context
        self._sei_atlas = atlas  # carries the CCM SEI for codec dispatch

        with self.timer.stage("createPatchFrameDataStructure"):
            patch_frames = decode_patch_frames(atlas)

        with self.timer.stage("decodeOccupancyVideo"):
            occ_video = self._vdec(
                VideoType.OCCUPANCY,
                atlas.get_video_bitstream(VideoType.OCCUPANCY).data,
            )
        map1_absolute = context.map1_absolute()
        with self.timer.stage("decodeGeometryVideo"):
            if VideoType.GEOMETRY in atlas.video_bitstreams:
                geo_video = self._vdec(
                    VideoType.GEOMETRY,
                    atlas.get_video_bitstream(VideoType.GEOMETRY).data,
                )
            else:
                # per-map GVD sub-streams (vps_multiple_map_streams): map 1
                # is a biased delta vs rec map 0 when absolute coding is off
                from ..codec.mapstream import (
                    combine_map1,
                    geo_bias,
                    interleave_maps_np,
                )

                d0 = self._vdec(
                    VideoType.GEOMETRY_D0,
                    atlas.get_video_bitstream(VideoType.GEOMETRY_D0).data,
                )
                d1 = self._vdec(
                    VideoType.GEOMETRY_D1,
                    atlas.get_video_bitstream(VideoType.GEOMETRY_D1).data,
                )
                rec0 = np.asarray(d0.planes[0])
                rec1 = np.asarray(d1.planes[0])
                if not map1_absolute:
                    rec1 = combine_map1(
                        rec1, rec0, geo_bias(d0.bitdepth),
                        (1 << d0.bitdepth) - 1,
                    )
                from ..core.image import Video

                geo_video = Video(
                    d0.width, d0.height, d0.bitdepth, d0.format,
                    [interleave_maps_np(rec0, rec1)],
                )
        attr_video = None
        if VideoType.ATTRIBUTE in atlas.video_bitstreams:
            with self.timer.stage("decodeAttributeVideo"):
                attr_video = self._vdec(
                    VideoType.ATTRIBUTE,
                    atlas.get_video_bitstream(VideoType.ATTRIBUTE).data,
                )
                part_keys = sorted(
                    k for k in atlas.attr_ext if k[0] == 0 and k[2] == 0
                )
                if part_keys:
                    # dimension-partitioned attribute: the ATTRIBUTE slot
                    # carries partition 0 (luma); chroma partitions ride
                    # attr_ext AVD units at native subsampled resolution
                    # (reference per-partition decode,
                    # PCCDecoder.cpp:208-300)
                    from ..core.image import Video
                    from ..utils.enums import ColorFormat

                    planes = list(attr_video.planes)
                    for key in part_keys:
                        part = self._vdec(
                            VideoType.ATTRIBUTE,
                            atlas.attr_ext[key].data,
                        )
                        planes.extend(part.planes)
                    attr_video = Video(
                        attr_video.width, attr_video.height,
                        attr_video.bitdepth, ColorFormat.YUV420, planes,
                    )
        elif VideoType.ATTRIBUTE_T0 in atlas.video_bitstreams:
            with self.timer.stage("decodeAttributeVideo"):
                from ..codec.mapstream import (
                    attr_bias,
                    combine_map1,
                    interleave_maps_np,
                )
                from ..core.image import Video

                t0 = self._vdec(
                    VideoType.ATTRIBUTE_T0,
                    atlas.get_video_bitstream(VideoType.ATTRIBUTE_T0).data,
                )
                t1 = self._vdec(
                    VideoType.ATTRIBUTE_T1,
                    atlas.get_video_bitstream(VideoType.ATTRIBUTE_T1).data,
                )
                planes = []
                for p0, p1 in zip(t0.planes, t1.planes):
                    r0 = np.asarray(p0)
                    r1 = np.asarray(p1)
                    if not map1_absolute:
                        r1 = combine_map1(
                            r1, r0, attr_bias(t0.bitdepth),
                            (1 << t0.bitdepth) - 1,
                        )
                    planes.append(interleave_maps_np(r0, r1))
                attr_video = Video(
                    t0.width, t0.height, t0.bitdepth, t0.format, planes
                )
        refl_video = None
        if VideoType.ATTRIBUTE_REFL in atlas.video_bitstreams:
            with self.timer.stage("decodeReflectanceVideo"):
                refl_video = self._vdec(
                    VideoType.ATTRIBUTE_REFL,
                    atlas.get_video_bitstream(VideoType.ATTRIBUTE_REFL).data,
                )

        gpc = GeneratePointCloudParameters()
        gpc.mesh = self.params.shardingMesh
        # b2p precedence follows the signalled asps flag (PCCCodec.cpp:2068)
        if atlas.asps_list:
            gpc.patch_precedence = bool(
                atlas.asps_list[0].asps_patch_precedence_order_flag
            )
            asps0 = atlas.asps_list[0]
            if asps0.asps_plr_enabled_flag:
                # mode table = implicit no-op + the coded plri descriptors
                # (setPointLocalReconstruction, PCCDecoder.cpp:528-541)
                gpc.plr_modes = tuple(
                    [(False, False, 0, 1)]
                    + [
                        (
                            bool(asps0.plri_interpolate_flag[i]),
                            bool(asps0.plri_filling_flag[i]),
                            int(asps0.plri_minimum_depth[i]),
                            int(asps0.plri_neighbour_minus1[i]) + 1,
                        )
                        for i in range(
                            asps0.asps_plr_number_of_modes_minus1
                        )
                    ]
                )
        from ..bitstream.sei import SeiOccupancySynthesis

        for sei in atlas.seis_prefix + atlas.seis_suffix:
            if isinstance(sei, SeiOccupancySynthesis) and sei.os_method_type:
                gpc.pbf_enable = True
                gpc.pbf_passes = sei.os_pbf_passes_count_minus1 + 1
                gpc.pbf_filter_size = sei.os_pbf_filter_size_minus1 + 1
                gpc.pbf_threshold = float(
                    1 << (sei.os_pbf_log2_threshold_minus1 + 1)
                )
        engine = ReconstructionEngine(gpc)
        with self.timer.stage("generateOccupancyMaps"):
            occ_threshold = (
                vps_atlas.occupancy_information
                .oi_lossy_occupancy_compression_threshold
            )
            occ_maps = engine.occupancy_maps(
                occ_video, width, height, occ_threshold
            )

        if (atlas.asps_list
                and atlas.asps_list[0].asps_pixel_deinterleaving_flag):
            # single-map pixel interleaving: restore the dual-map
            # frame-interleaved layout the reconstruction engine expects
            import jax.numpy as jnp

            from ..core.image import Video
            from ..ops.interleave import deinterleave_maps
            from ..utils.enums import ColorFormat

            # occupancy-gated (and, for geometry, thickness-clamped)
            # interpolation — decoder-identical to the encoder closed loop
            st = (
                atlas.asps_list[0].asps_vpcc_surface_thickness_minus1 + 1
            )
            occ_pi = jnp.asarray(occ_maps[:, :height, :width])

            def _deinterleave(video, cf, thickness=None):
                planes = []
                for pl in video.planes:
                    m0, m1 = deinterleave_maps(
                        jnp.asarray(pl),
                        occ=(
                            occ_pi
                            if pl.shape[1:] == occ_pi.shape[1:] else None
                        ),
                        thickness=thickness,
                    )
                    rec = np.empty(
                        (2 * pl.shape[0],) + pl.shape[1:],
                        np.asarray(pl).dtype,
                    )
                    rec[0::2] = np.asarray(m0)
                    rec[1::2] = np.asarray(m1)
                    planes.append(rec)
                return Video(video.width, video.height, video.bitdepth,
                             cf, planes)

            geo_video = _deinterleave(geo_video, ColorFormat.YUV400,
                                      thickness=st)
            if attr_video is not None:
                attr_video = _deinterleave(attr_video, ColorFormat.YUV420)

        with self.timer.stage("generatePointCloud"):
            map_count = (
                atlas.asps_list[0].asps_map_count_minus1 + 1
                if atlas.asps_list
                else 1
            )
            n = min(
                len(patch_frames),
                occ_maps.shape[0],
                geo_video.frame_count // map_count,
            )
            clouds = engine.generate_point_clouds(
                patch_frames[:n], occ_maps[:n], geo_video, attr_video,
                map_count=map_count, refl_video=refl_video,
            )

        # raw (missed-points) patches from auxiliary video
        if VideoType.GEOMETRY_RAW in atlas.video_bitstreams:
            with self.timer.stage("recoverRawPoints"):
                from ..codec.raw_points import (
                    collect_raw_patch_units,
                    recover_raw_points,
                )

                raw_units = collect_raw_patch_units(atlas)
                raw_geo = self._vdec(
                    VideoType.GEOMETRY_RAW,
                    atlas.get_video_bitstream(VideoType.GEOMETRY_RAW).data,
                )
                raw_attr = None
                if VideoType.ATTRIBUTE_RAW in atlas.video_bitstreams:
                    raw_attr = self._vdec(
                        VideoType.ATTRIBUTE_RAW,
                        atlas.get_video_bitstream(VideoType.ATTRIBUTE_RAW).data,
                    )
                for fi in range(min(n, len(raw_units))):
                    if not raw_units[fi]:
                        continue
                    attr_frame = None
                    if raw_attr is not None:
                        attr_frame = np.stack(
                            [pl[fi] for pl in raw_attr.planes], axis=-1
                        )
                    # the encoder clips its closed loop to the REAL 3D
                    # coordinate depth; the asps value carries +1 when 45°
                    # rotated coordinates are active — undo that here
                    if atlas.asps_list:
                        a0 = atlas.asps_list[0]
                        coord_bits_raw = (
                            a0.asps_geometry_3d_bitdepth_minus1 + 1
                            - (1 if a0.asps_extended_projection_enabled_flag
                               else 0)
                        )
                    else:
                        coord_bits_raw = 10
                    pts, cols = recover_raw_points(
                        raw_units[fi], np.asarray(raw_geo.planes[0][fi]),
                        attr_frame,
                        coord_max=(1 << coord_bits_raw) - 1,
                    )
                    if len(pts) == 0:
                        continue
                    ps = clouds[fi]
                    merged = PointSet(
                        positions=np.concatenate([ps.positions, pts]),
                        colors=None
                        if ps.colors is None
                        else np.concatenate(
                            [
                                ps.colors,
                                cols
                                if cols is not None
                                else np.zeros((len(pts), 3), np.uint8),
                            ]
                        ),
                        reflectances=None
                        if ps.reflectances is None
                        else np.concatenate(
                            [
                                ps.reflectances,
                                np.zeros(len(pts), np.uint16),
                            ]
                        ),
                        # raw/EOM points are exact: never boundary-smoothed
                        types=None
                        if ps.types is None
                        else np.concatenate(
                            [ps.types, np.zeros(len(pts), np.uint8)]
                        ),
                        # raw/EOM points belong to no projected patch
                        partition=None
                        if ps.partition is None
                        else np.concatenate(
                            [ps.partition, np.full(len(pts), -1, np.int32)]
                        ),
                    )
                    clouds[fi] = merged.remove_duplicates()

        # EOM points from the occupancy bit planes (asps_eom_patch_enabled)
        if atlas.asps_list and atlas.asps_list[0].asps_eom_patch_enabled_flag:
            with self.timer.stage("recoverEomPoints"):
                from ..codec.eom import enumerate_frame_eom_points
                from ..codec.raw_points import (
                    collect_eom_patch_units,
                    collect_raw_patch_units,
                )

                eom_units = collect_eom_patch_units(atlas)
                raw_units2 = collect_raw_patch_units(atlas)
                raw_attr2 = None
                if VideoType.ATTRIBUTE_RAW in atlas.video_bitstreams:
                    raw_attr2 = self._vdec(
                        VideoType.ATTRIBUTE_RAW,
                        atlas.get_video_bitstream(VideoType.ATTRIBUTE_RAW).data,
                    )
                occ_plane_full = np.asarray(occ_video.planes[0])
                b2p = engine.block_to_patch_maps(
                    patch_frames[:n], occ_maps[:n],
                    block_size=(
                        patch_frames[0][0].occupancy_resolution
                        if patch_frames and patch_frames[0]
                        else 16
                    ),
                )
                geo_d0 = np.asarray(geo_video.planes[0])[::map_count]
                for fi in range(min(n, len(eom_units))):
                    if not eom_units[fi]:
                        continue
                    eom_plane = (
                        occ_plane_full[fi][:height, :width] >> 1
                    ).astype(np.uint8)
                    if not eom_plane.any():
                        continue
                    block = next(
                        (pl[0].occupancy_resolution
                         for pl in patch_frames if pl), 16,
                    )
                    owner_pix = np.repeat(
                        np.repeat(b2p[fi], block, 0), block, 1
                    )[:height, :width]
                    pts = enumerate_frame_eom_points(
                        patch_frames[fi], eom_plane,
                        geo_d0[fi][:height, :width].astype(np.int32),
                        owner_pix,
                    )
                    if len(pts) == 0:
                        continue
                    cols = None
                    if raw_attr2 is not None:
                        raw_count = sum(
                            u.rpdu_points_minus1 + 1 for u in raw_units2[fi]
                        ) if fi < len(raw_units2) else 0
                        attr_flat = np.stack(
                            [pl[fi] for pl in raw_attr2.planes], axis=-1
                        ).reshape(-1, 3)
                        cols = attr_flat[raw_count : raw_count + len(pts)]
                    ps = clouds[fi]
                    merged = PointSet(
                        positions=np.concatenate([ps.positions, pts]),
                        colors=None
                        if ps.colors is None
                        else np.concatenate(
                            [
                                ps.colors,
                                cols
                                if cols is not None
                                else np.zeros((len(pts), 3), np.uint8),
                            ]
                        ),
                        reflectances=None
                        if ps.reflectances is None
                        else np.concatenate(
                            [
                                ps.reflectances,
                                np.zeros(len(pts), np.uint16),
                            ]
                        ),
                        # raw/EOM points are exact: never boundary-smoothed
                        types=None
                        if ps.types is None
                        else np.concatenate(
                            [ps.types, np.zeros(len(pts), np.uint8)]
                        ),
                        # raw/EOM points belong to no projected patch
                        partition=None
                        if ps.partition is None
                        else np.concatenate(
                            [ps.partition, np.full(len(pts), -1, np.int32)]
                        ),
                    )
                    clouds[fi] = merged.remove_duplicates()

        # SEI-driven geometry smoothing (PCCDecoder post-processing)
        from ..codec.postprocess import (
            apply_geometry_smoothing,
            find_geometry_smoothing_sei,
        )

        coord_bits = (
            atlas.asps_list[0].asps_geometry_3d_bitdepth_minus1 + 1
            if atlas.asps_list
            else 10
        )
        sei = find_geometry_smoothing_sei(atlas.seis_prefix + atlas.seis_suffix)
        if sei is not None:
            # attributeTransferFilterType: explicit CLI value, or derived
            # from the stream's PTL reconstruction profile like the
            # reference (PCCDecoderParameters.cpp:115-145: Rec1 -> 1, else 0)
            atf = self.params.attributeTransferFilterType
            if atf < 0:
                rec_idc = (
                    context.vps.profile_tier_level
                    .ptl_profile_reconstruction_idc
                )
                atf = 1 if rec_idc == 1 else 0
            with self.timer.stage("smoothPointCloudPostprocess"):
                clouds = apply_geometry_smoothing(
                    clouds, sei, coord_bits,
                    attr_transfer_filter_type=atf,
                )
        from ..codec.postprocess import (
            apply_color_smoothing,
            find_attribute_smoothing_sei,
        )

        csei = find_attribute_smoothing_sei(
            atlas.seis_prefix + atlas.seis_suffix
        )
        if csei is not None:
            with self.timer.stage("colorSmoothing"):
                clouds = apply_color_smoothing(clouds, csei, coord_bits)
        return clouds
