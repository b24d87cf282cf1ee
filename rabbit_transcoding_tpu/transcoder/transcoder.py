"""The RABBIT live V3C transcoder — the core capability of the reference.

Capability parity with PCCTranscoder (/root/reference/source/lib/
PccLibTranscoder/source/PCCTranscoder.cpp:66-517): take a decoded Context
(HLS + video sub-bitstreams), re-encode each video component at new rate
points **without re-running segmentation/packing**, optionally downscale the
occupancy map, refresh the hash SEI, and leave all other atlas metadata
intact for remux.

Device re-design of the hot loop (transcodeVideo :374):
 * 'reencode' mode — decode->re-encode entirely on device (the reference's
   fast path, minus libav: RBV transforms are batched matmuls over the
   whole GOF).  Drift-free.
 * 'requant'  mode — DCT-domain requantisation (video/rbv.requantize): one
   element-wise device pass over the coefficient tensors; no pixel-domain
   round trip at all.  Only possible because the video codec is ours.
 * occupancy — max-pool downscale on device (resize_frame2 analog :594).
"""

from __future__ import annotations

from ..bitstream.hls import Context
from ..bitstream.sei import SeiDecodedAtlasInformationHash
from ..bitstream.video_bitstream import VideoBitstream
from ..codec.hash import create_hash_sei
from ..codec.patch_frame import decode_patch_frames
from ..core.image import Video
from ..ops.occupancy import downscale_maxpool
from ..utils.enums import CodecId, ColorFormat, VideoType
from ..utils.timing import StageTimer
from ..video import VideoDecoder, VideoEncoder, VideoEncoderParams
from ..video import rbv
from .params import TranscoderParameters

import jax.numpy as jnp
import numpy as np


class Transcoder:
    def __init__(self, params: TranscoderParameters | None = None):
        self.params = params or TranscoderParameters()
        self.timer = StageTimer()
        self._rc_cache: dict[str, tuple[int, int]] = {}
        self._ctx: Context | None = None  # set per transcode() call

    # ------------------------------------------------------------------
    def _keep_intermediate(self, atlas, stage: str) -> None:
        """keepIntermediateFiles (PCCTranscoder analog): dump each video
        sub-stream payload before/after transcoding for debugging."""
        if not self.params.keepIntermediateFiles:
            return
        base = self.params.test_name or "transcode"
        for vtype, vb in atlas.video_bitstreams.items():
            path = f"{base}_{stage}_{vtype.name.lower()}_atlas{atlas.atlas_id}.bin"
            with open(path, "wb") as f:
                f.write(vb.data)

    def transcode(self, context: Context, atlas_id: int = 0) -> Context:
        """Transcode one GOF's atlas in place (PCCTranscoder::transcode)."""
        p = self.params
        atlas = context.atlas(atlas_id)
        # stream signalling for foreign-codec family derivation (resolve())
        self._ctx = context
        self._keep_intermediate(atlas, "in")

        # lossless inputs re-encode through a background-filled pixel path;
        # grab the exact (pre-downscale) occupancy mask for the fill anchors
        occ_mask = None
        if any(
            (vb := atlas.video_bitstreams.get(t)) is not None
            and vb.data.startswith(b"RBV")
            and rbv.probe(vb.data)["lossless"]
            for t in (VideoType.GEOMETRY, VideoType.ATTRIBUTE,
                      VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1,
                      VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1)
        ) or any(
            vb.data.startswith(b"RBV") and rbv.probe(vb.data)["lossless"]
            for vb in atlas.attr_ext.values()
        ):
            occ_mask = self._decode_occupancy_mask(atlas)

        with self.timer.stage("transcodeOccupancy"):
            self._transcode_occupancy(atlas)
        # predicted map coding (vps_map_absolute_coding_enabled_flag[1]
        # clear): the map-1 delta stream is bound to the RECONSTRUCTED
        # map 0 — requantising it independently while changing rec0
        # injects the full rec0 error into map 1, so the pair transcodes
        # JOINTLY (rebuild absolute map 1, re-encode map 0, re-derive
        # the delta against the NEW rec0) in BOTH rate modes
        map1_abs = context.map1_absolute()
        if p.rate_mode == "abr" and p.targetBitrateMbps > 0:
            # ABR: the chosen probe payload IS the output (requant domain);
            # partition/extra attribute streams participate in the
            # attribute family's budget search and reflectance follows the
            # chosen QP (lossless reflectance passes through)
            with self.timer.stage("rateControl"):
                _, abr_attr_qp = self._rate_control(
                    atlas, occ_mask=occ_mask, map1_abs=map1_abs
                )
                self._transcode_reflectance(atlas, abr_attr_qp, occ_mask)
        else:
            with self.timer.stage("transcodeGeometry"):
                if not map1_abs and self._has_rbv_pair(
                    atlas, VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1
                ):
                    self._transcode_map_pair(
                        atlas, VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1,
                        p.effective_geometry_qp(), component="geo",
                        occ_mask=occ_mask,
                    )
                else:
                    for vt in (VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
                               VideoType.GEOMETRY_D1):
                        self._transcode_video(
                            atlas, vt, p.effective_geometry_qp(),
                            occ_mask=occ_mask,
                        )
            with self.timer.stage("transcodeAttribute"):
                if not map1_abs and self._has_rbv_pair(
                    atlas, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1
                ):
                    self._transcode_map_pair(
                        atlas, VideoType.ATTRIBUTE_T0,
                        VideoType.ATTRIBUTE_T1,
                        p.effective_attribute_qp(), component="attr",
                        occ_mask=occ_mask,
                    )
                else:
                    for vt in (VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0,
                               VideoType.ATTRIBUTE_T1):
                        self._transcode_video(
                            atlas, vt, p.effective_attribute_qp(),
                            occ_mask=occ_mask,
                        )
                self._transcode_attr_ext(
                    atlas, p.effective_attribute_qp(), occ_mask
                )
                self._transcode_reflectance(
                    atlas, p.effective_attribute_qp(), occ_mask
                )

        if p.computeHashSei:
            with self.timer.stage("createHashSEI"):
                self._refresh_hash_sei(atlas)
        self._keep_intermediate(atlas, "out")
        return context

    # ------------------------------------------------------------------
    def _transcode_occupancy(self, atlas) -> None:
        """Occupancy is lossless; only its precision (video resolution) can
        change.  Downscale by max-pool when the target precision is coarser
        (PCCTranscoder::resize_frame2 analog)."""
        p = self.params
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        if vb is None or p.occupancyPrecision <= 0:
            return
        if not vb.data.startswith(b"RBV"):
            self._transcode_occupancy_foreign(atlas, vb)
            return
        info = rbv.probe(vb.data)
        # incoming precision is implicit: atlas width / occupancy video width
        asps = atlas.asps_list[0]
        cur_precision = max(1, asps.asps_frame_width // info["width"])
        if p.occupancyPrecision == cur_precision:
            return
        if p.occupancyPrecision < cur_precision:
            raise ValueError(
                f"cannot upscale occupancy precision {cur_precision} -> "
                f"{p.occupancyPrecision}"
            )
        factor = p.occupancyPrecision // cur_precision
        video = VideoDecoder.create(CodecId.RBV).decode(vb.data)
        small = np.asarray(
            downscale_maxpool(jnp.asarray(video.planes[0]), factor)
        )
        out_video = Video(
            video.width // factor, video.height // factor, video.bitdepth,
            ColorFormat.YUV400, [small],
        )
        payload, _ = VideoEncoder.create(CodecId.RBV_LOSSLESS).encode(
            out_video, VideoEncoderParams(lossless=True)
        )
        atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, payload))

    def _transcode_occupancy_foreign(self, atlas, vb) -> None:
        """Foreign (Annex-B) occupancy: decode through the external codec,
        max-pool to the coarser target precision, re-encode at
        occupancyMapQP (PCCTranscoder::transcodeBaseline occupancy leg,
        PCCTranscoder.cpp:180-232 with resizeOccupancyMap :341-372).
        Passthrough when no external codec is configured."""
        from . import foreign

        p = self.params
        if not foreign.is_annexb(vb.data):
            raise ValueError(
                "unrecognized OCCUPANCY video payload (not RBV, not Annex-B)"
            )
        codec = foreign.resolve(
            p, VideoType.OCCUPANCY, getattr(self, "_ctx", None), atlas,
            vb.data,
        )
        if codec is None or not atlas.asps_list:
            return  # pass through untouched
        asps = atlas.asps_list[0]
        video = codec.decode(vb.data)
        # like the reference, the incoming precision is implicit in the
        # decoded video resolution (PCCTranscoder.cpp:206)
        cur_precision = max(1, asps.asps_frame_width // video.width)
        if p.occupancyPrecision < cur_precision:
            raise ValueError(
                f"cannot upscale occupancy precision {cur_precision} -> "
                f"{p.occupancyPrecision}"
            )
        factor = p.occupancyPrecision // cur_precision
        if factor * cur_precision != p.occupancyPrecision:
            import sys

            print(
                f"warning: occupancyPrecision {p.occupancyPrecision} is not "
                f"a multiple of the stream's precision {cur_precision}; "
                f"using {factor * cur_precision}",
                file=sys.stderr,
            )
        if factor > 1:
            video = Video(
                video.width // factor, video.height // factor,
                video.bitdepth, video.format,
                [
                    np.asarray(downscale_maxpool(jnp.asarray(pl), factor))
                    for pl in video.planes
                ],
            )
        payload = codec.encode(video, p.occupancyMapQP)
        atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, payload))

    # ------------------------------------------------------------------
    def _decode_occupancy_mask(self, atlas) -> np.ndarray | None:
        """(F, H, W) uint8 atlas-resolution occupancy, upsampled from the
        current occupancy video (fill anchors for lossless re-encode)."""
        vb = atlas.video_bitstreams.get(VideoType.OCCUPANCY)
        if vb is None or not vb.data.startswith(b"RBV") or not atlas.asps_list:
            return None
        from ..ops.occupancy import upsample_nearest

        video = VideoDecoder.create(CodecId.RBV).decode(vb.data)
        asps = atlas.asps_list[0]
        factor = max(1, asps.asps_frame_width // video.width)
        occ = (np.asarray(video.planes[0]) > 0).astype(np.uint8)
        if factor > 1:
            occ = np.asarray(upsample_nearest(jnp.asarray(occ), factor))
        return occ[:, : asps.asps_frame_height, : asps.asps_frame_width]

    def _fill_video(
        self, video: Video, occ_mask: np.ndarray, map_count: int
    ) -> tuple[Video, bool]:
        """Occupancy-anchored push-pull background fill of a decoded video
        (the reference's dilate-before-encode, PCCVideoEncoder.cpp:282).
        -> (filled video, per_map_stream)."""
        from ..ops.dilate import pad_pow2, push_pull_fill
        from ..ops.occupancy import downscale_maxpool

        per_map_stream = video.frame_count == occ_mask.shape[0]
        if per_map_stream:
            occ_rep = occ_mask  # per-map sub-stream: one frame per source
        else:
            occ_rep = np.repeat(
                occ_mask, map_count, axis=0
            )[: video.frame_count]
        maxval = (1 << video.bitdepth) - 1
        planes = []
        for pl in video.planes:
            pl = np.asarray(pl)
            mask = occ_rep
            if pl.shape[1:] != occ_rep.shape[1:]:
                # chroma subsampled plane: pool the mask down
                fy = occ_rep.shape[1] // pl.shape[1]
                mask = np.asarray(downscale_maxpool(
                    jnp.asarray(occ_rep), fy
                ))
            mask = mask[:, : pl.shape[1], : pl.shape[2]]
            gpad, opad, (oh, ow) = pad_pow2(pl.astype(np.float32), mask)
            filled = np.asarray(
                push_pull_fill(jnp.asarray(gpad), jnp.asarray(opad))
            )[:, :oh, :ow]
            planes.append(
                np.clip(np.round(filled), 0, maxval).astype(pl.dtype)
            )
        return (
            Video(video.width, video.height, video.bitdepth, video.format,
                  planes),
            per_map_stream,
        )

    def _map_count(self, atlas) -> int:
        return (
            atlas.asps_list[0].asps_map_count_minus1 + 1
            if atlas.asps_list
            else 1
        )

    def _reencode_lossless_filled(
        self, atlas, vb, qp: int, occ_mask: np.ndarray | None
    ) -> bytes:
        """Lossless video input -> lossy at `qp` with occupancy-anchored
        background fill first: unfilled lossless planes ring hard at patch
        borders and waste bits on background edges."""
        p = self.params
        if occ_mask is None:
            return rbv._reencode_lossless(vb.data, qp, None, 6)
        video = VideoDecoder.create(CodecId.RBV).decode(vb.data)
        out_video, per_map_stream = self._fill_video(
            video, occ_mask, self._map_count(atlas)
        )
        # per-map sub-streams are NOT map-interleaved: no map factor
        gop = max(
            1,
            (1 if per_map_stream else self._map_count(atlas))
            * (1 if p.allIntra else p.videoGopSize),
        )
        payload, _ = VideoEncoder.create(CodecId.RBV).encode(
            out_video, VideoEncoderParams(qp=qp, gop_size=gop)
        )
        return payload

    def _has_rbv_pair(self, atlas, t0: VideoType, t1: VideoType) -> bool:
        vb0 = atlas.video_bitstreams.get(t0)
        vb1 = atlas.video_bitstreams.get(t1)
        return (
            vb0 is not None and vb1 is not None
            and vb0.data.startswith(b"RBV") and vb1.data.startswith(b"RBV")
        )

    def _prepare_map_pair(
        self, atlas, t0: VideoType, t1: VideoType, component: str,
        occ_mask: np.ndarray | None = None,
    ):
        """The QP-invariant prefix of a predicted-map-pair transcode: decode
        both maps, rebuild the absolute map 1 from (delta, rec0_old), and
        (for lossless inputs) the occupancy-anchored fill.  Hoisted out of
        the per-QP encode so ABR's bisection probes pay it once."""
        from ..codec.mapstream import attr_bias, combine_map1, geo_bias

        data0 = atlas.video_bitstreams[t0].data
        data1 = atlas.video_bitstreams[t1].data
        info0 = rbv.probe(data0)
        use_motion = bool(info0["motion"])  # preserve the input's MC choice
        v0 = VideoDecoder.create(CodecId.RBV).decode(data0)
        v1 = VideoDecoder.create(CodecId.RBV).decode(data1)
        bias = (
            geo_bias(v0.bitdepth) if component == "geo"
            else attr_bias(v0.bitdepth)
        )
        maxv = (1 << v0.bitdepth) - 1
        abs1 = [
            combine_map1(np.asarray(d), np.asarray(r0), bias, maxv)
            for d, r0 in zip(v1.planes, v0.planes)
        ]
        if info0["lossless"] and occ_mask is not None:
            # fill the exact planes so the lossy re-encode doesn't ring at
            # patch borders; the delta backgrounds then flatten to ~bias
            v0, _ = self._fill_video(v0, occ_mask, self._map_count(atlas))
            abs1_v, _ = self._fill_video(
                Video(v1.width, v1.height, v1.bitdepth, v1.format, abs1),
                occ_mask, self._map_count(atlas),
            )
            abs1 = [np.asarray(pl) for pl in abs1_v.planes]
        return (v0, v1, abs1, bias, maxv, use_motion)

    def _make_map_pair_payloads(
        self, atlas, t0: VideoType, t1: VideoType, qp: int, component: str,
        occ_mask: np.ndarray | None = None, prepared=None,
    ) -> tuple[bytes, bytes]:
        """Joint transcode of a predicted map pair: re-encode map 0 at the
        new QP, then re-derive and encode the delta against the NEW rec0 —
        closed-loop-consistent with the encoder/decoder delta semantics."""
        from ..codec.mapstream import make_delta

        p = self.params
        if prepared is None:
            prepared = self._prepare_map_pair(
                atlas, t0, t1, component, occ_mask=occ_mask
            )
        v0, v1, abs1, bias, maxv, use_motion = prepared
        gop = max(1, 1 if p.allIntra else p.videoGopSize)
        vep = VideoEncoderParams(
            qp=qp, gop_size=gop,
            motion=use_motion and gop > 1,
            coeff_threshold=(p.geometryCoeffThreshold
                             if component == "geo" else 0),
            intra=(p.geometryIntraPrediction if component == "geo"
                   else p.attributeIntraPrediction) and gop <= 4,
        )
        payload0, rec0_new = VideoEncoder.create(CodecId.RBV).encode(v0, vep)
        delta_new = [
            make_delta(a1, np.asarray(r0), bias, maxv)
            for a1, r0 in zip(abs1, rec0_new.planes)
        ]
        payload1, _ = VideoEncoder.create(CodecId.RBV).encode(
            Video(v1.width, v1.height, v1.bitdepth, v1.format, delta_new),
            vep,
        )
        return payload0, payload1

    def _transcode_map_pair(
        self, atlas, t0: VideoType, t1: VideoType, qp: int, component: str,
        occ_mask: np.ndarray | None = None,
    ) -> None:
        payload0, payload1 = self._make_map_pair_payloads(
            atlas, t0, t1, qp, component, occ_mask=occ_mask
        )
        atlas.set_video_bitstream(VideoBitstream(t0, payload0))
        atlas.set_video_bitstream(VideoBitstream(t1, payload1))

    def _transcode_video(
        self, atlas, vtype: VideoType, qp: int,
        occ_mask: np.ndarray | None = None,
    ) -> None:
        vb = atlas.video_bitstreams.get(vtype)
        if vb is None:
            return
        payload = self._transcode_payload_any(
            atlas, vtype, vb, qp, occ_mask=occ_mask
        )
        if payload is not None:
            atlas.set_video_bitstream(VideoBitstream(vtype, payload))

    def _transcode_payload_any(
        self, atlas, vtype: VideoType, vb, qp: int,
        occ_mask: np.ndarray | None = None,
    ) -> bytes | None:
        """One sub-stream payload -> transcoded payload, or None for
        passthrough (used for both the standard VideoType slots and the
        attr_ext partition/extra-attribute streams)."""
        p = self.params
        if not vb.data.startswith(b"RBV"):
            # Foreign (HEVC/AVC Annex-B) video payload.  Three routes, in
            # order:  (1) SHVC spatial-layer transcode — drop enhancement-
            # layer NALs above the target layer, a conforming lower-rate/
            # -resolution sub-bitstream with no pixel re-encode (the
            # reference's shvcLayerIndex path over PccShvcParser);
            # (2) the baseline decode->re-encode route through external
            # codec binaries when one is configured (PCCTranscoder::
            # transcodeBaseline analog, transcoder/foreign.py);
            # (3) untouched passthrough.  Payloads that are neither RBV nor
            # Annex-B are corrupt: raise, so the stream driver's failure
            # containment sees the error.
            from . import foreign

            if not foreign.is_annexb(vb.data):
                raise ValueError(
                    f"unrecognized {vtype.name} video payload "
                    f"(not RBV, not Annex-B)"
                )
            from ..video.hevc_probe import filter_hevc_layers, hevc_layer_ids

            if p.shvcLayerIndex >= 0 and len(hevc_layer_ids(vb.data)) > 1:
                return filter_hevc_layers(vb.data, p.shvcLayerIndex)
            codec = foreign.resolve(
                p, vtype, getattr(self, "_ctx", None), atlas, vb.data
            )
            if codec is not None:
                asps = atlas.asps_list[0] if atlas.asps_list else None
                video = codec.decode(
                    vb.data,
                    fallback_width=asps.asps_frame_width if asps else 0,
                    fallback_height=asps.asps_frame_height if asps else 0,
                )
                return codec.encode(video, foreign.foreign_qp(p, vtype))
            return None
        info = rbv.probe(vb.data)
        if info["lossless"]:
            return self._reencode_lossless_filled(atlas, vb, qp, occ_mask)
        if (p.effective_mode(qp, motion=info["motion"]) == "requant"
                and not p.transcodeBaseline):
            return rbv.requantize(vb.data, qp)
        # fused device decode->re-encode: pixels never cross the host link
        geo_types = {VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
                     VideoType.GEOMETRY_D1}
        return rbv.transcode_payload(
            vb.data, qp,
            new_gop=1 if p.allIntra else p.videoGopSize,
            coeff_threshold=(p.geometryCoeffThreshold
                             if vtype in geo_types else 0),
        )

    def _transcode_attr_ext(
        self, atlas, qp: int, occ_mask: np.ndarray | None = None
    ) -> None:
        """Dimension-partitioned / extra attribute AVD sub-streams transcode
        at the attribute QP like the primary stream (the reference
        re-encodes every attribute partition video; routing per
        PCCDecoder.cpp:208-300)."""
        for key, vb in list(atlas.attr_ext.items()):
            payload = self._transcode_payload_any(
                atlas, VideoType.ATTRIBUTE, vb, qp, occ_mask=occ_mask
            )
            if payload is not None:
                atlas.attr_ext[key] = VideoBitstream(
                    VideoType.ATTRIBUTE, payload
                )

    def _transcode_reflectance(
        self, atlas, qp: int, occ_mask: np.ndarray | None = None
    ) -> None:
        """Reflectance (attribute index 1).  Our encoder codes it lossless;
        a lossless reflectance stream passes through untouched (quantising
        reflectance values would change attribute semantics, and it is a
        negligible share of the rate).  A lossy-coded reflectance stream
        requantises like any attribute video."""
        vb = atlas.video_bitstreams.get(VideoType.ATTRIBUTE_REFL)
        if vb is None:
            return
        if vb.data.startswith(b"RBV") and rbv.probe(vb.data)["lossless"]:
            return
        payload = self._transcode_payload_any(
            atlas, VideoType.ATTRIBUTE_REFL, vb, qp, occ_mask=occ_mask
        )
        if payload is not None:
            atlas.set_video_bitstream(
                VideoBitstream(VideoType.ATTRIBUTE_REFL, payload)
            )

    # ------------------------------------------------------------------
    def _rate_control(
        self, atlas, occ_mask=None, map1_abs: bool = True
    ) -> tuple[int, int]:
        """rate_mode='abr': pick (geometry QP, attribute QP) hitting the
        target bitrate and install the winning payloads directly (the probes
        ARE DCT-domain requantisations — the cheapest transcode there is, so
        search and transcode are one operation).  Chosen QPs are cached
        across GOFs and re-searched only when the produced size drifts >20%
        from target.  Per-map sub-streams (multipleStreams inputs) split
        their component's budget by input-size share; lossless inputs probe
        through the occupancy-anchored filled re-encode."""
        p = self.params

        map_count = (
            atlas.asps_list[0].asps_map_count_minus1 + 1
            if atlas.asps_list
            else 1
        )
        interleaved = {VideoType.GEOMETRY, VideoType.ATTRIBUTE}

        def collect(types):
            out = []
            for t in types:
                vb = atlas.video_bitstreams.get(t)
                if vb is not None and vb.data.startswith(b"RBV"):
                    out.append((t, vb))
            return out

        geo_vbs = collect((VideoType.GEOMETRY, VideoType.GEOMETRY_D0,
                           VideoType.GEOMETRY_D1))
        attr_vbs = collect((VideoType.ATTRIBUTE, VideoType.ATTRIBUTE_T0,
                            VideoType.ATTRIBUTE_T1))
        # dimension-partition / extra-attribute sub-streams share the
        # attribute family budget (keys are the (attr, partition, map)
        # vuh triple; search installs back into attr_ext)
        attr_vbs += [
            (key, vb) for key, vb in sorted(atlas.attr_ext.items())
            if vb.data.startswith(b"RBV")
        ]
        # predicted map pairs must transcode jointly in ABR too (the delta
        # re-derives against the NEW rec0): pull them out of the
        # independent-search lists
        geo_pair = (not map1_abs) and self._has_rbv_pair(
            atlas, VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1
        )
        attr_pair = (not map1_abs) and self._has_rbv_pair(
            atlas, VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1
        )
        if geo_pair:
            geo_vbs = [x for x in geo_vbs if x[0] == VideoType.GEOMETRY]
        if attr_pair:
            attr_vbs = [
                x for x in attr_vbs
                if x[0] == VideoType.ATTRIBUTE or isinstance(x[0], tuple)
            ]
        if not geo_vbs and not attr_vbs and not geo_pair and not attr_pair:
            return 32, 32  # foreign payloads only: ABR not applicable

        def gof_frames(t, vb) -> int:
            try:
                f = rbv.probe(vb.data)["frame_count"]
                return max(1, f // (map_count if t in interleaved else 1))
            except ValueError:
                return 1

        frame_src = geo_vbs or attr_vbs
        if frame_src:
            frames = gof_frames(*frame_src[0])
        else:
            t0 = (VideoType.GEOMETRY_D0 if geo_pair
                  else VideoType.ATTRIBUTE_T0)
            frames = gof_frames(t0, atlas.video_bitstreams[t0])
        budget = p.targetBitrateMbps * 1e6 / 8.0 * frames / max(
            1e-6, p.frameRate
        )
        geo_budget = budget * p.geometryBitrateShare
        attr_budget = budget - geo_budget

        filled_cache: dict[int, tuple] = {}

        def probe_payload(vb, qp: int) -> bytes:
            if rbv.probe(vb.data)["lossless"]:
                # first quantisation of a lossless input: go through the
                # occupancy-anchored background-fill path, NOT the bare
                # re-encode.  The decode + fill are QP-invariant — do them
                # ONCE per stream and only re-encode per probe
                if occ_mask is None:
                    return rbv._reencode_lossless(vb.data, qp, None, 6)
                key = id(vb)
                if key not in filled_cache:
                    video = VideoDecoder.create(CodecId.RBV).decode(vb.data)
                    filled_cache[key] = self._fill_video(
                        video, occ_mask, map_count
                    )
                video, per_map_stream = filled_cache[key]
                gop = max(
                    1,
                    (1 if per_map_stream else map_count)
                    * (1 if p.allIntra else p.videoGopSize),
                )
                payload, _ = VideoEncoder.create(CodecId.RBV).encode(
                    video, VideoEncoderParams(qp=qp, gop_size=gop)
                )
                return payload
            return rbv.requantize(vb.data, qp)

        def _install_for(t):
            """Payload installer for a family entry: a VideoType goes into
            the standard slot, an (attr, partition, map) tuple back into
            attr_ext."""
            if isinstance(t, tuple):
                def install(payload, key=t):
                    atlas.attr_ext[key] = VideoBitstream(
                        VideoType.ATTRIBUTE, payload
                    )
            else:
                def install(payload, vt=t):
                    atlas.set_video_bitstream(VideoBitstream(vt, payload))
            return install

        def search(vb, install, target_bytes, cache_key) -> tuple[int, int]:
            cached = self._rc_cache.get(cache_key)
            if cached is not None:
                qp, size = cached
                if abs(size - target_bytes) <= 0.2 * target_bytes:
                    payload = probe_payload(vb, qp)
                    install(payload)
                    return qp, len(payload)
            lo, hi = 4, 48
            best = hi
            best_payload = None
            while lo <= hi:
                mid = (lo + hi) // 2
                payload = probe_payload(vb, mid)
                if len(payload) <= target_bytes:
                    best = mid
                    best_payload = payload
                    hi = mid - 1
                else:
                    lo = mid + 1
            if best_payload is None:
                best_payload = probe_payload(vb, best)
            self._rc_cache[cache_key] = (best, len(best_payload))
            install(best_payload)
            return best, len(best_payload)

        def search_family(vbs, family_budget, prefix) -> tuple[int, int]:
            if not vbs:
                return 32, 0
            total_in = sum(len(vb.data) for _, vb in vbs)
            # the family's representative QP is the LARGEST substream's
            # choice (not whichever happened to search last)
            qp_out, best_share = 32, -1.0
            nbytes = 0
            for t, vb in vbs:
                share = len(vb.data) / max(1, total_in)
                name = f"ext{t}" if isinstance(t, tuple) else t.name
                qp, nb = search(
                    vb, _install_for(t), family_budget * share,
                    f"{prefix}:{name}",
                )
                if share > best_share:
                    qp_out, best_share = qp, share
                nbytes += nb
            return qp_out, nbytes

        def search_pair(
            t0, t1, target_bytes, cache_key, component
        ) -> tuple[int, int]:
            # decode + combine + fill are QP-invariant: pay them once for
            # the whole bisection, re-encode per probe
            prepared = self._prepare_map_pair(
                atlas, t0, t1, component, occ_mask=occ_mask
            )

            def make(qp: int) -> tuple[bytes, bytes]:
                return self._make_map_pair_payloads(
                    atlas, t0, t1, qp, component, occ_mask=occ_mask,
                    prepared=prepared,
                )

            def install(pair) -> None:
                atlas.set_video_bitstream(VideoBitstream(t0, pair[0]))
                atlas.set_video_bitstream(VideoBitstream(t1, pair[1]))

            cached = self._rc_cache.get(cache_key)
            if cached is not None:
                qp, size = cached
                if abs(size - target_bytes) <= 0.2 * target_bytes:
                    pair = make(qp)
                    install(pair)
                    return qp, len(pair[0]) + len(pair[1])
            lo, hi = 4, 48
            best = hi
            best_pair = None
            while lo <= hi:
                mid = (lo + hi) // 2
                pair = make(mid)
                if len(pair[0]) + len(pair[1]) <= target_bytes:
                    best, best_pair = mid, pair
                    hi = mid - 1
                else:
                    lo = mid + 1
            if best_pair is None:
                best_pair = make(best)
            self._rc_cache[cache_key] = (
                best, len(best_pair[0]) + len(best_pair[1])
            )
            install(best_pair)
            return best, len(best_pair[0]) + len(best_pair[1])

        def run_geo(fam_budget) -> tuple[int, int]:
            if geo_pair:
                return search_pair(
                    VideoType.GEOMETRY_D0, VideoType.GEOMETRY_D1,
                    fam_budget, "geo:pair", "geo",
                )
            return search_family(geo_vbs, fam_budget, "geo")

        def run_attr(fam_budget) -> tuple[int, int]:
            if attr_pair:
                return search_pair(
                    VideoType.ATTRIBUTE_T0, VideoType.ATTRIBUTE_T1,
                    fam_budget, "attr:pair", "attr",
                )
            return search_family(attr_vbs, fam_budget, "attr")

        geo_qp, geo_bytes = run_geo(geo_budget)
        attr_qp, attr_bytes = run_attr(attr_budget)

        # cross-component reallocation: each family's QP search lands at or
        # below its share, so the joint result typically undershoots the
        # budget by one whole QP step of one component.  Hand the surplus
        # to whichever family is still coded coarser (higher QP = worse
        # quality per our monotone ladder) and re-search just that family —
        # one extra round of cheap requant probes instead of the static
        # geometryBitrateShare split being the final word.
        has_geo = bool(geo_vbs) or geo_pair
        has_attr = bool(attr_vbs) or attr_pair
        surplus = budget - geo_bytes - attr_bytes
        if surplus > 0.05 * budget and has_geo and has_attr:
            if attr_qp >= geo_qp:
                attr_qp, attr_bytes = run_attr(attr_budget + surplus)
            else:
                geo_qp, geo_bytes = run_geo(geo_budget + surplus)
        return geo_qp, attr_qp

    # ------------------------------------------------------------------
    def _refresh_hash_sei(self, atlas) -> None:
        """Replace any decoded-atlas-hash SEI with a freshly computed one
        (PCCTranscoder::createHashSEI analog).  Atlas metadata is untouched
        by transcoding, so the recomputed hash certifies the passthrough."""
        patch_frames = decode_patch_frames(atlas)
        sei = create_hash_sei(atlas, patch_frames)
        atlas.seis_prefix = [
            s
            for s in atlas.seis_prefix
            if not isinstance(s, SeiDecodedAtlasInformationHash)
        ]
        atlas.seis_prefix.append(sei)
