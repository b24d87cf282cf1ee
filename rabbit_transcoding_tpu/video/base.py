"""Virtual video codec factory.

Capability parity with PCCVirtualVideoEncoder/Decoder (/root/reference/source/
lib/PccLibVideoEncoder/include/PCCVirtualVideoEncoder.h:42-76,
PccLibVideoDecoder/include/PCCVirtualVideoDecoder.h:43-55): pipelines request
a codec by ``CodecId`` and get a uniform encode/decode interface.  The
primary backend is RBV (the device codec); external app backends (HM TAppEncoder /
ffmpeg) plug in behind the same interface when their binaries exist on the
host — mirroring the reference's *APP codec modes which shell out
(PCCHMAppVideoEncoder.cpp:60-69).
"""

from __future__ import annotations

import dataclasses
import shutil

from ..core.image import Video
from ..utils.enums import CodecId
from . import rbv


@dataclasses.dataclass
class VideoEncoderParams:
    """Uniform encoder knobs (PCCVideoEncoderParameters analog,
    PCCVirtualVideoEncoder.h:42-64)."""

    qp: int = 32
    input_bitdepth: int = 8
    internal_bitdepth: int = 8
    output_bitdepth: int = 8
    gop_size: int = 2
    all_intra: bool = False
    lossless: bool = False
    block_size: int = 16
    motion: bool = False   # motion-compensated P frames
    # occupancy-aware RDO (usePccRDO analog): optional (F, H, W) weights
    # masking the MC distortion so only patch content drives MV choice
    mc_weight: object = None
    # coefficient-level RDO (RBV): zero +/-1 coefficients at zigzag rank >=
    # this (0 = off); the V-PCC pipelines set it for geometry payloads
    coeff_threshold: int = 0
    # RBV intra prediction (mosaic DC/planar) on I-frames; the V-PCC
    # pipelines set it for geometry payloads (BD-rate A/B in rbv_rd.py)
    intra: bool = False
    # reserved for external backends
    config_path: str = ""
    extra_args: str = ""


# external app backends (PCCCodecId JMAPP/HMAPP/SHMAPP/FFMPEG analog,
# PCCCommon.h:93-116): (default binary name, env override, template names).
# Binary resolution order: RABBIT_<ID>_{ENCODER,DECODER} env var, then PATH.
_EXTERNAL_APPS = {
    CodecId.HM_APP: ("TAppEncoder", "TAppDecoder",
                     "HM_ENCODER_TEMPLATE", "HM_DECODER_TEMPLATE"),
    CodecId.JM_APP: ("lencod", "ldecod",
                     "JM_ENCODER_TEMPLATE", "JM_DECODER_TEMPLATE"),
    CodecId.SHM_APP: ("TAppEncoderSHM", "TAppDecoderSHM",
                      "SHM_ENCODER_TEMPLATE", "SHM_DECODER_TEMPLATE"),
    CodecId.VTM_APP: ("EncoderApp", "DecoderApp",
                      "VTM_ENCODER_TEMPLATE", "VTM_DECODER_TEMPLATE"),
}

FFMPEG_ENCODER_TEMPLATE = (
    "{binary} -y -f rawvideo -pix_fmt yuv420p -s {width}x{height}"
    " -i {input} -c:v libx265 -x265-params qp={qp} {output}"
)
FFMPEG_DECODER_TEMPLATE = (
    "{binary} -y -i {input} -f rawvideo -pix_fmt yuv420p {output}"
)


def _resolve_binary(
    codec_id: CodecId, name: str, role: str, explicit: str = ""
) -> str:
    import os

    if explicit:
        return explicit
    env = os.environ.get(f"RABBIT_{codec_id.name}_{role}")
    binary = env or shutil.which(name)
    if binary is None:
        raise RuntimeError(
            f"codec {codec_id.name} requested but no {name} binary on PATH "
            f"(set RABBIT_{codec_id.name}_{role} to override)"
        )
    return binary


# ---------------------------------------------------------------------------
# Per-component codec selection (PCCEncoderParameters
# videoEncoder{Occupancy,Geometry,Attribute}CodecId/Path +
# occupancyMapConfig/geometryConfig/... cfg corpus,
# PccAppEncoder.cpp:298-556)
# ---------------------------------------------------------------------------
_ROLE_COMP = {
    "occupancy": "Occupancy",
    "geometry": "Geometry",
    "geometryMP": "Geometry",   # raw-points aux video rides the geometry codec
    "geometry0": "Geometry",    # per-map sub-streams (multipleStreams)
    "geometry1": "Geometry",
    "attribute": "Attribute",
    "attributeMP": "Attribute",
    "attribute0": "Attribute",
    "attribute1": "Attribute",
}
_ROLE_CFG = {
    "occupancy": "occupancyMapConfig",
    "geometry": "geometryConfig",
    "geometryMP": "geometryMPConfig",
    # per-map cfgs (geometry0Config/... PccAppEncoder option names); empty
    # values fall back to the single-stream cfg in component_encoder
    "geometry0": "geometry0Config",
    "geometry1": "geometry1Config",
    "attribute": "attributeConfig",
    "attributeMP": "attributeMPConfig",
    "attribute0": "attribute0Config",
    "attribute1": "attribute1Config",
}
# per-map cfg fallback when the map-specific option is unset
_ROLE_CFG_FALLBACK = {
    "geometry0": "geometryConfig",
    "geometry1": "geometryConfig",
    "attribute0": "attributeConfig",
    "attribute1": "attributeConfig",
}
# cfg-file flag of each external encoder CLI (HM-family -c; JM lencod -d)
_CONFIG_FLAG = {CodecId.JM_APP: "-d"}


def component_codec_id(params, comp: str) -> CodecId:
    """The codec selected for a component ('Occupancy'/'Geometry'/
    'Attribute') by the videoEncoder<Comp>CodecId option; RBV when unset."""
    name = getattr(params, f"videoEncoder{comp}CodecId", "RBV") or "RBV"
    try:
        return CodecId[name]
    except KeyError:
        raise ValueError(
            f"videoEncoder{comp}CodecId={name!r} is not a codec id (expected "
            f"RBV / HM_APP / JM_APP / SHM_APP / VTM_APP / FFMPEG_APP)"
        ) from None


def component_encoder(params, role: str, lossless: bool = False) -> "VideoEncoder":
    """An encoder for one video role ('occupancy', 'geometry', 'geometryMP',
    'attribute', 'attributeMP') honoring the per-component codec selection.

    RBV (default) keeps the device codec path; external codecs shell out via
    the app wrappers with the role's cfg file attached (the reference routes
    PCCVideoEncoder::compress through PCCVirtualVideoEncoder the same way,
    PCCVideoEncoder.cpp:282)."""
    comp = _ROLE_COMP[role]
    codec_id = component_codec_id(params, comp)
    if codec_id in (CodecId.RBV, CodecId.RBV_LOSSLESS):
        force = lossless or codec_id == CodecId.RBV_LOSSLESS
        return VideoEncoder.create(
            CodecId.RBV_LOSSLESS if force else CodecId.RBV
        )
    from .external import ExternalVideoEncoder

    explicit = getattr(params, f"videoEncoder{comp}Path", "")
    config = getattr(params, _ROLE_CFG[role], "") or ""
    if not config and role in _ROLE_CFG_FALLBACK:
        config = getattr(params, _ROLE_CFG_FALLBACK[role], "") or ""
    keep = bool(getattr(params, "keepIntermediateFiles", False))
    byte_stream = bool(
        getattr(params, f"byteStreamVideoEncoder{comp}", True)
    )
    if codec_id == CodecId.FFMPEG_APP:
        binary = _resolve_binary(codec_id, "ffmpeg", "ENCODER", explicit)
        # ffmpeg has no HM-style cfg file; options ride the template
        return ExternalVideoEncoder(
            binary, FFMPEG_ENCODER_TEMPLATE, keep_files=keep,
            byte_stream=byte_stream,
        )
    if codec_id not in _EXTERNAL_APPS:
        raise ValueError(f"unsupported encoder codec id {codec_id}")
    from . import external

    name, _, tmpl, _ = _EXTERNAL_APPS[codec_id]
    binary = _resolve_binary(codec_id, name, "ENCODER", explicit)
    return ExternalVideoEncoder(
        binary, getattr(external, tmpl), config_path=config,
        config_flag=_CONFIG_FLAG.get(codec_id, "-c"),
        keep_files=keep, byte_stream=byte_stream,
    )


class VideoEncoder:
    def encode(self, video: Video, params: VideoEncoderParams) -> tuple[bytes, Video]:
        """Returns (payload bytes, reconstructed video as a decoder sees it)."""
        raise NotImplementedError

    @staticmethod
    def create(codec_id: CodecId) -> "VideoEncoder":
        if codec_id in (CodecId.RBV, CodecId.RBV_LOSSLESS):
            return RbvVideoEncoder(force_lossless=codec_id == CodecId.RBV_LOSSLESS)
        if codec_id in _EXTERNAL_APPS:
            from . import external
            from .external import ExternalVideoEncoder

            name, _, tmpl, _ = _EXTERNAL_APPS[codec_id]
            binary = _resolve_binary(codec_id, name, "ENCODER")
            return ExternalVideoEncoder(binary, getattr(external, tmpl))
        if codec_id == CodecId.FFMPEG_APP:
            from .external import ExternalVideoEncoder

            binary = _resolve_binary(codec_id, "ffmpeg", "ENCODER")
            return ExternalVideoEncoder(binary, FFMPEG_ENCODER_TEMPLATE)
        raise ValueError(f"unsupported codec id {codec_id}")


class VideoDecoder:
    def decode(self, payload: bytes, output_bitdepth: int | None = None) -> Video:
        raise NotImplementedError

    @staticmethod
    def create(codec_id: CodecId) -> "VideoDecoder":
        if codec_id in (CodecId.RBV, CodecId.RBV_LOSSLESS):
            return RbvVideoDecoder()
        if codec_id in _EXTERNAL_APPS:
            from . import external
            from .external import ExternalVideoDecoder

            _, name, _, tmpl = _EXTERNAL_APPS[codec_id]
            binary = _resolve_binary(codec_id, name, "DECODER")
            return ExternalVideoDecoder(binary, getattr(external, tmpl))
        if codec_id == CodecId.FFMPEG_APP:
            from .external import ExternalVideoDecoder

            binary = _resolve_binary(codec_id, "ffmpeg", "DECODER")
            return ExternalVideoDecoder(binary, FFMPEG_DECODER_TEMPLATE)
        raise ValueError(f"unsupported codec id {codec_id}")


class RbvVideoEncoder(VideoEncoder):
    def __init__(self, force_lossless: bool = False) -> None:
        self.force_lossless = force_lossless

    def encode(self, video: Video, params: VideoEncoderParams) -> tuple[bytes, Video]:
        rp = rbv.RbvParams(
            qp=params.qp,
            block_size=params.block_size,
            gop_size=1 if params.all_intra else params.gop_size,
            lossless=params.lossless or self.force_lossless,
            motion=params.motion and not params.all_intra,
            mc_weight=params.mc_weight,
            coeff_threshold=params.coeff_threshold,
            intra=params.intra,
        )
        return rbv.encode(video, rp)


class RbvVideoDecoder(VideoDecoder):
    def decode(self, payload: bytes, output_bitdepth: int | None = None) -> Video:
        video = rbv.decode(payload)
        if output_bitdepth is not None and output_bitdepth != video.bitdepth:
            video = video.convert_bitdepth(output_bitdepth)
        return video
