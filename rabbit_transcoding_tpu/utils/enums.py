"""Framework-wide enums.

Semantics follow ISO/IEC 23090-5 (V3C/V-PCC) and the capability set of the
reference (see /root/reference/source/lib/PccLibCommon/include/PCCCommon.h:90-131
and PccLibBitstreamCommon/include/PCCBitstreamCommon.h:79-131 for the concepts
covered; this is a fresh enumeration, not a copy).
"""

from __future__ import annotations

import enum


class CodecId(enum.IntEnum):
    """Video codec backends selectable through the virtual codec factory.

    The reference exposes JM/HM/SHM/VTM app+lib backends plus FFMPEG.  Here
    the primary backend is RBV — our own block codec (JAX device transforms
    + host entropy coding).  External app backends are
    supported when the corresponding binary exists on the host.
    """

    RBV = 0          # rabbit-video device codec (default)
    RBV_LOSSLESS = 1 # RBV forced lossless (occupancy)
    HM_APP = 2       # external TAppEncoder/TAppDecoder if present on host
    FFMPEG_APP = 3   # external ffmpeg binary if present on host
    JM_APP = 4       # external lencod/ldecod (AVC) if present on host
    SHM_APP = 5      # external SHM TAppEncoder/TAppDecoder (SHVC)
    VTM_APP = 6      # external EncoderApp/DecoderApp (VVC)
    UNKNOWN = 255


class ColorFormat(enum.IntEnum):
    YUV400 = 0
    YUV420 = 1
    YUV444 = 2
    RGB444 = 3


class PointType(enum.IntEnum):
    UNSET = 0
    D0 = 1
    D1 = 2
    SMOOTH = 3
    EOM = 4
    RAW = 5


class V3CUnitType(enum.IntEnum):
    """vuh_unit_type (23090-5 table 4)."""

    V3C_VPS = 0   # parameter set
    V3C_AD = 1    # atlas data
    V3C_OVD = 2   # occupancy video data
    V3C_GVD = 3   # geometry video data
    V3C_AVD = 4   # attribute video data


class VideoType(enum.IntEnum):
    """Which video plane a sub-bitstream carries (our internal tagging)."""

    OCCUPANCY = 0
    GEOMETRY = 1
    GEOMETRY_D0 = 2
    GEOMETRY_D1 = 3
    GEOMETRY_RAW = 4
    ATTRIBUTE = 5
    ATTRIBUTE_RAW = 6
    ATTRIBUTE_REFL = 7
    ATTRIBUTE_T0 = 8
    ATTRIBUTE_T1 = 9


class NalUnitType(enum.IntEnum):
    """Atlas NAL unit types — numbering matches 23090-5 table 5 exactly
    (reference PCCBitstreamCommon.h:264-330; cross-checked by the
    reference-parser gate, tests/test_ref_bitstream_gate.py)."""

    NAL_TRAIL_N = 0
    NAL_TRAIL_R = 1
    NAL_TSA_N = 2
    NAL_TSA_R = 3
    NAL_STSA_N = 4
    NAL_STSA_R = 5
    NAL_RADL_N = 6
    NAL_RADL_R = 7
    NAL_RASL_N = 8
    NAL_RASL_R = 9
    NAL_SKIP_N = 10
    NAL_SKIP_R = 11
    NAL_BLA_W_LP = 16
    NAL_BLA_W_RADL = 17
    NAL_BLA_N_LP = 18
    NAL_GBLA_W_LP = 19
    NAL_GBLA_W_RADL = 20
    NAL_GBLA_N_LP = 21
    NAL_IDR_W_RADL = 22
    NAL_IDR_N_LP = 23
    NAL_GIDR_W_RADL = 24
    NAL_GIDR_N_LP = 25
    NAL_CRA = 26
    NAL_GCRA = 27
    NAL_RSV_IRAP_ACL_28 = 28
    NAL_RSV_IRAP_ACL_29 = 29
    NAL_ASPS = 36
    NAL_AFPS = 37
    NAL_AUD = 38
    NAL_V3C_AUD = 39
    NAL_EOS = 40
    NAL_EOB = 41
    NAL_FD = 42
    NAL_PREFIX_NSEI = 43
    NAL_SUFFIX_NSEI = 44
    NAL_PREFIX_ESEI = 45
    NAL_SUFFIX_ESEI = 46
    NAL_AAPS = 47


class AtlasTileType(enum.IntEnum):
    """ath_type."""

    P_TILE = 0
    I_TILE = 1
    SKIP_TILE = 2


class PatchModeITile(enum.IntEnum):
    """atdu_patch_mode for I tiles (23090-5 table 10)."""

    I_INTRA = 0
    I_RAW = 1
    I_EOM = 2
    I_END = 14


class PatchModePTile(enum.IntEnum):
    """atdu_patch_mode for P tiles."""

    P_SKIP = 0
    P_MERGE = 1
    P_INTER = 2
    P_INTRA = 3
    P_RAW = 4
    P_EOM = 5
    P_END = 14


class PatchType(enum.IntEnum):
    """Decoded patch categories."""

    INTRA = 0
    INTER = 1
    MERGE = 2
    SKIP = 3
    RAW = 4
    EOM = 5
    END = 6


class PatchOrientation(enum.IntEnum):
    """Patch placement orientations in the atlas (23090-5 pdu_orientation_index).

    Mapping patch coords (u, v) -> canvas coords (x, y), with (u0,v0) the
    patch origin in the canvas and (w, h) = patch size in patch coords:

      DEFAULT : x = u0 + u            , y = v0 + v
      SWAP    : x = u0 + v            , y = v0 + u
      ROT90   : x = u0 + (h - 1 - v)  , y = v0 + u
      ROT180  : x = u0 + (w - 1 - u)  , y = v0 + (h - 1 - v)
      ROT270  : x = u0 + v            , y = v0 + (w - 1 - u)
      MIRROR  : x = u0 + (w - 1 - u)  , y = v0 + v
      MROT90  : x = u0 + (h - 1 - v)  , y = v0 + (w - 1 - u)
      MROT180 : x = u0 + u            , y = v0 + (h - 1 - v)
    """

    DEFAULT = 0
    SWAP = 1
    ROT90 = 2
    ROT180 = 3
    ROT270 = 4
    MIRROR = 5
    MROT90 = 6
    MROT180 = 7


class SeiPayloadType(enum.IntEnum):
    """SEI payload types (23090-5 annex F, subset in active use + room to grow)."""

    BUFFERING_PERIOD = 0
    ATLAS_FRAME_TIMING = 1
    FILLER_PAYLOAD = 2
    USER_DATA_REGISTERED_ITUTT35 = 3
    USER_DATA_UNREGISTERED = 4
    RECOVERY_POINT = 5
    NO_RECONSTRUCTION = 6
    TIME_CODE = 7
    SEI_MANIFEST = 8
    SEI_PREFIX_INDICATION = 9
    ACTIVE_SUB_BITSTREAMS = 10
    COMPONENT_CODEC_MAPPING = 11
    SCENE_OBJECT_INFORMATION = 12
    OBJECT_LABEL_INFORMATION = 13
    PATCH_INFORMATION = 14
    VOLUMETRIC_RECTANGLE_INFORMATION = 15
    ATLAS_OBJECT_INFORMATION = 16
    VIEWPORT_CAMERA_PARAMETERS = 17
    VIEWPORT_POSITION = 18
    DECODED_ATLAS_INFORMATION_HASH = 19
    ATTRIBUTE_TRANSFORMATION_PARAMS = 64
    OCCUPANCY_SYNTHESIS = 65
    GEOMETRY_SMOOTHING = 66
    ATTRIBUTE_SMOOTHING = 67
    RESERVED = 127


# --- V-PCC projection constants -------------------------------------------

# axes triples (normal, tangent, bitangent) for the 6 canonical projection
# planes, indexed by pdu_projection_id % 6 for the basic 6-direction mode.
PROJECTION_AXES = (
    (0, 2, 1),  # project onto X: normal=X, tangent=Z, bitangent=Y
    (1, 2, 0),  # project onto Y
    (2, 0, 1),  # project onto Z
    (0, 2, 1),  # -X (same axes, projectionMode=1)
    (1, 2, 0),  # -Y
    (2, 0, 1),  # -Z
)
