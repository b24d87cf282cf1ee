"""Synthetic test-data generator.

The reference's smoke loops require the 8i VFB v2 dataset on disk; this
module generates a stand-in dynamic point-cloud sequence (a deforming
voxelized sphere with smooth colors) so every pipeline can run end-to-end in
any environment:

    python -m rabbit_transcoding_tpu.testdata --frames 4 --out cloud_%04d.ply
"""

from __future__ import annotations

import argparse

import numpy as np

from .core.pointset import PointSet


def make_frame(
    frame: int = 0,
    n: int = 40000,
    radius: float = 100.0,
    center: float = 128.0,
    seed: int = 7,
    vox_bits: int = 10,
) -> PointSet:
    rng = np.random.default_rng(seed)  # same base sphere; deforms over time
    theta = np.arccos(1 - 2 * rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    # time-varying radial deformation = moving surface detail
    r = radius * (
        1.0
        + 0.08 * np.sin(4 * theta + 0.3 * frame)
        + 0.05 * np.cos(5 * phi - 0.2 * frame)
    )
    x = center + r * np.sin(theta) * np.cos(phi)
    y = center + r * np.sin(theta) * np.sin(phi)
    z = center + r * np.cos(theta)
    maxv = (1 << vox_bits) - 1
    pos = np.clip(np.round(np.stack([x, y, z], 1)), 0, maxv).astype(np.int32)
    colors = np.clip(
        np.stack(
            [
                128 + 90 * np.sin(pos[:, 0] / 12.0 + 0.1 * frame),
                128 + 90 * np.cos(pos[:, 1] / 12.0),
                128 + 60 * np.sin(pos[:, 2] / 8.0),
            ],
            1,
        ),
        0,
        255,
    ).astype(np.uint8)
    return PointSet(positions=pos, colors=colors).remove_duplicates()


def _ellipsoid(
    rng, n: int, center: np.ndarray, radii: np.ndarray,
    yaw: float = 0.0,
) -> np.ndarray:
    theta = np.arccos(1 - 2 * rng.uniform(0, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    p = np.stack(
        [
            radii[0] * np.sin(theta) * np.cos(phi),
            radii[1] * np.sin(theta) * np.sin(phi),
            radii[2] * np.cos(theta),
        ],
        1,
    )
    if yaw:
        c, s = np.cos(yaw), np.sin(yaw)
        p = p @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return p + center


def make_scene_frame(
    frame: int = 0,
    n: int = 40000,
    seed: int = 11,
    vox_bits: int = 10,
) -> PointSet:
    """A textured multi-object scene — the stress content the single smooth
    sphere lacks (round-2 verdict: smooth radial content flatters transform
    codecs).  Three surfaces with mutual self-occlusion/disocclusion as
    seen from the six projection planes:

      * a large static torso ellipsoid with a sharp CHECKERBOARD texture
        (hard color edges every 8 voxels);
      * a rigidly TRANSLATING + rotating small ellipsoid (real motion
        vectors for inter coding) with high-contrast stripes;
      * a static thin slab behind both (gets occluded/disoccluded by the
        moving part) with a two-tone split texture.
    """
    rng = np.random.default_rng(seed)  # same geometry; motion is analytic
    half = int(2 ** (vox_bits - 1))
    n1, n2 = int(n * 0.5), int(n * 0.25)
    n3 = n - n1 - n2
    # surface sizes follow the point budget (~1 point per surface voxel):
    # sparser than that and segmentation rightly dumps points to the raw
    # patch, which would turn the ladder into a raw-coding benchmark
    r1 = float(np.sqrt(n1 / (4 * np.pi)))
    r2 = float(np.sqrt(n2 / (4 * np.pi)))
    torso = _ellipsoid(
        rng, n1, np.array([half, half, half], float),
        np.array([r1, 0.8 * r1, 1.2 * r1]),
    )
    # rigid motion: orbiting + rotating satellite at ~5 voxels/frame so
    # block motion search (+/-6) can actually track it
    orbit = 2.4 * r1
    ang = 5.0 / orbit * frame
    sat_center = np.array([
        half + orbit * np.cos(ang),
        half + orbit * np.sin(ang),
        half + 0.5 * r1,
    ])
    sat = _ellipsoid(
        rng, n2, sat_center,
        np.array([0.8 * r2, 1.1 * r2, 0.8 * r2]),
        yaw=0.05 * frame,
    )
    # thin background slab (a dense jittered grid: a true <=2-voxel-deep
    # surface that the moving satellite occludes/disoccludes)
    side = int(np.floor(np.sqrt(n3)))
    gx, gz = np.meshgrid(np.arange(side), np.arange(side))
    slab = np.stack(
        [
            half - side / 2.0 + gx.reshape(-1)[:n3]
            + rng.uniform(-0.5, 0.5, min(n3, side * side)),
            half + 2.2 * r1 + rng.uniform(0, 2, min(n3, side * side)),
            half - side / 2.0 + gz.reshape(-1)[:n3]
            + rng.uniform(-0.5, 0.5, min(n3, side * side)),
        ],
        1,
    )
    n3 = len(slab)
    pos = np.concatenate([torso, sat, slab])
    maxv = (1 << vox_bits) - 1
    pos = np.clip(np.round(pos), 0, maxv).astype(np.int32)

    # sharp textures (hard edges, no radial smoothness)
    checker = ((pos[:n1, 0] // 8 + pos[:n1, 1] // 8 + pos[:n1, 2] // 8) % 2
               ).astype(np.uint8)
    torso_col = np.where(
        checker[:, None] > 0,
        np.array([[230, 40, 40]], np.uint8),
        np.array([[25, 25, 210]], np.uint8),
    )
    stripes = ((pos[n1 : n1 + n2, 2] // 6) % 2).astype(np.uint8)
    sat_col = np.where(
        stripes[:, None] > 0,
        np.array([[250, 250, 30]], np.uint8),
        np.array([[10, 160, 60]], np.uint8),
    )
    split = (pos[n1 + n2 :, 0] > half).astype(np.uint8)
    slab_col = np.where(
        split[:, None] > 0,
        np.array([[200, 200, 200]], np.uint8),
        np.array([[60, 60, 60]], np.uint8),
    )
    colors = np.concatenate([torso_col, sat_col, slab_col]).astype(np.uint8)
    return PointSet(positions=pos, colors=colors).remove_duplicates()


def make_dense_frame(
    frame: int = 0,
    n: int = 500000,
    seed: int = 13,
    vox_bits: int = 10,
) -> PointSet:
    """Reference-scale content: vox10 density (>=300k points/frame after
    dedupe — the 8i clouds the reference's CTC runs on are ~800k,
    /root/reference/cfg/sequence/longdress_vox10.cfg:5-12).  The blobs
    scene scaled to ~1 point/voxel surface density, plus an ARTICULATED
    swinging limb (hinge rotation — a motion class the orbiting satellite
    doesn't cover: every block has a different motion vector)."""
    base = make_scene_frame(frame, n=int(n * 0.85), seed=seed,
                            vox_bits=vox_bits)
    rng = np.random.default_rng(seed + 1)
    half = int(2 ** (vox_bits - 1))
    n_limb = n - int(n * 0.85)
    # cylinder surface swinging about a hinge near the torso top
    length = 1.6 * float(np.sqrt(n / 8 / (4 * np.pi)))
    radius = max(4.0, length / 6.0)
    t = rng.uniform(0, 1, n_limb)            # along the limb
    a = rng.uniform(0, 2 * np.pi, n_limb)    # around the limb
    swing = 0.6 * np.sin(0.35 * frame)       # hinge angle over time
    c, s = np.cos(swing), np.sin(swing)
    lx = t * length
    ly = radius * np.cos(a)
    lz = radius * np.sin(a)
    limb = np.stack([
        half + 1.2 * length + (c * lx - s * lz),
        half + ly,
        half + 1.0 * length + (s * lx + c * lz),
    ], 1)
    maxv = (1 << vox_bits) - 1
    limb = np.clip(np.round(limb), 0, maxv).astype(np.int32)
    rings = ((limb[:, 0] // 5 + limb[:, 2] // 5) % 2).astype(np.uint8)
    limb_col = np.where(
        rings[:, None] > 0,
        np.array([[240, 120, 20]], np.uint8),
        np.array([[20, 40, 90]], np.uint8),
    )
    return PointSet(
        positions=np.concatenate([base.positions, limb]),
        colors=np.concatenate([base.colors, limb_col]),
    ).remove_duplicates()


SCENES = {
    "sphere": make_frame,
    "blobs": make_scene_frame,
    "dense": make_dense_frame,
}


def make_bench_stream(frames: int, width: int = 1024, height: int = 1024,
                      seed: int = 0) -> bytes:
    """A one-GOF V3C stream with encoder-output statistics: ~30% occupied
    atlas, smooth background-filled geometry (10-bit, RBV QP 16, GOP 2) and
    YUV420 attribute (QP 22, GOP 2), lossless occupancy at precision 2.
    The input of the transcode benchmark and of the on-card smoke test.
    ``width`` and ``height`` are multiples of 64."""
    from scipy.ndimage import zoom

    from .bitstream import V3CWriter, VideoBitstream
    from .bitstream.hls import Context
    from .bitstream.syntax import (
        AtlasFrameParameterSetRbsp,
        AtlasSequenceParameterSetRbsp,
        V3CParameterSet,
    )
    from .core.image import Video
    from .utils.enums import CodecId, ColorFormat, VideoType
    from .video import VideoEncoder, VideoEncoderParams

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    # occupancy: smooth-noise blobs at 64 px granularity, ~30% fill
    occ_precision = 2
    blobs = rng.normal(size=(frames, height // 64, width // 64))
    occ = np.stack(
        [zoom(blobs[f], 64, order=1) > 0.5 for f in range(frames)]
    ).astype(np.uint8)[:, :height, :width]

    # planes are smooth everywhere: encoder output is background-filled
    # (push-pull padding) so unoccupied pixels create no coefficient energy
    geo = np.zeros((frames, height, width), np.uint16)
    attr_y = np.zeros((frames, height, width), np.uint8)
    for f in range(frames):
        g = 300 + 120 * np.sin((xx + 7 * f) / 37.0) * np.cos((yy - 3 * f) / 29.0)
        geo[f] = g.astype(np.uint16)
        a = 128 + 80 * np.sin((xx + 5 * f) / 23.0) + 30 * np.cos(yy / 17.0)
        attr_y[f] = np.clip(a, 0, 255).astype(np.uint8)

    occ_small = occ.reshape(
        frames, height // occ_precision, occ_precision,
        width // occ_precision, occ_precision,
    ).max(axis=(2, 4))

    enc = VideoEncoder.create(CodecId.RBV)
    enc_ll = VideoEncoder.create(CodecId.RBV_LOSSLESS)
    occ_payload, _ = enc_ll.encode(
        Video(width // occ_precision, height // occ_precision, 8,
              ColorFormat.YUV400, [occ_small]),
        VideoEncoderParams(lossless=True),
    )
    geo_payload, _ = enc.encode(
        Video(width, height, 10, ColorFormat.YUV400, [geo]),
        VideoEncoderParams(qp=16, gop_size=2),
    )
    u = np.full((frames, height // 2, width // 2), 128, np.uint8)
    attr_payload, _ = enc.encode(
        Video(width, height, 8, ColorFormat.YUV420, [attr_y, u, u.copy()]),
        VideoEncoderParams(qp=22, gop_size=2),
    )

    context = Context()
    vps = V3CParameterSet()
    vps.atlas(0).vps_frame_width = width
    vps.atlas(0).vps_frame_height = height
    context.vps_list.append(vps)
    atlas = context.atlas(0)
    atlas.asps_list.append(
        AtlasSequenceParameterSetRbsp(asps_frame_width=width,
                                      asps_frame_height=height)
    )
    atlas.afps_list.append(AtlasFrameParameterSetRbsp())
    atlas.set_video_bitstream(VideoBitstream(VideoType.OCCUPANCY, occ_payload))
    atlas.set_video_bitstream(VideoBitstream(VideoType.GEOMETRY, geo_payload))
    atlas.set_video_bitstream(VideoBitstream(VideoType.ATTRIBUTE, attr_payload))
    writer = V3CWriter()
    return writer.write(writer.encode(context))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--points", type=int, default=40000)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--scene", choices=sorted(SCENES), default="sphere",
                    help="sphere = smooth deforming sphere; blobs = textured "
                         "multi-object scene with rigid motion + occlusion")
    ap.add_argument("--out", default="cloud_%04d.ply")
    args = ap.parse_args(argv)
    for f in range(args.frames):
        ps = SCENES[args.scene](f, n=args.points)
        path = args.out % (args.start + f)
        ps.write_ply(path)
        print(f"{path}: {ps.point_count} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
