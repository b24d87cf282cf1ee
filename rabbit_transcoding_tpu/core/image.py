"""Planar image / video containers with raw-YUV file I/O.

Capability parity with PCCImage/PCCVideo (/root/reference/source/lib/
PccLibCommon/include/PCCImage.h:1-247, PCCVideo.h:62-124): 1-3 planes in
YUV400/YUV420/YUV444/RGB444, get/set, block copy, bit-depth conversion,
per-channel MD5, 444<->420 conversion, raw .yuv/.rgb file read/write.

Design difference vs the reference: a Video is ONE contiguous NumPy array
per plane group, shape (frames, H, W) (+ chroma at (frames, H/2, W/2) for
420), so a whole GOF uploads to the device as a single host->device transfer and
all per-pixel ops are batched over frames.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..utils.enums import ColorFormat


def _dtype_for(bitdepth: int):
    return np.uint8 if bitdepth <= 8 else np.uint16


class Image:
    """One frame: planes y (H,W) and optionally u, v."""

    def __init__(
        self,
        width: int,
        height: int,
        bitdepth: int = 8,
        fmt: ColorFormat = ColorFormat.YUV420,
        planes: list[np.ndarray] | None = None,
    ):
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.format = fmt
        if planes is not None:
            self.planes = planes
        else:
            dt = _dtype_for(bitdepth)
            if fmt == ColorFormat.YUV400:
                self.planes = [np.zeros((height, width), dt)]
            elif fmt == ColorFormat.YUV420:
                self.planes = [
                    np.zeros((height, width), dt),
                    np.zeros((height // 2, width // 2), dt),
                    np.zeros((height // 2, width // 2), dt),
                ]
            else:
                self.planes = [np.zeros((height, width), dt) for _ in range(3)]

    @property
    def channel_count(self) -> int:
        return len(self.planes)

    def copy_block(
        self, src: "Image", sx: int, sy: int, w: int, h: int, dx: int, dy: int
    ) -> None:
        """Copy a WxH luma-coordinate block from src; chroma scaled for 420.
        (PCCImage::copyBlock analog, PCCImage.h:222)."""
        for c, plane in enumerate(self.planes):
            s = 2 if (self.format == ColorFormat.YUV420 and c > 0) else 1
            plane[dy // s : (dy + h) // s, dx // s : (dx + w) // s] = src.planes[c][
                sy // s : (sy + h) // s, sx // s : (sx + w) // s
            ]

    def convert_bitdepth(self, target: int, msb_align: bool = True) -> "Image":
        """Shift-based bit-depth conversion (PCCImage::convertBitdepth analog)."""
        out_planes = []
        shift = target - self.bitdepth
        dt = _dtype_for(target)
        maxv = (1 << target) - 1
        for p in self.planes:
            a = p.astype(np.int32)
            if msb_align:
                a = a << shift if shift >= 0 else a >> (-shift)
            out_planes.append(np.clip(a, 0, maxv).astype(dt))
        return Image(self.width, self.height, target, self.format, out_planes)

    def compute_md5(self, channel: int) -> bytes:
        return hashlib.md5(
            np.ascontiguousarray(self.planes[channel]).tobytes()
        ).digest()


class Video:
    """A sequence of frames stored as stacked plane arrays."""

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        bitdepth: int = 8,
        fmt: ColorFormat = ColorFormat.YUV420,
        planes: list[np.ndarray] | None = None,
    ):
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.format = fmt
        # planes[c] has shape (frames, h_c, w_c)
        if planes is not None:
            self.planes = planes
        else:
            self.planes = []

    # ------------------------------------------------------------------
    @property
    def frame_count(self) -> int:
        return 0 if not self.planes else int(self.planes[0].shape[0])

    @property
    def channel_count(self) -> int:
        return len(self.planes)

    def __len__(self) -> int:
        return self.frame_count

    def frame(self, i: int) -> Image:
        return Image(
            self.width,
            self.height,
            self.bitdepth,
            self.format,
            [p[i] for p in self.planes],
        )

    @classmethod
    def from_frames(cls, frames: list[Image]) -> "Video":
        f0 = frames[0]
        planes = [
            np.stack([fr.planes[c] for fr in frames], axis=0)
            for c in range(f0.channel_count)
        ]
        return cls(f0.width, f0.height, f0.bitdepth, f0.format, planes)

    @classmethod
    def zeros(
        cls,
        frames: int,
        width: int,
        height: int,
        bitdepth: int = 8,
        fmt: ColorFormat = ColorFormat.YUV420,
    ) -> "Video":
        dt = _dtype_for(bitdepth)
        if fmt == ColorFormat.YUV400:
            planes = [np.zeros((frames, height, width), dt)]
        elif fmt == ColorFormat.YUV420:
            planes = [
                np.zeros((frames, height, width), dt),
                np.zeros((frames, height // 2, width // 2), dt),
                np.zeros((frames, height // 2, width // 2), dt),
            ]
        else:
            planes = [np.zeros((frames, height, width), dt) for _ in range(3)]
        return cls(width, height, bitdepth, fmt, planes)

    # ------------------------------------------------------------------
    def read(
        self,
        path: str,
        width: int,
        height: int,
        frame_count: int,
        bitdepth: int = 8,
        fmt: ColorFormat = ColorFormat.YUV420,
    ) -> "Video":
        """Read a raw planar .yuv/.rgb file (PCCVideo::read analog,
        PCCVideo.h:85-113)."""
        dt = _dtype_for(bitdepth)
        itemsize = np.dtype(dt).itemsize
        if fmt == ColorFormat.YUV420:
            per_frame = width * height + 2 * (width // 2) * (height // 2)
        elif fmt == ColorFormat.YUV400:
            per_frame = width * height
        else:
            per_frame = 3 * width * height
        raw = np.fromfile(path, dtype=dt, count=per_frame * frame_count)
        if raw.size < per_frame * frame_count:
            raise ValueError(
                f"{path}: expected {per_frame*frame_count} samples, got {raw.size}"
            )
        raw = raw.reshape(frame_count, per_frame)
        if fmt == ColorFormat.YUV420:
            ys = width * height
            cs = (width // 2) * (height // 2)
            y = raw[:, :ys].reshape(frame_count, height, width)
            u = raw[:, ys : ys + cs].reshape(frame_count, height // 2, width // 2)
            v = raw[:, ys + cs :].reshape(frame_count, height // 2, width // 2)
            planes = [y, u, v]
        elif fmt == ColorFormat.YUV400:
            planes = [raw.reshape(frame_count, height, width)]
        else:
            planes = list(
                raw.reshape(frame_count, 3, height, width).transpose(1, 0, 2, 3)
            )
        self.width, self.height = width, height
        self.bitdepth, self.format = bitdepth, fmt
        self.planes = [np.ascontiguousarray(p) for p in planes]
        del itemsize
        return self

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            if self.format in (ColorFormat.YUV420, ColorFormat.YUV400):
                for i in range(self.frame_count):
                    for p in self.planes:
                        f.write(np.ascontiguousarray(p[i]).tobytes())
            else:
                for i in range(self.frame_count):
                    for p in self.planes:
                        f.write(np.ascontiguousarray(p[i]).tobytes())

    # ------------------------------------------------------------------
    def convert_bitdepth(self, target: int, msb_align: bool = True) -> "Video":
        shift = target - self.bitdepth
        dt = _dtype_for(target)
        maxv = (1 << target) - 1
        planes = []
        for p in self.planes:
            a = p.astype(np.int32)
            if msb_align:
                a = a << shift if shift >= 0 else a >> (-shift)
            planes.append(np.clip(a, 0, maxv).astype(dt))
        return Video(self.width, self.height, target, self.format, planes)

    def yuv420_to_yuv444(self) -> "Video":
        """Nearest-neighbour chroma upsample (PCCVideo::convertYUV420To444)."""
        assert self.format == ColorFormat.YUV420
        y = self.planes[0]
        u = np.repeat(np.repeat(self.planes[1], 2, axis=1), 2, axis=2)
        v = np.repeat(np.repeat(self.planes[2], 2, axis=1), 2, axis=2)
        u = u[:, : y.shape[1], : y.shape[2]]
        v = v[:, : y.shape[1], : y.shape[2]]
        return Video(self.width, self.height, self.bitdepth, ColorFormat.YUV444,
                     [y, u, v])

    def yuv444_to_yuv420(self) -> "Video":
        """2x2 mean chroma downsample."""
        assert self.format in (ColorFormat.YUV444, ColorFormat.RGB444)
        y, u, v = self.planes
        f, h, w = u.shape

        def down(p):
            p = p.astype(np.uint32)
            return (
                (p[:, 0::2, 0::2] + p[:, 0::2, 1::2] + p[:, 1::2, 0::2]
                 + p[:, 1::2, 1::2] + 2) // 4
            ).astype(self.planes[0].dtype)

        return Video(self.width, self.height, self.bitdepth, ColorFormat.YUV420,
                     [y, down(u), down(v)])

    def compute_md5(self, channel: int) -> bytes:
        return hashlib.md5(
            np.ascontiguousarray(self.planes[channel]).tobytes()
        ).digest()
