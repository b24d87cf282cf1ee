"""Video sub-bitstream buffer with NAL re-framing.

Capability parity with PCCVideoBitstream (/root/reference/source/lib/
PccLibBitstreamCommon/include/PCCVideoBitstream.h:62-64): a typed byte buffer
holding one coded video component (occupancy/geometry/attribute), MD5, file
I/O, and conversion between **byte-stream** (Annex-B start codes, what a
video codec consumes) and **sample-stream** (length-prefixed NAL units, what
lives inside a V3C unit) framing.

RBV (our device codec) payloads are already length-framed internally and pass
through unchanged; the re-framing functions operate on any Annex-B payload
(e.g. HEVC from an external backend).
"""

from __future__ import annotations

import hashlib

from ..utils.enums import VideoType


def byte_stream_to_sample_stream(data: bytes, precision: int = 4) -> bytes:
    """Annex-B (00 00 01 / 00 00 00 01 start codes) -> length-prefixed NALs."""
    nals = split_annexb(data)
    out = bytearray()
    for nal in nals:
        out.extend(len(nal).to_bytes(precision, "big"))
        out.extend(nal)
    return bytes(out)


def sample_stream_to_byte_stream(data: bytes, precision: int = 4) -> bytes:
    """Length-prefixed NALs -> Annex-B with 4-byte start codes."""
    out = bytearray()
    pos = 0
    while pos + precision <= len(data):
        size = int.from_bytes(data[pos : pos + precision], "big")
        pos += precision
        out.extend(b"\x00\x00\x00\x01")
        out.extend(data[pos : pos + size])
        pos += size
    return bytes(out)


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B elementary stream into NAL payloads (no start codes)."""
    nals: list[bytes] = []
    i = 0
    n = len(data)
    starts: list[int] = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = n if k + 1 == len(starts) else starts[k + 1] - 3
        # trim the 0x00 that belongs to a 4-byte start code of the *next* NAL
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nals.append(data[s:e])
    return nals


class VideoBitstream:
    def __init__(self, type: VideoType, data: bytes = b"") -> None:
        self.type = type
        self.data = bytes(data)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def name(self) -> str:
        return self.type.name.lower()

    def compute_md5(self) -> bytes:
        return hashlib.md5(self.data).digest()

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.data)

    @classmethod
    def read(cls, path: str, type: VideoType) -> "VideoBitstream":
        with open(path, "rb") as f:
            return cls(type, f.read())

    def sample_stream_to_byte_stream(self, precision: int = 4) -> None:
        self.data = sample_stream_to_byte_stream(self.data, precision)

    def byte_stream_to_sample_stream(self, precision: int = 4) -> None:
        self.data = byte_stream_to_sample_stream(self.data, precision)
