"""Point cloud container with PLY I/O, dedup, and checksums.

Capability parity with the reference's PCCPointSet3
(/root/reference/source/lib/PccLibCommon/include/PCCPointSet.h:1-535):
positions, 8/16-bit colors, reflectances, normals, point types, ascii +
binary PLY read/write, duplicate removal, MD5 checksum of the reordered
cloud.  Design difference: storage is a struct-of-arrays of NumPy arrays so
entire clouds move to the device as single arrays; there are no per-point
objects and no per-point loops anywhere.

The KNN-weighted recoloring kernels the reference hangs off this class
(transferColors*, PCCPointSet.cpp:807-2097) live in
``rabbit_transcoding_tpu.ops.recolor`` as batched JAX ops instead.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np


class PointSet:
    """A colored point cloud: struct-of-arrays, NumPy-backed."""

    def __init__(
        self,
        positions: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        normals: np.ndarray | None = None,
        reflectances: np.ndarray | None = None,
        colors16: np.ndarray | None = None,
        types: np.ndarray | None = None,
        partition: np.ndarray | None = None,
    ) -> None:
        self.positions = (
            np.zeros((0, 3), np.int32) if positions is None else np.asarray(positions)
        )
        self.colors = None if colors is None else np.asarray(colors, np.uint8)
        self.colors16 = None if colors16 is None else np.asarray(colors16, np.uint16)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.reflectances = (
            None if reflectances is None else np.asarray(reflectances, np.uint16)
        )
        self.types = None if types is None else np.asarray(types, np.uint8)
        # per-point patch index (the reference's partition vector fed to
        # smoothPointCloud/colorSmoothing; PCCCodec.cpp:52,149)
        self.partition = (
            None if partition is None else np.asarray(partition, np.int32)
        )

    # ------------------------------------------------------------------
    @property
    def point_count(self) -> int:
        return int(self.positions.shape[0])

    def __len__(self) -> int:
        return self.point_count

    @property
    def has_colors(self) -> bool:
        return self.colors is not None and len(self.colors) == self.point_count

    @property
    def has_normals(self) -> bool:
        return self.normals is not None and len(self.normals) == self.point_count

    @property
    def has_reflectances(self) -> bool:
        return (
            self.reflectances is not None
            and len(self.reflectances) == self.point_count
        )

    def copy(self) -> "PointSet":
        return PointSet(
            positions=self.positions.copy(),
            colors=None if self.colors is None else self.colors.copy(),
            normals=None if self.normals is None else self.normals.copy(),
            reflectances=None
            if self.reflectances is None
            else self.reflectances.copy(),
            colors16=None if self.colors16 is None else self.colors16.copy(),
            types=None if self.types is None else self.types.copy(),
            partition=(
                None if self.partition is None else self.partition.copy()
            ),
        )

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        if self.point_count == 0:
            return np.zeros(3), np.zeros(3)
        return self.positions.min(axis=0), self.positions.max(axis=0)

    # ------------------------------------------------------------------
    def remove_duplicates(self, mode: int = 1) -> "PointSet":
        """Drop points with identical positions (keeps first occurrence),
        parity with PCCPointSet3::removeDuplicate (PCCPointSet.cpp:43-218).
        mode 1 keeps the first co-located point's attributes; mode 2 keeps
        the first point but averages the COLORS of all co-located points
        (integer floor division, exactly the reference's size_t division)."""
        if self.point_count == 0:
            return self
        _, idx, inv = np.unique(
            self.positions, axis=0, return_index=True, return_inverse=True
        )
        if len(idx) == self.point_count:
            return self
        idx.sort()
        out = self.select(idx)
        if mode == 2 and self.has_colors:
            # group colors by position, floor-averaged (r / listIndex.size())
            inv = inv.reshape(-1)
            counts = np.bincount(inv)
            sums = np.zeros((len(counts), 3), np.int64)
            np.add.at(sums, inv, self.colors.astype(np.int64))
            avg = (sums // counts[:, None]).astype(self.colors.dtype)
            # map unique-group order back to the kept (first-occurrence) rows
            out_groups = inv[idx]
            out.colors = avg[out_groups]
        return out

    def select(self, idx: np.ndarray) -> "PointSet":
        return PointSet(
            positions=self.positions[idx],
            colors=None if self.colors is None else self.colors[idx],
            normals=None if self.normals is None else self.normals[idx],
            reflectances=None
            if self.reflectances is None
            else self.reflectances[idx],
            colors16=None if self.colors16 is None else self.colors16[idx],
            types=None if self.types is None else self.types[idx],
            partition=None if self.partition is None else self.partition[idx],
        )

    def convert_rgb_to_yuv(self) -> None:
        """In-place BT.709 full-range RGB->YCbCr on the 8-bit colors
        (PCCPointSet3::convertRGBToYUV, PCCPointSet.cpp; the colorTransform=1
        option)."""
        if self.colors is None:
            return
        c = self.colors.astype(np.float64)
        r, g, b = c[:, 0], c[:, 1], c[:, 2]
        y = np.round(0.212600 * r + 0.715200 * g + 0.072200 * b)
        u = np.round(-0.114572 * r - 0.385428 * g + 0.500000 * b + 128.0)
        v = np.round(0.500000 * r - 0.454153 * g - 0.045847 * b + 128.0)
        self.colors = np.clip(
            np.stack([y, u, v], axis=1), 0, 255
        ).astype(np.uint8)

    def convert_yuv_to_rgb(self) -> None:
        """Inverse of convert_rgb_to_yuv (PCCPointSet3::convertYUVToRGB)."""
        if self.colors is None:
            return
        c = self.colors.astype(np.float64)
        y, u, v = c[:, 0], c[:, 1] - 128.0, c[:, 2] - 128.0
        r = np.round(y + 1.57480 * v)
        g = np.round(y - 0.18733 * u - 0.46813 * v)
        b = np.round(y + 1.85563 * u)
        self.colors = np.clip(
            np.stack([r, g, b], axis=1), 0, 255
        ).astype(np.uint8)

    def compute_checksum(self) -> bytes:
        """MD5 over the morton/lexicographically reordered cloud, so two clouds
        with the same points in different order hash equal
        (PCCPointSet.cpp:222 concept)."""
        order = np.lexsort(
            (self.positions[:, 2], self.positions[:, 1], self.positions[:, 0])
        )
        h = hashlib.md5()
        pos = np.ascontiguousarray(self.positions[order].astype(np.int32))
        h.update(pos.tobytes())
        if self.has_colors:
            h.update(np.ascontiguousarray(self.colors[order]).tobytes())
        return h.digest()

    # ------------------------------------------------------------------
    # PLY I/O (ascii + binary_little_endian), parity with
    # PCCPointSet3::read/write (PCCPointSet.cpp).
    _PLY_DTYPES = {
        "char": "i1", "int8": "i1",
        "uchar": "u1", "uint8": "u1",
        "short": "i2", "int16": "i2",
        "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4",
        "uint": "u4", "uint32": "u4",
        "float": "f4", "float32": "f4",
        "double": "f8", "float64": "f8",
    }

    @classmethod
    def read_ply(cls, path: str) -> "PointSet":
        with open(path, "rb") as f:
            line = f.readline().strip()
            if line != b"ply":
                raise ValueError(f"{path}: not a PLY file")
            fmt = None
            n_vertex = 0
            props: list[tuple[str, str]] = []
            in_vertex = False
            while True:
                line = f.readline()
                if not line:
                    raise ValueError(f"{path}: unexpected EOF in header")
                tok = line.decode("ascii", "replace").strip().split()
                if not tok:
                    continue
                if tok[0] == "format":
                    fmt = tok[1]
                elif tok[0] == "element":
                    in_vertex = tok[1] == "vertex"
                    if in_vertex:
                        n_vertex = int(tok[2])
                elif tok[0] == "property" and in_vertex:
                    if tok[1] == "list":
                        raise ValueError("list properties unsupported on vertex")
                    props.append((tok[2], cls._PLY_DTYPES[tok[1]]))
                elif tok[0] == "end_header":
                    break
            names = [p[0] for p in props]
            if fmt == "ascii":
                data = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
                cols = {n: data[:, i] for i, n in enumerate(names)}
            elif fmt in ("binary_little_endian", "binary_big_endian"):
                endian = "<" if fmt == "binary_little_endian" else ">"
                dt = np.dtype([(n, endian + d) for n, d in props])
                raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                    count=n_vertex)
                cols = {n: raw[n] for n in names}
            else:
                raise ValueError(f"{path}: unknown PLY format {fmt}")

        def _get3(a, b, c):
            if a in cols and b in cols and c in cols:
                return np.stack([cols[a], cols[b], cols[c]], axis=1)
            return None

        pos = _get3("x", "y", "z")
        if pos is None:
            raise ValueError(f"{path}: PLY has no x/y/z")
        colors = _get3("red", "green", "blue")
        normals = _get3("nx", "ny", "nz")
        refl = cols.get("reflectance")
        # integer-quantised voxel grids stay integer
        if np.allclose(pos, np.round(pos)):
            pos = np.round(pos).astype(np.int32)
        return cls(
            positions=pos,
            colors=None if colors is None else colors.astype(np.uint8),
            normals=None if normals is None else normals.astype(np.float64),
            reflectances=None if refl is None else np.asarray(refl, np.uint16),
        )

    def write_ply(self, path: str, binary: bool = True, as_float: bool = False) -> None:
        n = self.point_count
        pos_type = "float" if as_float or self.positions.dtype.kind == "f" else "int"
        header = ["ply"]
        header.append(
            "format binary_little_endian 1.0" if binary else "format ascii 1.0"
        )
        header.append("comment generated by rabbit_transcoding_tpu")
        header.append(f"element vertex {n}")
        for ax in "xyz":
            header.append(f"property {pos_type} {ax}")
        if self.has_normals:
            for ax in "xyz":
                header.append(f"property float n{ax}")
        if self.has_colors:
            for c in ("red", "green", "blue"):
                header.append(f"property uchar {c}")
        if self.has_reflectances:
            header.append("property ushort reflectance")
        header.append("end_header")

        fields: list[np.ndarray] = []
        dtypes: list[tuple[str, str]] = []
        pos = self.positions.astype(np.float32 if pos_type == "float" else np.int32)
        for i, ax in enumerate("xyz"):
            fields.append(pos[:, i])
            dtypes.append((ax, "<f4" if pos_type == "float" else "<i4"))
        if self.has_normals:
            nrm = self.normals.astype(np.float32)
            for i, ax in enumerate("xyz"):
                fields.append(nrm[:, i])
                dtypes.append((f"n{ax}", "<f4"))
        if self.has_colors:
            for i, c in enumerate(("red", "green", "blue")):
                fields.append(self.colors[:, i])
                dtypes.append((c, "u1"))
        if self.has_reflectances:
            fields.append(self.reflectances)
            dtypes.append(("reflectance", "<u2"))

        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            if binary:
                rec = np.empty(n, dtype=np.dtype(dtypes))
                for (name, _), col in zip(dtypes, fields):
                    rec[name] = col
                f.write(rec.tobytes())
            else:
                mat = np.column_stack([c.astype(np.float64) for c in fields])
                for row in mat:
                    txt = []
                    for (name, dt), v in zip(dtypes, row):
                        if dt in ("u1", "<u2", "<i4"):
                            txt.append(str(int(v)))
                        else:
                            txt.append(f"{v:g}")
                    f.write((" ".join(txt) + "\n").encode("ascii"))

    # ------------------------------------------------------------------
    @staticmethod
    def yuv16_to_rgb8(colors16: np.ndarray) -> np.ndarray:
        """BT.709 YUV (10/16-bit) -> 8-bit RGB, parity with
        PCCPointSet3::convertYUV16ToRGB8 (PCCPointSet.h:133)."""
        yuv = colors16.astype(np.float64) / 65535.0
        y, u, v = yuv[:, 0], yuv[:, 1] - 0.5, yuv[:, 2] - 0.5
        r = y + 1.57480 * v
        g = y - 0.18733 * u - 0.46813 * v
        b = y + 1.85563 * u
        rgb = np.stack([r, g, b], axis=1)
        return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
