"""Multi-stream sharded transcode — the PRODUCT path on a device mesh.

This is the multi-device replacement for the reference's only multi-stream
story (one OS process per stream, TBB threads inside, PCCTranscoder.cpp:67):
N concurrent V-PCC streams' GOF coefficient tensors are stacked into one
batch and transcoded through ONE sharded device program over a
("stream", "space") jax.sharding Mesh (BASELINE.json config #5).

Guarantee: bit-identical payloads to the sequential per-stream path
(video/rbv.transcode_payload / requantize).  The batched kernels are
jax.vmap over the very same composable impls the single-stream jits use,
with per-stream quantiser steps carried as an (S,) vector, so arithmetic
(deadzone quantisation, rounding, clipping, the P-chain scan and MV-reuse
re-encode) is identical element-for-element; tests/test_parallel.py asserts
byte equality of the produced payloads.

Host/device split is unchanged from the single-stream design: entropy
(inflate/deflate/rANS) stays on host threads, only coefficient slabs cross
the link, pixels never do.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import struct
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.enums import ColorFormat
from ..video import rbv
from ..video.rbv import (
    _HEADER,
    _MAGIC,
    _decode_coeff_blob,
    _decode_impl,
    _decode_impl_mc,
    _encode_coeff_blob,
    _encode_impl,
    _encode_intra_section,
    _encode_mv_section,
    _iter_blobs,
    _parse_header,
    _plane_dims,
    _reencode_with_mv,
    _split_intra_section,
    _split_mv_section,
    qstep_of,
)
from .mesh import make_mesh


# ===========================================================================
# Batched device kernels: vmap over the leading stream axis of the SAME
# composable impls the single-stream jits wrap (video/rbv.py) — this is what
# makes the sharded path bit-identical to the sequential one.
# ===========================================================================
def _batched_transcode_impl(
    coeffs, qs_in, qs_out, maxval, block: int, gop_in: int, gop_out: int,
    deblock: bool = False, thr_k: int = 0,
):
    def one(q, qi, qo):
        pixels = _decode_impl(q, qi, maxval, block, gop_in, deblock)
        return _encode_impl(pixels, qo, maxval, block, gop_out, deblock,
                            thr_k)[0]

    return jax.vmap(one)(coeffs, qs_in, qs_out)


def _batched_transcode_mc_impl(coeffs, mv, qs_in, qs_out, maxval, block: int,
                               gop: int, deblock: bool = False,
                               thr_k: int = 0):
    def one(q, m, qi, qo):
        pixels = _decode_impl_mc(q, m, qi, maxval, block, gop, deblock)
        return _reencode_with_mv(pixels, m, qo, maxval, block, gop, deblock,
                                 thr_k)

    return jax.vmap(one)(coeffs, mv, qs_in, qs_out)


def _batched_transcode_intra_impl(
    coeffs, imode, qs_in, qs_out, maxval, block: int, gop_in: int,
    gop_out: int, deblock: bool = False, thr_k: int = 0,
):
    def one(q, i, qi, qo):
        pixels = _decode_impl(q, qi, maxval, block, gop_in, deblock, i)
        q2, mode2, _ = _encode_impl(pixels, qo, maxval, block, gop_out,
                                    deblock, thr_k, intra=True)
        return q2, mode2

    return jax.vmap(one)(coeffs, imode, qs_in, qs_out)


def _batched_transcode_mc_intra_impl(
    coeffs, mv, imode, qs_in, qs_out, maxval, block: int, gop: int,
    deblock: bool = False, thr_k: int = 0,
):
    def one(q, m, i, qi, qo):
        pixels = _decode_impl_mc(q, m, qi, maxval, block, gop, deblock, i)
        return _reencode_with_mv(pixels, m, qo, maxval, block, gop, deblock,
                                 thr_k, intra=True)

    return jax.vmap(one)(coeffs, mv, imode, qs_in, qs_out)


def _batched_requant_impl(q, qs_old, qs_new):
    def one(qq, a, b):
        c = qq.astype(jnp.float32) * a
        return jnp.clip(jnp.round(c / b), -32767, 32767).astype(jnp.int16)

    return jax.vmap(one)(q, qs_old, qs_new)


def _batched_requant_comp_impl(q, qs_old, qs_new, gop: int):
    from ..video.rbv import _requant_compensated_device

    def one(qq, a, b):
        return _requant_compensated_device(qq, a, b, gop)

    return jax.vmap(one)(q, qs_old, qs_new)




@lru_cache(maxsize=None)
def _sharded_kernels(mesh: Mesh, shard_rows: bool):
    """jit the batched kernels with mesh shardings.  Streams shard over the
    "stream" axis; block rows over "space" when divisible (shard_rows)."""
    row = "space" if shard_rows else None
    cshard = NamedSharding(mesh, P("stream", None, row, None, None, None))
    mvshard = NamedSharding(mesh, P("stream", None, row, None))
    sshard = NamedSharding(mesh, P("stream"))
    rshard = NamedSharding(mesh, P())
    # static args must be positional: pjit rejects kwargs with in_shardings
    transcode = jax.jit(
        _batched_transcode_impl,
        static_argnums=(4, 5, 6, 7, 8),
        in_shardings=(cshard, sshard, sshard, rshard),
        out_shardings=cshard,
    )
    transcode_mc = jax.jit(
        _batched_transcode_mc_impl,
        static_argnums=(5, 6, 7, 8),
        in_shardings=(cshard, mvshard, sshard, sshard, rshard),
        out_shardings=cshard,
    )
    requant = jax.jit(
        _batched_requant_impl,
        in_shardings=(cshard, sshard, sshard),
        out_shardings=cshard,
    )
    return transcode, transcode_mc, requant


@lru_cache(maxsize=None)
def _sharded_intra_kernels(mesh: Mesh, shard_rows: bool):
    """Batched transcode kernels for intra-flagged streams (mosaic side
    info rides as (S, n_I, nby, nbx) tensors next to the coefficients)."""
    row = "space" if shard_rows else None
    cshard = NamedSharding(mesh, P("stream", None, row, None, None, None))
    mshard = NamedSharding(mesh, P("stream", None, row, None))
    sshard = NamedSharding(mesh, P("stream"))
    rshard = NamedSharding(mesh, P())
    transcode_intra = jax.jit(
        _batched_transcode_intra_impl,
        static_argnums=(5, 6, 7, 8, 9),
        in_shardings=(cshard, mshard, sshard, sshard, rshard),
        out_shardings=(cshard, mshard),
    )
    transcode_mc_intra = jax.jit(
        _batched_transcode_mc_intra_impl,
        static_argnums=(6, 7, 8, 9),
        in_shardings=(cshard, mshard, mshard, sshard, sshard, rshard),
        out_shardings=(cshard, mshard),
    )
    return transcode_intra, transcode_mc_intra


@lru_cache(maxsize=None)
def _sharded_requant_comp(mesh: Mesh, shard_rows: bool, gop: int):
    """Drift-compensated batched requant (matches rbv.requantize for
    zero-MV P chains — byte identity with the sequential path)."""
    row = "space" if shard_rows else None
    cshard = NamedSharding(mesh, P("stream", None, row, None, None, None))
    sshard = NamedSharding(mesh, P("stream"))
    return jax.jit(
        partial(_batched_requant_comp_impl, gop=gop),
        in_shardings=(cshard, sshard, sshard),
        out_shardings=cshard,
    )




# ===========================================================================
# Host orchestration
# ===========================================================================
def _pad_streams(batch: np.ndarray, s_mult: int) -> np.ndarray:
    """Zero-pad the stream axis up to a multiple of the mesh stream axis
    (padded streams are dead weight but keep the sharding even)."""
    s = batch.shape[0]
    pad = (-s) % s_mult
    if pad == 0:
        return batch
    return np.concatenate(
        [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)], axis=0
    )


def _pad_frames(q: np.ndarray, fp: int) -> np.ndarray:
    """Repeat the last frame up to fp frames (axis 1 of (S, F, ...))."""
    f = q.shape[1]
    if fp == f:
        return q
    return np.concatenate(
        [q, np.repeat(q[:, -1:], fp - f, axis=1)], axis=1
    )


def _group_signature(header: tuple) -> tuple:
    """Streams batch together when everything but the QP matches: the QP
    rides as a per-stream quantiser-step vector into the batched kernel."""
    flags, width, height, bitdepth, chroma, f, block, gop, _qp = header
    return (flags, width, height, bitdepth, chroma, f, block, gop)


def transcode_payloads(
    payloads: list[bytes],
    new_qp: int | list[int],
    mesh: Mesh | None = None,
    new_gop: int | None = None,
    zlib_level: int = 6,
    mode: str = "reencode",
    coeff_threshold: int = 0,
) -> list[bytes]:
    """Transcode N RBV payloads in one sharded device program per plane.

    Streams are grouped by shape signature; each homogeneous group is
    batched (per-stream input/output QPs ride as (S,) qstep vectors).
    Lossless payloads pass through; a group of one still runs the batched
    kernel (vmap of size 1 — same arithmetic).  mode="requant" runs the
    DCT-domain requantisation instead of the fused decode->re-encode.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n = len(payloads)
    qps = [new_qp] * n if isinstance(new_qp, int) else list(new_qp)
    if len(qps) != n:
        raise ValueError("per-stream QP list length mismatch")

    headers = [_parse_header(p) for p in payloads]
    out: list[bytes | None] = [None] * n

    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(headers):
        flags = h[0]
        if flags & 1:
            # lossless: defer to the sequential functions so the batched
            # API stays byte-identical to them (they re-encode to the
            # target QP; a silent passthrough would diverge)
            out[i] = (
                rbv.requantize(payloads[i], qps[i], zlib_level)
                if mode == "requant"
                else rbv.transcode_payload(
                    payloads[i], qps[i], new_gop, zlib_level,
                    coeff_threshold,
                )
            )
            continue
        if mode == "requant" and qps[i] == h[8]:
            out[i] = payloads[i]  # no-op requant: pass through
            continue
        groups.setdefault(_group_signature(h), []).append(i)

    for sig, idxs in groups.items():
        flags, width, height, bitdepth, chroma, f, block, gop, = sig
        use_mc = bool(flags & 2)
        use_db = bool(flags & 4)
        gop_out = (
            gop if (use_mc or mode == "requant") else (new_gop or gop)
        )
        dims = _plane_dims(width, height, ColorFormat(chroma))
        maxval = jnp.float32((1 << bitdepth) - 1)
        qs_in_np = np.asarray(
            [qstep_of(headers[i][8]) for i in idxs], np.float32
        )
        qs_out_np = np.asarray([qstep_of(qps[i]) for i in idxs], np.float32)

        blob_lists = [list(_iter_blobs(payloads[i], len(dims))) for i in idxs]
        plane_blobs_out: list[list[bytes]] = [[] for _ in idxs]

        for pi, (h, w) in enumerate(dims):
            ph = h + ((-h) % block)
            pw = w + ((-w) % block)
            nby, nbx = ph // block, pw // block
            # frame padding must satisfy BOTH gop reshapes
            fp = f
            lcm = math.lcm(gop, gop_out)
            fp = f + ((-f) % lcm)

            # host entropy -> DEVICE tensors: _decode_coeff_blob uploads only
            # the frequency slab and scatters to dense ON DEVICE.  Stacking,
            # frame/stream padding and the compute all stay on device; the
            # dense (S, F, nby, nbx, B, B) tensor never crosses between host
            # and device
            use_intra = bool(flags & 8)
            n_i_in = (f + ((-f) % gop)) // gop

            def host_decode(si: int):
                blob = blob_lists[si][pi]
                mv = None
                cblob = blob
                if use_mc:
                    mv, cblob = _split_mv_section(blob, f, nby, nbx)
                imode = None
                raw_i = b""
                if use_intra:
                    imode, cblob, raw_i = _split_intra_section(
                        cblob, n_i_in, nby, nbx
                    )
                q = _decode_coeff_blob(cblob, f, nby, nbx, block)
                return q, mv, imode, raw_i

            with cf.ThreadPoolExecutor(max_workers=min(8, len(idxs))) as ex:
                decoded = list(ex.map(host_decode, range(len(idxs))))

            s_mult = mesh.devices.shape[0]
            shard_rows = (nby % mesh.devices.shape[1]) == 0
            q_batch = jnp.stack([d[0] for d in decoded]).astype(jnp.int16)
            if fp != f:
                q_batch = jnp.concatenate(
                    [q_batch, jnp.repeat(q_batch[:, -1:], fp - f, axis=1)],
                    axis=1,
                )
            pad_s = (-q_batch.shape[0]) % s_mult
            if pad_s:
                q_batch = jnp.concatenate(
                    [q_batch,
                     jnp.zeros((pad_s,) + q_batch.shape[1:], q_batch.dtype)],
                    axis=0,
                )
            s_padded = q_batch.shape[0]
            qs_in_p = np.resize(qs_in_np, s_padded).copy()
            qs_out_p = np.resize(qs_out_np, s_padded).copy()
            # padded tail streams reuse real qsteps (never 0: div-safe)

            t_step, t_mc_step, rq_step = _sharded_kernels(mesh, shard_rows)
            row = "space" if shard_rows else None
            cshard = NamedSharding(
                mesh, P("stream", None, row, None, None, None)
            )
            sshard = NamedSharding(mesh, P("stream"))
            qdev = jax.device_put(q_batch, cshard)  # device->device reshard
            qi_dev = jax.device_put(qs_in_p, sshard)
            qo_dev = jax.device_put(qs_out_p, sshard)

            mode2 = None
            n_i_out = (f + ((-f) % gop_out)) // gop_out
            imode_dev = None
            if use_intra and mode != "requant":
                # mode maps: frame-pad (repeat tail map for the GOPs the
                # coefficient padding created) + stream-pad
                im_b = np.stack([d[2] for d in decoded]).astype(np.uint8)
                im_b = _pad_frames(im_b, fp // gop)
                mshard = NamedSharding(mesh, P("stream", None, row, None))
                imode_dev = jax.device_put(_pad_streams(im_b, s_mult),
                                           mshard)

            if mode == "requant":
                if not use_mc and gop > 1:
                    # matches rbv.requantize's drift-compensated zero-MV path
                    q2 = _sharded_requant_comp(mesh, shard_rows, gop)(
                        qdev, qi_dev, qo_dev
                    )
                else:
                    q2 = rq_step(qdev, qi_dev, qo_dev)
            elif use_mc:
                mv_batch = _pad_frames(
                    np.stack([d[1] for d in decoded]).astype(np.int32), fp
                )
                mv_dev = jax.device_put(
                    _pad_streams(mv_batch, s_mult),
                    NamedSharding(mesh, P("stream", None, row, None)),
                )
                if use_intra:
                    _, t_mc_intra = _sharded_intra_kernels(mesh, shard_rows)
                    q2, mode2 = t_mc_intra(
                        qdev, mv_dev, imode_dev, qi_dev, qo_dev,
                        maxval, block, gop, use_db, coeff_threshold,
                    )
                else:
                    q2 = t_mc_step(
                        qdev, mv_dev, qi_dev, qo_dev, maxval, block, gop,
                        use_db, coeff_threshold,
                    )
            elif use_intra:
                t_intra, _ = _sharded_intra_kernels(mesh, shard_rows)
                q2, mode2 = t_intra(
                    qdev, imode_dev, qi_dev, qo_dev, maxval,
                    block, gop, gop_out, use_db, coeff_threshold,
                )
            else:
                q2 = t_step(
                    qdev, qi_dev, qo_dev, maxval, block, gop, gop_out,
                    use_db, coeff_threshold,
                )

            # each stream's slice leaves the mesh here, one at a time on
            # this thread, onto one device: slicing a sharded array runs a
            # multi-device program, and multi-device programs dispatched
            # from several threads at once can deadlock in their
            # collectives on GPUs.  The encode threads below then run
            # single-device programs only.
            devs = list(mesh.devices.flat)
            q_out = [jax.device_put(q2[si, :f], devs[si % len(devs)])
                     for si in range(len(idxs))]
            modes_out = (
                [np.asarray(mode2[si, :n_i_out]) for si in range(len(idxs))]
                if use_intra and mode != "requant" else None
            )

            def host_encode(si: int) -> bytes:
                # _encode_coeff_blob compacts the frequency slab on device;
                # only the slab is downloaded
                mv = decoded[si][1]
                head = (
                    _encode_mv_section(mv, zlib_level)
                    if use_mc and mv is not None
                    else b""
                )
                if use_intra:
                    if mode == "requant":
                        head += decoded[si][3]  # I section passes through
                    else:
                        head += _encode_intra_section(modes_out[si],
                                                      zlib_level)
                return head + _encode_coeff_blob(q_out[si], zlib_level)

            with cf.ThreadPoolExecutor(max_workers=min(8, len(idxs))) as ex:
                for si, blob in enumerate(ex.map(host_encode, range(len(idxs)))):
                    plane_blobs_out[si].append(blob)

        for si, i in enumerate(idxs):
            header = _HEADER.pack(
                _MAGIC, 2, flags, width, height, bitdepth, chroma, f,
                block, gop_out, qps[i], 0,
            )
            buf = bytearray(header)
            for blob in plane_blobs_out[si]:
                buf.extend(struct.pack("<I", len(blob)))
                buf.extend(blob)
            out[i] = bytes(buf)

    assert all(o is not None for o in out)
    return out  # type: ignore[return-value]
