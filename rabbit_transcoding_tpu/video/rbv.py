"""RBV — the framework's block video codec, built for an accelerator.

This is the framework's replacement for the reference's HM/x265/NVENC video
path (SURVEY.md §7 milestone 4).  Design:

 * **Device (JAX/XLA)**: block DCT/IDCT as batched matmuls, uniform
   quantisation, reconstruction, and the I/P prediction chain.  A whole GOF
   is encoded in ONE jitted call: frames are grouped into independent GOPs,
   ``vmap`` runs all GOPs in parallel and ``lax.scan`` runs the short
   P-chain inside each GOP (gop=1 collapses to a fully parallel all-intra
   path, used for occupancy just like the reference's all-intra occupancy
   encode, PCCTranscoder.cpp:830-844).
 * **Host**: entropy coding (rANS / DEFLATE over int16 coefficients,
   DC-DPCM'd).  There is deliberately no cross-block *sample*
   prediction: that would serialise block decoding; prediction happens
   per-frame (P frames) and at the entropy level, keeping both directions
   embarrassingly parallel on device.
 * **Host<->device traffic stays small**: quantised coefficient tensors are
   >95% zero, so only the low-frequency slab that carries energy crosses
   between host and device; pixel uploads stay in their native integer
   dtype and are cast on device; and the transcode path
   (``transcode_payload``) fuses decode->re-encode into one device program
   so pixels never cross at all.

Closed-loop exactness: the encoder reconstructs with the same rounded/
clipped arithmetic the decoder uses, so encoder-side ``recon`` equals the
decode of the produced bitstream bit-for-bit when run on the same backend.

Payload container v2 (little-endian):
  magic 'RBV2' | ver u8 | flags u8 (b0 lossless, b1 motion-compensated,
  b2 in-loop deblocking) | width u16 | height u16 |
  bitdepth u8 | chroma u8 | frames u16 | block u8 | gop u8 | qp u8 | rsvd u8
  then per plane: blob_len u32 + blob, where blob =
    lossless: zlib(raw samples)
    mode 0:   0x00 + zlib(int16 coeffs, DC DPCM over block raster)
    mode 1:   0x01 + count u64 + idxlen u32 + zlib(uint32 index deltas)
                   + vallen u32 + zlib(int16 values)
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.image import Video
from ..utils.enums import ColorFormat
from ..ops.dct import blockify, dct2d, deblockify, idct2d, pad_to_block

_MAGIC = b"RBV2"
_HEADER = struct.Struct("<4sBBHHBBHBBBB")


def qstep_of(qp: int) -> float:
    """HEVC-style quantiser step: doubles every 6 QP."""
    return float(2.0 ** ((qp - 4.0) / 6.0))


def _next_pow2(n: int) -> int:
    return 1 << max(10, (max(1, n) - 1).bit_length())


# ===========================================================================
# Device kernels
# ===========================================================================
# deadzone quantisation offsets (HEVC-style): round-half for intra, a wider
# deadzone for inter residuals — collapses the broadband quant-noise
# coefficients that would otherwise force dense high-frequency slabs
_DZ_INTRA = 0.5
_DZ_INTER = 1.0 / 3.0


def _quantize(c, qstep, dz):
    return jnp.clip(
        jnp.sign(c) * jnp.floor(jnp.abs(c) / qstep + dz), -32767, 32767
    )


# --- motion compensation ---------------------------------------------------
# Block motion search: +/-_MC_RANGE in steps of _MC_STEP (odd grid keeps the
# zero-motion candidate).  The search is S edge-padded shifted-frame SAD
# reductions — pure batched element-wise work, no gather in the hot loop.
_MC_RANGE = 6
_MC_STEP = 2
# MV rate-cost weight in quantiser-step units (calibrated with
# scripts/rbv_rd.py: high enough that position-stable atlas video picks
# zero MVs everywhere, low enough that truly translating content wins)
_MC_LAMBDA_SCALE = 16.0
_MC_OFFSETS = tuple(
    (dy, dx)
    for dy in range(-_MC_RANGE, _MC_RANGE + 1, _MC_STEP)
    for dx in range(-_MC_RANGE, _MC_RANGE + 1, _MC_STEP)
)


def _mc_search(frame, prev, block: int, lam=0.0, weight=None):
    """-> (mv_idx (nby, nbx) int32, pred (H, W) f32): best rate-biased SAD
    candidate.  cost = SAD + lam * (4 + |dy| + |dx|) for nonzero motion
    (zero extra for the zero MV): without this bias, blocks grab tiny SAD
    wins with nonzero MVs and the resulting per-block shift discontinuities
    cost far more DCT bits than they save (measured +18..+345% BD-rate on
    position-stable atlas video, scripts/rbv_rd.py).  lam = qstep puts the
    penalty in quantiser units, the usual lambda*R_mv term."""
    h, w = frame.shape
    nby, nbx = h // block, w // block
    r = _MC_RANGE
    padded = jnp.pad(prev, ((r, r), (r, r)), mode="edge")
    best_cost = jnp.full((nby, nbx), jnp.inf, jnp.float32)
    best_idx = jnp.zeros((nby, nbx), jnp.int32)
    pred = prev
    for si, (dy, dx) in enumerate(_MC_OFFSETS):
        shifted = jax.lax.dynamic_slice(padded, (r + dy, r + dx), (h, w))
        diff = jnp.abs(frame - shifted)
        if weight is not None:
            # occupancy-aware RDO (usePccRDO analog): background mismatch
            # costs nothing — MVs track the PATCH content, not the padding
            diff = diff * weight
        cost = diff.reshape(nby, block, nbx, block).sum(axis=(1, 3))
        if dy or dx:
            cost = cost + lam * (4.0 + abs(dy) + abs(dx))
        better = cost < best_cost
        best_cost = jnp.where(better, cost, best_cost)
        best_idx = jnp.where(better, si, best_idx)
        bet_px = jnp.repeat(jnp.repeat(better, block, 0), block, 1)
        pred = jnp.where(bet_px, shifted, pred)
    return best_idx, pred


def _mc_predict(prev, mv_idx, block: int):
    """Apply per-block motion vectors: clipped-index gather (equivalent to
    the edge padding the search used)."""
    h, w = prev.shape
    offs = jnp.asarray(_MC_OFFSETS, jnp.int32)
    dy = jnp.repeat(jnp.repeat(offs[mv_idx, 0], block, 0), block, 1)
    dx = jnp.repeat(jnp.repeat(offs[mv_idx, 1], block, 0), block, 1)
    ys = jnp.clip(
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + dy, 0, h - 1
    )
    xs = jnp.clip(
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + dx, 0, w - 1
    )
    return prev[ys, xs]


def _deblock(rec, qstep, maxval, block: int):
    """In-loop deblocking: the HEVC-style WEAK filter, 1 px each side of
    every block boundary, vertical then horizontal.  Boundaries are >=
    block apart and each filter touches only its own 2 px, so the whole
    frame filters in parallel — no serialisation, unlike cross-block
    sample prediction (module docstring).  tc/beta scale with qstep like
    HEVC's tables (~qstep/4 and ~1.5*qstep at mid QP); the beta gate
    leaves real edges (checkerboard textures, depth steps) untouched.
    Measured +0.24..+0.62 dB PSNR on smooth/depth content, 0.000 on hard
    block-aligned edges.  In the closed loop on BOTH sides (flags bit 2):
    P frames predict from the filtered reference."""
    tc = 0.25 * qstep
    beta = 1.5 * qstep

    def filt_v(x):
        lead = x.shape[:-2]
        hh, ww = x.shape[-2:]
        nb = ww // block
        v = x.reshape(*lead, hh, nb, block)
        p1 = v[..., :-1, block - 2]
        p0 = v[..., :-1, block - 1]
        q0 = v[..., 1:, 0]
        q1 = v[..., 1:, 1]
        delta = (9.0 * (q0 - p0) - 3.0 * (q1 - p1)) * (1.0 / 16.0)
        apply = (jnp.abs(delta) < 10.0 * tc) & (jnp.abs(q0 - p0) < beta)
        d = jnp.clip(delta, -tc, tc) * apply
        v = v.at[..., :-1, block - 1].add(d)
        v = v.at[..., 1:, 0].add(-d)
        return v.reshape(*lead, hh, ww)

    rec = filt_v(rec)
    rec = jnp.swapaxes(filt_v(jnp.swapaxes(rec, -1, -2)), -1, -2)
    return jnp.clip(jnp.round(rec), 0.0, maxval)


def _hf_rank(block: int):
    """(B, B) zigzag rank of each coefficient position (static)."""
    import numpy as _np

    rank = _np.empty(block * block, _np.int32)
    rank[_zz(block)] = _np.arange(block * block, dtype=_np.int32)
    return rank.reshape(block, block)


def _threshold_coeffs(q, block: int, thr_k: int):
    """Coefficient-level RDO: zero quantised +/-1 values at zigzag rank >=
    thr_k.  On piecewise-smooth V-PCC planes those are almost pure
    quantisation noise but each costs a zero-run break + sign + magnitude
    in the entropy coder (measured: geometry plane -13..-51% bytes at
    -0.03..-0.06 dB, scripts/rbv_rd.py RBV_RD_THRESHOLD_AB=1).  Encoder-
    side only — the bitstream just carries more zeros, decode unchanged;
    the closed loop reconstructs from the thresholded coefficients."""
    rank = jnp.asarray(_hf_rank(block))
    drop = (jnp.abs(q) == 1.0) & (rank >= thr_k)
    return jnp.where(drop, 0.0, q)


# --- intra prediction (flags bit 3) -----------------------------------------
# I-frames keep their DC coefficients exactly where the baseline puts them
# (the [0,0] slot of each block — same values, same DC-DPCM + banded-rANS
# entropy cost), and the BLOCK-MEAN MOSAIC those DCs imply drives two fully
# block-parallel predictors for the AC residual: DC (broadcast own mean)
# and PLANAR (bilinear interpolation of the mosaic at block centers).  The
# residual's true DC is never coded — the decoder reconstructs it exactly
# from the mosaic (correction = mu_hat - mean(pred block), computable on
# both sides).  The only side information is a 1-bit-per-block mode map.
# This is the HEVC intra role (PCCHMLibVideoEncoderImpl.cpp:92-193
# configures HM's DC/planar/angular modes) without HEVC's sequential
# left/top sample dependency, which would serialise block decoding on
# any parallel device.  A rejected design kept honest: carrying the mosaic as a separate
# side channel cost 4-7 KB/plane (generic rANS loses to the slab's
# dedicated DC band context) and flipped the gop4 BD-rate to +3%.


def _block_means(frame, block: int):
    """(..., H, W) -> (..., nby, nbx) per-block means."""
    return blockify(frame, block).mean(axis=(-1, -2))


def _mosaic_planar(mu, h: int, w: int):
    """(..., nby, nbx) mosaic -> (..., H, W) bilinear at block centers."""
    return jax.image.resize(mu, mu.shape[:-2] + (h, w), method="linear")


def _mosaic_dc(mu, block: int):
    """(..., nby, nbx) -> (..., H, W) per-block constant prediction."""
    return jnp.repeat(jnp.repeat(mu, block, axis=-2), block, axis=-1)


def _rate_proxy(q):
    """Per-block exp-Golomb-ish bit estimate of a quantised block tensor
    (..., nby, nbx, B, B) -> (..., nby, nbx)."""
    a = jnp.abs(q)
    bits = jnp.where(a > 0, 2.0 * jnp.floor(jnp.log2(jnp.maximum(a, 1.0)))
                     + 3.0, 0.0)
    return bits.sum(axis=(-1, -2))


def _intra_code_frame(frame, qstep, maxval, block: int,
                      deblock: bool = False, thr_k: int = 0):
    """Intra-code one frame (batched over leading dims) ->
    (q int16 (...,nby,nbx,B,B) with the baseline DC in slot [0,0],
     mode uint8 (...,nby,nbx), rec f32 (...,H,W))."""
    h, w = frame.shape[-2:]
    mu = _block_means(frame, block)
    # the DC slot carries exactly what the baseline would (orthonormal 2D
    # DCT DC = B * mean, quantised at qstep) — identical values, identical
    # entropy cost through the slab's DC band
    dc_q = _quantize(mu * block, qstep, _DZ_INTRA)
    mu_hat = dc_q * (qstep / block)

    def code(pred):
        q = _quantize(dct2d(blockify(frame - pred, block)), qstep,
                      _DZ_INTRA)
        if thr_k:
            q = _threshold_coeffs(q, block, thr_k)
        # the residual DC is reconstructed from the mosaic, never coded
        return q.at[..., 0, 0].set(0.0)

    pred_dc = _mosaic_dc(mu_hat, block)
    pred_pl = _mosaic_planar(mu_hat, h, w)
    q_dc = code(pred_dc)
    q_pl = code(pred_pl)
    use_pl = _rate_proxy(q_pl) < _rate_proxy(q_dc)
    q = jnp.where(use_pl[..., None, None], q_pl, q_dc)
    up = jnp.repeat(jnp.repeat(use_pl, block, axis=-2), block, axis=-1)
    pred = jnp.where(up, pred_pl, pred_dc)
    # exact residual-DC rebuild: block mean of rec must equal mu_hat
    corr = _mosaic_dc(mu_hat - _block_means(pred, block), block)
    rec = jnp.clip(
        jnp.round(pred + corr + deblockify(idct2d(q * qstep))), 0.0, maxval
    )
    if deblock:
        rec = _deblock(rec, qstep, maxval, block)
    q = q.at[..., 0, 0].set(dc_q)
    return q.astype(jnp.int16), use_pl.astype(jnp.uint8), rec


def _intra_rebuild(q, mode, qstep, maxval, block: int,
                   deblock: bool = False):
    """Decode intra frames (batched over leading dims): q (...,nby,nbx,B,B)
    with the block DC in slot [0,0], mode (...,nby,nbx) -> rec f32."""
    nby, nbx = q.shape[-4], q.shape[-3]
    h, w = nby * block, nbx * block
    qf = q.astype(jnp.float32)
    mu_hat = qf[..., 0, 0] * (qstep / block)
    pred_dc = _mosaic_dc(mu_hat, block)
    pred_pl = _mosaic_planar(mu_hat, h, w)
    up = jnp.repeat(jnp.repeat(mode.astype(bool), block, axis=-2),
                    block, axis=-1)
    pred = jnp.where(up, pred_pl, pred_dc)
    corr = _mosaic_dc(mu_hat - _block_means(pred, block), block)
    deq = (qf * qstep).at[..., 0, 0].set(0.0)
    rec = jnp.clip(
        jnp.round(pred + corr + deblockify(idct2d(deq))), 0.0, maxval
    )
    if deblock:
        rec = _deblock(rec, qstep, maxval, block)
    return rec


def _encode_impl(frames, qstep, maxval, block: int, gop: int,
                 deblock: bool = False, thr_k: int = 0,
                 intra: bool = False):
    """frames (F, H, W) any-int/float -> (coeffs int16 (F,nby,nbx,B,B),
    recon uint16 (F,H,W)); with intra also the I-frame mode maps
    ((n_gops, nby, nbx) uint8).  Composable (not jitted)."""
    frames = frames.astype(jnp.float32)
    f, h, w = frames.shape
    n_gops = f // gop
    gframes = frames.reshape(n_gops, gop, h, w)

    def encode_frame(frame, pred, dz=_DZ_INTRA):
        res = frame - pred
        c = dct2d(blockify(res, block))
        q = _quantize(c, qstep, dz)
        if thr_k:
            q = _threshold_coeffs(q, block, thr_k)
        rec = pred + deblockify(idct2d(q * qstep))
        rec = jnp.clip(jnp.round(rec), 0.0, maxval)
        if deblock:
            rec = _deblock(rec, qstep, maxval, block)
        return q.astype(jnp.int16), rec

    mode = None
    if gop == 1:
        if intra:
            q, mode, rec = _intra_code_frame(
                frames, qstep, maxval, block, deblock, thr_k)
        else:
            q, rec = encode_frame(gframes, jnp.zeros_like(gframes))
        q = q.reshape(f, h // block, w // block, block, block)
        rec = rec.reshape(f, h, w)
    else:
        def one_gop(g):
            if intra:
                q0, mode0, rec0 = _intra_code_frame(
                    g[0], qstep, maxval, block, deblock, thr_k)
            else:
                q0, rec0 = encode_frame(g[0], jnp.zeros_like(g[0]),
                                        _DZ_INTRA)

            def step(prev_rec, frame):
                q, rec = encode_frame(frame, prev_rec, _DZ_INTER)
                return rec, (q, rec)

            _, (qs, recs) = jax.lax.scan(step, rec0, g[1:])
            out = (
                jnp.concatenate([q0[None], qs], axis=0),
                jnp.concatenate([rec0[None], recs], axis=0),
            )
            return out + ((mode0,) if intra else ())

        got = jax.vmap(one_gop)(gframes)
        q, rec = got[0], got[1]
        if intra:
            mode = got[2]
        q = q.reshape(f, h // block, w // block, block, block)
        rec = rec.reshape(f, h, w)
    if intra:
        return q, mode, rec.astype(jnp.uint16)
    return q, rec.astype(jnp.uint16)


def _decode_impl(coeffs, qstep, maxval, block: int, gop: int,
                 deblock: bool = False, imode=None):
    """coeffs (F, nby, nbx, B, B) int -> pixels float32 (F, H, W).  With
    imode ((n_gops, nby, nbx)) the I-frames rebuild via intra
    prediction."""
    f, nby, nbx, b, _ = coeffs.shape
    h, w = nby * b, nbx * b
    n_gops = f // gop
    g = coeffs.reshape(n_gops, gop, nby, nbx, b, b).astype(jnp.float32)

    def decode_frame(q, pred):
        rec = pred + deblockify(idct2d(q * qstep))
        rec = jnp.clip(jnp.round(rec), 0.0, maxval)
        if deblock:
            rec = _deblock(rec, qstep, maxval, block)
        return rec

    if gop == 1:
        if imode is not None:
            rec = _intra_rebuild(
                coeffs.astype(jnp.float32), imode, qstep, maxval,
                block, deblock,
            )
        else:
            rec = decode_frame(
                g, jnp.zeros((n_gops, gop, h, w), jnp.float32)
            )
        return rec.reshape(f, h, w)

    def one_gop(gq, gmode=None):
        if gmode is not None:
            rec0 = _intra_rebuild(gq[0], gmode, qstep, maxval, block,
                                  deblock)
        else:
            rec0 = decode_frame(gq[0], jnp.zeros((h, w), jnp.float32))

        def step(prev_rec, q):
            rec = decode_frame(q, prev_rec)
            return rec, rec

        _, recs = jax.lax.scan(step, rec0, gq[1:])
        return jnp.concatenate([rec0[None], recs], axis=0)

    if imode is not None:
        rec = jax.vmap(one_gop)(g, imode)
    else:
        rec = jax.vmap(one_gop)(g)
    return rec.reshape(f, h, w)


def _encode_impl_mc_core(
    frames, weights, qstep, maxval, block: int, gop: int, weighted: bool,
    deblock: bool = False, thr_k: int = 0, intra: bool = False,
):
    """Motion-compensated encode: P frames search the previous recon.
    -> (coeffs, mv (F, nby, nbx) int32, recon) (+ mode maps with intra).
    With weighted=True the search SAD is masked per pixel (occupancy-aware
    RDO, usePccRDO analog); the unweighted specialization traces `weights`
    away (callers pass the frames array itself so no extra bytes cross the
    link)."""
    frames = frames.astype(jnp.float32)
    f, h, w = frames.shape
    nby, nbx = h // block, w // block
    n_gops = f // gop
    gframes = frames.reshape(n_gops, gop, h, w)
    gweights = (
        weights.astype(jnp.float32).reshape(n_gops, gop, h, w)
        if weighted else gframes
    )

    def code(frame, pred, dz):
        res = frame - pred
        q = _quantize(dct2d(blockify(res, block)), qstep, dz)
        if thr_k:
            q = _threshold_coeffs(q, block, thr_k)
        rec = jnp.clip(
            jnp.round(pred + deblockify(idct2d(q * qstep))), 0.0, maxval
        )
        if deblock:
            rec = _deblock(rec, qstep, maxval, block)
        return q.astype(jnp.int16), rec

    lam = qstep * _MC_LAMBDA_SCALE

    def one_gop(g, wg):
        if intra:
            q0, mode0, rec0 = _intra_code_frame(
                g[0], qstep, maxval, block, deblock, thr_k)
        else:
            q0, rec0 = code(g[0], jnp.zeros_like(g[0]), _DZ_INTRA)
        mv0 = jnp.zeros((nby, nbx), jnp.int32)

        def step(prev_rec, fw):
            frame, wt = fw
            mv, pred = _mc_search(
                frame, prev_rec, block, lam, wt if weighted else None
            )
            q, rec = code(frame, pred, _DZ_INTER)
            return rec, (q, mv, rec)

        _, (qs, mvs, recs) = jax.lax.scan(step, rec0, (g[1:], wg[1:]))
        out = (
            jnp.concatenate([q0[None], qs], axis=0),
            jnp.concatenate([mv0[None], mvs], axis=0),
            jnp.concatenate([rec0[None], recs], axis=0),
        )
        return out + ((mode0,) if intra else ())

    got = jax.vmap(one_gop)(gframes, gweights)
    q, mv, rec = got[0], got[1], got[2]
    out = (
        q.reshape(f, nby, nbx, block, block),
        mv.reshape(f, nby, nbx),
        rec.reshape(f, h, w).astype(jnp.uint16),
    )
    if intra:
        return out + (got[3],)
    return out


def _encode_impl_mc(frames, qstep, maxval, block: int, gop: int,
                    deblock: bool = False, thr_k: int = 0,
                    intra: bool = False):
    return _encode_impl_mc_core(
        frames, frames, qstep, maxval, block, gop, weighted=False,
        deblock=deblock, thr_k=thr_k, intra=intra,
    )


def _decode_impl_mc(coeffs, mv, qstep, maxval, block: int, gop: int,
                    deblock: bool = False, imode=None):
    f, nby, nbx, b, _ = coeffs.shape
    h, w = nby * b, nbx * b
    n_gops = f // gop
    g = coeffs.reshape(n_gops, gop, nby, nbx, b, b).astype(jnp.float32)
    gmv = mv.reshape(n_gops, gop, nby, nbx)

    def decode_frame(q, pred):
        rec = pred + deblockify(idct2d(q * qstep))
        rec = jnp.clip(jnp.round(rec), 0.0, maxval)
        if deblock:
            rec = _deblock(rec, qstep, maxval, block)
        return rec

    def one_gop(gq, gm, gmode=None):
        if gmode is not None:
            rec0 = _intra_rebuild(gq[0], gmode, qstep, maxval, block,
                                  deblock)
        else:
            rec0 = decode_frame(gq[0], jnp.zeros((h, w), jnp.float32))

        def step(prev_rec, x):
            q, m = x
            rec = decode_frame(q, _mc_predict(prev_rec, m, b))
            return rec, rec

        _, recs = jax.lax.scan(step, rec0, (gq[1:], gm[1:]))
        return jnp.concatenate([rec0[None], recs], axis=0)

    if imode is not None:
        rec = jax.vmap(one_gop)(g, gmv, imode)
    else:
        rec = jax.vmap(one_gop)(g, gmv)
    return rec.reshape(f, h, w)


def _reencode_with_mv(pixels, mv, qstep, maxval, block: int, gop: int,
                      deblock: bool = False, thr_k: int = 0,
                      intra: bool = False):
    """Re-encode a pixel chain reusing existing motion vectors (the standard
    transcoding shortcut: no second motion search).  With intra, I-frames
    re-code through the mosaic predictors -> also returns the mode maps."""
    f, h, w = pixels.shape
    nby, nbx = h // block, w // block
    n_gops = f // gop
    g = pixels.reshape(n_gops, gop, h, w)
    gmv = mv.reshape(n_gops, gop, nby, nbx)

    def code(frame, pred, dz):
        res = frame - pred
        q = _quantize(dct2d(blockify(res, block)), qstep, dz)
        if thr_k:
            q = _threshold_coeffs(q, block, thr_k)
        rec = jnp.clip(
            jnp.round(pred + deblockify(idct2d(q * qstep))), 0.0, maxval
        )
        if deblock:
            rec = _deblock(rec, qstep, maxval, block)
        return q.astype(jnp.int16), rec

    def one_gop(gp, gm):
        if intra:
            q0, mode0, rec0 = _intra_code_frame(
                gp[0], qstep, maxval, block, deblock, thr_k)
        else:
            q0, rec0 = code(gp[0], jnp.zeros((h, w), jnp.float32),
                            _DZ_INTRA)

        def step(prev_rec, x):
            frame, m = x
            q, rec = code(frame, _mc_predict(prev_rec, m, block), _DZ_INTER)
            return rec, q

        _, qs = jax.lax.scan(step, rec0, (gp[1:], gm[1:]))
        out = (jnp.concatenate([q0[None], qs], axis=0),)
        return out + ((mode0,) if intra else ())

    got = jax.vmap(one_gop)(g, gmv)
    q = got[0].reshape(f, nby, nbx, block, block)
    if intra:
        return q, got[1]
    return q


_encode_device = jax.jit(
    _encode_impl,
    static_argnames=("block", "gop", "deblock", "thr_k", "intra"),
)


def _encode_impl_mc_w(frames, weights, qstep, maxval, block: int, gop: int,
                      deblock: bool = False, thr_k: int = 0,
                      intra: bool = False):
    return _encode_impl_mc_core(
        frames, weights, qstep, maxval, block, gop, weighted=True,
        deblock=deblock, thr_k=thr_k, intra=intra,
    )


_encode_device_mc = jax.jit(
    _encode_impl_mc,
    static_argnames=("block", "gop", "deblock", "thr_k", "intra"),
)
_encode_device_mc_w = jax.jit(
    _encode_impl_mc_w,
    static_argnames=("block", "gop", "deblock", "thr_k", "intra"),
)


def _decode_mc_u16(coeffs, mv, qstep, maxval, block: int, gop: int,
                   deblock: bool = False):
    return _decode_impl_mc(
        coeffs, mv, qstep, maxval, block, gop, deblock
    ).astype(jnp.uint16)


_decode_device_mc = jax.jit(
    _decode_mc_u16, static_argnames=("block", "gop", "deblock")
)


def _decode_mc_u16_intra(coeffs, mv, imode, qstep, maxval, block: int,
                         gop: int, deblock: bool = False):
    return _decode_impl_mc(
        coeffs, mv, qstep, maxval, block, gop, deblock, imode
    ).astype(jnp.uint16)


_decode_device_mc_intra = jax.jit(
    _decode_mc_u16_intra, static_argnames=("block", "gop", "deblock")
)


def _transcode_mc_impl(coeffs, mv, qs_in, qs_out, maxval, block, gop,
                       deblock: bool = False, thr_k: int = 0):
    """Fused MC decode -> MV-reuse re-encode (pixels stay on device)."""
    pixels = _decode_impl_mc(coeffs, mv, qs_in, maxval, block, gop, deblock)
    return _reencode_with_mv(pixels, mv, qs_out, maxval, block, gop, deblock,
                             thr_k)


_transcode_device_mc = jax.jit(
    _transcode_mc_impl,
    static_argnames=("block", "gop", "deblock", "thr_k"),
)


def _transcode_mc_intra_impl(coeffs, mv, imode, qs_in, qs_out, maxval,
                             block, gop, deblock: bool = False,
                             thr_k: int = 0):
    """Fused MC+intra decode -> MV-reuse re-encode with intra I-frames."""
    pixels = _decode_impl_mc(coeffs, mv, qs_in, maxval, block, gop, deblock,
                             imode)
    return _reencode_with_mv(pixels, mv, qs_out, maxval, block, gop, deblock,
                             thr_k, intra=True)


_transcode_device_mc_intra = jax.jit(
    _transcode_mc_intra_impl,
    static_argnames=("block", "gop", "deblock", "thr_k"),
)


def _decode_u16(coeffs, qstep, maxval, block: int, gop: int,
                deblock: bool = False):
    return _decode_impl(coeffs, qstep, maxval, block, gop, deblock).astype(
        jnp.uint16
    )


_decode_device = jax.jit(
    _decode_u16, static_argnames=("block", "gop", "deblock")
)


def _decode_u16_intra(coeffs, imode, qstep, maxval, block: int,
                      gop: int, deblock: bool = False):
    return _decode_impl(
        coeffs, qstep, maxval, block, gop, deblock, imode
    ).astype(jnp.uint16)


_decode_device_intra = jax.jit(
    _decode_u16_intra, static_argnames=("block", "gop", "deblock")
)


def _transcode_impl_fused(
    coeffs, qs_in, qs_out, maxval, block, gop_in, gop_out,
    deblock: bool = False, thr_k: int = 0,
):
    """Fused decode->re-encode: pixels never leave the device."""
    pixels = _decode_impl(coeffs, qs_in, maxval, block, gop_in, deblock)
    return _encode_impl(pixels, qs_out, maxval, block, gop_out, deblock,
                        thr_k)[0]


_transcode_device = jax.jit(
    _transcode_impl_fused,
    static_argnames=("block", "gop_in", "gop_out", "deblock", "thr_k"),
)


def _transcode_intra_impl(
    coeffs, imode, qs_in, qs_out, maxval, block, gop_in, gop_out,
    deblock: bool = False, thr_k: int = 0,
):
    """Fused intra decode -> intra re-encode -> (q, mode)."""
    pixels = _decode_impl(coeffs, qs_in, maxval, block, gop_in, deblock,
                          imode)
    q, mode2, _ = _encode_impl(pixels, qs_out, maxval, block, gop_out,
                               deblock, thr_k, intra=True)
    return q, mode2


_transcode_device_intra = jax.jit(
    _transcode_intra_impl,
    static_argnames=("block", "gop_in", "gop_out", "deblock", "thr_k"),
)


def _requant_impl(q, qstep_old, qstep_new):
    c = q.astype(jnp.float32) * qstep_old
    return jnp.clip(jnp.round(c / qstep_new), -32767, 32767).astype(jnp.int16)


_requant_device = jax.jit(_requant_impl)


def _requant_compensated_impl(q, qstep_old, qstep_new, gop: int):
    """Drift-compensated DCT-domain requantisation for zero-MV P chains.

    Prediction is previous-recon in the pixel domain and the DCT is linear,
    so the requantisation error of every frame can be folded into the NEXT
    frame's residual entirely in the coefficient domain: with
    err_k = sum_{j<=k} (deq_old_j - deq_new_j), the ideal new residual of
    frame k is deq_old_k + err_{k-1}.  Open-loop requant (the naive rescale)
    accumulates that error as reconstruction drift instead — measured
    +0.08 dB D1 at the coarsest CTC rate point (RESULTS.md r1)."""
    f = q.shape[0]
    fp = f + ((-f) % gop)
    qp_ = q
    if fp != f:
        qp_ = jnp.concatenate([q, jnp.zeros((fp - f,) + q.shape[1:], q.dtype)])
    grp = qp_.reshape((fp // gop, gop) + q.shape[1:])

    def per_gop(g):
        def step(err, qk):
            target = qk.astype(jnp.float32) * qstep_old + err
            qn = jnp.clip(
                jnp.round(target / qstep_new), -32767, 32767
            ).astype(jnp.int16)
            return target - qn.astype(jnp.float32) * qstep_new, qn

        _, out = jax.lax.scan(step, jnp.zeros(g.shape[1:], jnp.float32), g)
        return out

    out = jax.vmap(per_gop)(grp).reshape((fp,) + q.shape[1:])
    return out[:f]


_requant_compensated_device = jax.jit(
    _requant_compensated_impl, static_argnames=("gop",),
)


# --- sparse coefficient transfer -------------------------------------------
def _sparsify_impl(q, cap: int):
    flat = q.reshape(-1)
    n = flat.shape[0]
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=n)
    vals = jnp.where(idx < n, flat[jnp.clip(idx, 0, n - 1)], 0)
    return idx.astype(jnp.uint32), vals.astype(jnp.int16)


_sparsify = jax.jit(_sparsify_impl, static_argnames=("cap",))


def _sparsify_frames_impl(q, cap: int):
    """Per-frame compaction (vmapped, frame-local indices) — parallelises the
    nonzero scan across frames instead of one serial pass over the tensor."""
    f = q.shape[0]
    flat = q.reshape(f, -1)
    n = flat.shape[1]

    def one(row):
        (idx,) = jnp.nonzero(row, size=cap, fill_value=n)
        vals = jnp.where(idx < n, row[jnp.clip(idx, 0, n - 1)], 0)
        return idx.astype(jnp.uint32), vals.astype(jnp.int16)

    return jax.vmap(one)(flat)


_sparsify_frames = jax.jit(_sparsify_frames_impl, static_argnames=("cap",))


def _densify_impl(idx, vals, shape):
    n = int(np.prod(shape))
    flat = jnp.zeros((n,), jnp.int16)
    flat = flat.at[idx].set(vals, mode="drop")
    return flat.reshape(shape)


_densify = jax.jit(_densify_impl, static_argnames=("shape",))


def _nnz_impl(q):
    return jnp.count_nonzero(q)


_nnz = jax.jit(_nnz_impl)


def _nnz_per_frame_impl(q):
    return jnp.count_nonzero(q.reshape(q.shape[0], -1), axis=1)


_nnz_per_frame = jax.jit(_nnz_per_frame_impl)


# --- frequency-slab transfer ------------------------------------------------
# Quantised DCT energy concentrates in the lowest zigzag frequencies, so the
# cheapest dense transfer is: reorder coefficients frequency-major and move
# only the slab [0:kmax) where kmax = highest frequency with any energy.
# Pure transpose+slice — no scatter/gather.
def _zigzag_order(n: int) -> np.ndarray:
    idx = sorted(
        ((i, j) for i in range(n) for j in range(n)),
        key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else -p[0]),
    )
    return np.array([i * n + j for i, j in idx], np.int32)


_ZZ_CACHE: dict[int, np.ndarray] = {}
_ZZ_INV_CACHE: dict[int, np.ndarray] = {}


def _zz(n: int) -> np.ndarray:
    if n not in _ZZ_CACHE:
        order = _zigzag_order(n)
        _ZZ_CACHE[n] = order
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order), dtype=np.int32)
        _ZZ_INV_CACHE[n] = inv
    return _ZZ_CACHE[n]


def _to_freq_major_impl(q):
    """(F, nby, nbx, B, B) -> (F, B*B zigzag-ordered, nby, nbx)."""
    f, nby, nbx, b, _ = q.shape
    flatb = q.reshape(f, nby, nbx, b * b)[..., _zz(b)]
    return jnp.transpose(flatb, (0, 3, 1, 2))


_to_freq_major = jax.jit(_to_freq_major_impl)


def _freq_nnz_impl(qf):
    return jnp.count_nonzero(qf, axis=(0, 2, 3))


_freq_nnz = jax.jit(_freq_nnz_impl)


def _from_freq_slab_impl(slab, b: int, kmax: int):
    """(F, kmax, nby, nbx) -> dense (F, nby, nbx, B, B)."""
    f, _, nby, nbx = slab.shape
    full = jnp.zeros((f, b * b, nby, nbx), slab.dtype)
    full = full.at[:, :kmax].set(slab)
    flatb = jnp.transpose(full, (0, 2, 3, 1))[..., jnp.asarray(_zz_inv(b))]
    return flatb.reshape(f, nby, nbx, b, b)


_from_freq_slab = jax.jit(_from_freq_slab_impl,
                          static_argnames=("b", "kmax"))


def _zz_inv(n: int) -> np.ndarray:
    _zz(n)
    return _ZZ_INV_CACHE[n]


_KMAX_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _bucket_kmax(k: int, b2: int) -> int:
    for v in _KMAX_BUCKETS:
        if v >= k and v <= b2:
            return v
    return b2


# ===========================================================================
# Host entropy coding (plane blobs)
# ===========================================================================
def _encode_mv_section(mv: np.ndarray, level: int) -> bytes:
    z = zlib.compress(mv.astype(np.uint8).tobytes(), level)
    return b"M" + struct.pack("<I", len(z)) + z


def _split_mv_section(blob: bytes, f: int, nby: int, nbx: int):
    """-> (mv (F, nby, nbx) int32 or None, coefficient blob)."""
    if blob[:1] != b"M":
        return None, blob
    (zlen,) = struct.unpack_from("<I", blob, 1)
    mv = np.frombuffer(
        zlib.decompress(blob[5 : 5 + zlen]), np.uint8
    ).reshape(f, nby, nbx).astype(np.int32)
    return mv, blob[5 + zlen :]


def _encode_intra_section(mode: np.ndarray, level: int) -> bytes:
    """Intra side info -> 'I' section: the 1-bit-per-block DC-vs-planar
    mode map (packbits + zlib).  The mosaic itself rides in the coefficient
    tensor's DC slots — no side channel for it."""
    mz = zlib.compress(np.packbits(mode.reshape(-1)).tobytes(), level)
    return b"I" + struct.pack("<I", len(mz)) + mz


def _split_intra_section(blob: bytes, n_i: int, nby: int, nbx: int):
    """-> (mode (n_i,nby,nbx) uint8, rest, raw section bytes) or
    (None, blob, b'')."""
    if blob[:1] != b"I":
        return None, blob, b""
    (mlen,) = struct.unpack_from("<I", blob, 1)
    off = 5
    mz = blob[off : off + mlen]
    off += mlen
    n_el = n_i * nby * nbx
    mode = np.unpackbits(
        np.frombuffer(zlib.decompress(mz), np.uint8), count=n_el
    ).reshape(n_i, nby, nbx)
    return mode, blob[off:], blob[:off]


# frequency-band context boundaries (zigzag octaves): DC, low-AC, mid-AC,
# high-AC, tail have very different zero-run/magnitude statistics, so each
# gets its own rANS tables (measured -1.5..-3% slab bytes on dense content;
# a losing candidate on heavily-quantised slabs, where the size race below
# discards it)
_BAND_STARTS = (0, 1, 4, 16, 64)


def _band_plan(kmax: int) -> list[int]:
    """Band start frequencies for a slab of kmax rows."""
    return [s for s in _BAND_STARTS if s < kmax]


def _band_segments(f: int, kmax: int, s_blocks: int, starts: list[int]):
    """Ordered (offset, length, band) covering the (F, kmax, S) slab."""
    bounds = list(starts) + [kmax]
    segs = []
    for fi in range(f):
        base = fi * kmax * s_blocks
        for bi in range(len(starts)):
            k0, k1 = bounds[bi], bounds[bi + 1]
            segs.append((base + k0 * s_blocks, (k1 - k0) * s_blocks, bi))
    return segs


def _encode_coeff_blob(q_dev, level: int = 6) -> bytes:
    """Device coefficient tensor -> entropy blob via the frequency slab:
    only zigzag frequencies [0, kmax) carry energy and only they cross the
    link / enter DEFLATE.  Degrades gracefully to the full tensor
    (kmax = B*B) for dense content."""
    f, nby, nbx, b, _ = q_dev.shape
    b2 = b * b
    qf = _to_freq_major(q_dev)
    fn = np.asarray(_freq_nnz(qf))
    nz = np.nonzero(fn)[0]
    if len(nz) == 0:
        return b"\x03" + struct.pack("<H", 0)
    kmax = _bucket_kmax(int(nz.max()) + 1, b2)
    slab = np.asarray(qf[:, :kmax]).astype(np.int16)
    # DC DPCM across the block raster within each frame
    dc = slab[:, 0].reshape(f, nby * nbx).astype(np.int32)
    dcd = np.diff(dc, axis=1, prepend=0).astype(np.int16)
    slab[:, 0] = dcd.reshape(f, nby, nbx)
    from .. import native

    head = b"\x03" + struct.pack("<H", kmax)
    if native.available():
        # candidate backends race; the smallest wins and decode reads the
        # tag.  'B' = per-frequency-band rANS contexts: DC/low-AC/high-AC
        # statistics differ enough that separate tables buy 1.5-3% on
        # dense slabs, but the extra 516-byte tables LOSE on tiny or
        # heavily-quantised slabs — hence a candidate, never forced.
        # RBV_BANDS=0 removes it from the race (A/B knob).
        import os

        candidates: list[bytes] = []
        starts = _band_plan(kmax)
        if (len(starts) > 1 and slab.nbytes > 64 << 10
                and os.environ.get("RBV_BANDS", "1") != "0"):
            segs = _band_segments(f, kmax, nby * nbx, starts)
            rb = native.compress_i16_bands(slab, segs, len(starts))
            bandhdr = bytes([len(starts)]) + b"".join(
                struct.pack("<H", s) for s in starts
            )
            candidates.append(head + b"B" + bandhdr + rb)
        candidates.append(head + b"R" + native.compress_i16(slab))
        # order-0 rANS wins on noisy coefficients; LZ wins on repetitive
        # structure — race it too for small slabs.  Above 1 MB skip zlib:
        # a level-6 zlib pass over a multi-MB slab costs far more host time
        # than the device step, for a win rANS essentially never concedes
        # on quantised coefficients
        if slab.nbytes <= 1 << 20:
            candidates.append(head + b"Z" + zlib.compress(slab.tobytes(),
                                                          level))
        return min(candidates, key=len)
    return head + b"Z" + zlib.compress(slab.tobytes(), level)


def _encode_dense_blob(q: np.ndarray, level: int) -> bytes:
    f, nby, nbx, b, _ = q.shape
    q16 = q.astype(np.int16)
    dc = q16[:, :, :, 0, 0].reshape(f, nby * nbx).astype(np.int32)
    dcd = np.diff(dc, axis=1, prepend=0).astype(np.int16)
    q16[:, :, :, 0, 0] = dcd.reshape(f, nby, nbx)
    return b"\x00" + zlib.compress(q16.tobytes(), level)


def _decode_coeff_blob(blob: bytes, f: int, nby: int, nbx: int, b: int):
    """Entropy blob -> DEVICE coefficient tensor (int16)."""
    shape = (f, nby, nbx, b, b)
    per_frame = nby * nbx * b * b
    mode = blob[0]
    if mode == 3:
        (kmax,) = struct.unpack_from("<H", blob, 1)
        if kmax == 0:
            return jnp.zeros(shape, jnp.int16)
        backend = blob[3:4]
        n_el = f * kmax * nby * nbx
        if backend == b"B":
            from .. import native

            n_bands = blob[4]
            starts = [
                struct.unpack_from("<H", blob, 5 + 2 * i)[0]
                for i in range(n_bands)
            ]
            segs = _band_segments(f, kmax, nby * nbx, starts)
            slab = native.decompress_i16_bands(
                blob[5 + 2 * n_bands:], n_el, segs, n_bands
            ).reshape(f, kmax, nby, nbx)
        elif backend == b"R":
            from .. import native

            slab = native.decompress_i16(blob[4:], n_el).reshape(
                f, kmax, nby, nbx
            )
        else:
            slab = np.frombuffer(
                zlib.decompress(blob[4:]), np.int16
            ).reshape(f, kmax, nby, nbx).copy()
        dcd = slab[:, 0].reshape(f, nby * nbx).astype(np.int32)
        slab[:, 0] = np.cumsum(dcd, axis=1).reshape(f, nby, nbx).astype(np.int16)
        return _from_freq_slab(jnp.asarray(slab), b, kmax)
    if mode == 2:
        nf, zi_len, zv_len = struct.unpack_from("<III", blob, 1)
        off = 1 + 12
        counts = np.frombuffer(blob[off : off + 4 * nf], np.uint32)
        off += 4 * nf
        deltas = np.frombuffer(
            zlib.decompress(blob[off : off + zi_len]), np.uint32
        )
        vals = np.frombuffer(
            zlib.decompress(blob[off + zi_len : off + zi_len + zv_len]), np.int16
        )
        # frame-local indices -> global flat indices
        idx_local = np.empty(len(deltas), np.int64)
        pos = 0
        for fi in range(nf):
            c = int(counts[fi])
            idx_local[pos : pos + c] = (
                np.cumsum(deltas[pos : pos + c].astype(np.int64))
                + fi * per_frame
            )
            pos += c
        return _densify(
            jnp.asarray(idx_local.astype(np.uint32)), jnp.asarray(vals), shape
        )
    if mode == 1:
        count, zi_len, zv_len = struct.unpack_from("<QII", blob, 1)
        off = 1 + 16
        deltas = np.frombuffer(
            zlib.decompress(blob[off : off + zi_len]), np.uint32
        )
        vals = np.frombuffer(
            zlib.decompress(blob[off + zi_len : off + zi_len + zv_len]), np.int16
        )
        idx = np.cumsum(deltas.astype(np.uint64)).astype(np.uint32)
        return _densify(jnp.asarray(idx), jnp.asarray(vals), shape)
    q16 = np.frombuffer(zlib.decompress(blob[1:]), dtype=np.int16).reshape(
        shape
    ).copy()
    dcd = q16[:, :, :, 0, 0].reshape(f, nby * nbx).astype(np.int32)
    dc = np.cumsum(dcd, axis=1)
    q16[:, :, :, 0, 0] = dc.reshape(f, nby, nbx).astype(np.int16)
    return jnp.asarray(q16)


# ===========================================================================
# Codec API
# ===========================================================================
@dataclasses.dataclass
class RbvParams:
    qp: int = 32
    block_size: int = 16
    gop_size: int = 2
    lossless: bool = False
    zlib_level: int = 6
    # motion-compensated P frames (block search on device, flags bit 1)
    motion: bool = False
    # optional (F, H, W) float weights masking the MC search's distortion
    # (occupancy-aware RDO); encoder-side only, bitstream-compatible
    mc_weight: object = None
    # in-loop deblocking (flags bit 2): HEVC-style weak filter on block
    # boundaries inside the closed loop — P frames predict from the
    # filtered reference.  DEFAULT OFF: the BD-rate A/B
    # (RBV_RD_DEBLOCK_AB=1 scripts/rbv_rd.py) wins only on smooth natural
    # video (moving-texture -6.9%); on V-PCC atlas planes it LOSES
    # (geometry +39..87%, attribute +7..19% BD-rate — patch borders are
    # real edges and the filtered reference inflates P residuals), so
    # V-PCC callers leave it off and natural-video callers opt in
    deblock: bool = False
    # coefficient-level RDO: zero +/-1 coefficients at zigzag rank >=
    # coeff_threshold (0 = off).  Encoder-side only (stream-compatible);
    # the V-PCC encoder/transcoder enable it for GEOMETRY payloads
    # (piecewise-smooth depth: -13..-51% plane bytes at -0.03..-0.06 dB),
    # never for textured attributes where the +/-1s carry real energy
    coeff_threshold: int = 0
    # intra prediction on I-frames (flags bit 3): block-mean mosaic +
    # per-block DC/planar predictor choice — the HEVC intra role in a
    # fully block-parallel form (see _intra_code_frame)
    intra: bool = False


def _plane_dims(width: int, height: int, fmt: ColorFormat) -> list[tuple[int, int]]:
    if fmt == ColorFormat.YUV400:
        return [(height, width)]
    if fmt == ColorFormat.YUV420:
        return [(height, width), (height // 2, width // 2), (height // 2, width // 2)]
    return [(height, width)] * 3


def _pack_header(params_tuple) -> bytes:
    return _HEADER.pack(*params_tuple)


def encode(video: Video, params: RbvParams) -> tuple[bytes, Video]:
    """Encode a Video -> (payload bytes, closed-loop reconstruction)."""
    f = video.frame_count
    use_mc = params.motion and not params.lossless and params.gop_size > 1
    use_db = params.deblock and not params.lossless
    use_intra = params.intra and not params.lossless
    flags = ((1 if params.lossless else 0) | (2 if use_mc else 0)
             | (4 if use_db else 0) | (8 if use_intra else 0))
    header = _HEADER.pack(
        _MAGIC, 2, flags, video.width, video.height, video.bitdepth,
        int(video.format), f, params.block_size, params.gop_size,
        params.qp, 0,
    )
    blobs: list[bytes] = []
    recon_planes: list[np.ndarray] = []
    maxval = float((1 << video.bitdepth) - 1)

    if params.lossless:
        # serialize in the dtype the header's bitdepth implies — decode
        # infers it from bitdepth, not from the caller's array dtype
        ldt = np.uint8 if video.bitdepth <= 8 else np.uint16
        for p in video.planes:
            p = np.ascontiguousarray(p.astype(ldt))
            # binary planes (occupancy) bit-pack 8:1 before DEFLATE
            if p.dtype == np.uint8 and p.max(initial=0) <= 1:
                packed = np.packbits(p.reshape(-1))
                blobs.append(
                    b"P" + zlib.compress(packed.tobytes(), params.zlib_level)
                )
            else:
                blobs.append(
                    b"Z" + zlib.compress(p.tobytes(), params.zlib_level)
                )
            recon_planes.append(p.copy())
    else:
        b = params.block_size
        gop = params.gop_size
        qstep = jnp.float32(qstep_of(params.qp))
        for p in video.planes:
            orig_h, orig_w = p.shape[-2:]
            padded = pad_to_block(p, b)
            fpad = (-f) % gop
            if fpad:
                padded = np.concatenate(
                    [padded, np.repeat(padded[-1:], fpad, axis=0)], axis=0
                )
            mode = None
            if use_mc:
                wplane = params.mc_weight
                if wplane is not None and wplane.shape[-2:] == (orig_h,
                                                                orig_w):
                    # uploaded as uint8 (a quarter of the float32 bytes);
                    # the device program casts to float32
                    wpad = pad_to_block(
                        np.asarray(wplane, np.uint8), b
                    )
                    if fpad:
                        wpad = np.concatenate(
                            [wpad, np.repeat(wpad[-1:], fpad, axis=0)],
                            axis=0,
                        )
                    got = _encode_device_mc_w(
                        jnp.asarray(padded), jnp.asarray(wpad), qstep,
                        jnp.float32(maxval), b, gop, use_db,
                        params.coeff_threshold, use_intra,
                    )
                else:
                    got = _encode_device_mc(
                        jnp.asarray(padded), qstep, jnp.float32(maxval), b,
                        gop, use_db, params.coeff_threshold, use_intra,
                    )
                q, mv, rec = got[0], got[1], got[2]
                if use_intra:
                    mode = got[3]
                blob = _encode_mv_section(np.asarray(mv)[:f],
                                          params.zlib_level)
            else:
                got = _encode_device(
                    jnp.asarray(padded), qstep, jnp.float32(maxval), b, gop,
                    use_db, params.coeff_threshold, use_intra,
                )
                if use_intra:
                    q, mode, rec = got
                else:
                    q, rec = got
                blob = b""
            if use_intra:
                blob += _encode_intra_section(
                    np.asarray(mode), params.zlib_level
                )
            blobs.append(blob + _encode_coeff_blob(q[:f], params.zlib_level))
            rec = np.asarray(rec)[: f, :orig_h, :orig_w]
            recon_planes.append(rec.astype(p.dtype))

    out = bytearray(header)
    for blob in blobs:
        out.extend(struct.pack("<I", len(blob)))
        out.extend(blob)
    recon = Video(video.width, video.height, video.bitdepth, video.format,
                  recon_planes)
    return bytes(out), recon


def _parse_header(payload: bytes):
    magic, ver, flags, width, height, bitdepth, chroma, f, block, gop, qp, _ = (
        _HEADER.unpack_from(payload, 0)
    )
    if magic != _MAGIC:
        raise ValueError("not an RBV bitstream")
    if ver != 2:
        raise ValueError(f"unsupported RBV version {ver}")
    return flags, width, height, bitdepth, chroma, f, block, gop, qp


def _iter_blobs(payload: bytes, n_planes: int):
    pos = _HEADER.size
    for _ in range(n_planes):
        (blob_len,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        yield payload[pos : pos + blob_len]
        pos += blob_len


def decode(payload: bytes) -> Video:
    """Decode an RBV payload -> Video."""
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    fmt = ColorFormat(chroma)
    lossless = bool(flags & 1)
    use_mc = bool(flags & 2)
    use_db = bool(flags & 4)
    use_intra = bool(flags & 8)
    dims = _plane_dims(width, height, fmt)
    dtype = np.uint8 if bitdepth <= 8 else np.uint16
    maxval = float((1 << bitdepth) - 1)
    planes: list[np.ndarray] = []
    for (h, w), blob in zip(dims, _iter_blobs(payload, len(dims))):
        if lossless:
            if blob[:1] == b"P":
                bits = np.unpackbits(
                    np.frombuffer(zlib.decompress(blob[1:]), np.uint8),
                    count=f * h * w,
                )
                planes.append(bits.astype(dtype).reshape(f, h, w))
            else:
                planes.append(
                    np.frombuffer(
                        zlib.decompress(blob[1:]), dtype=dtype
                    ).reshape(f, h, w)
                )
        else:
            ph = h + ((-h) % block)
            pw = w + ((-w) % block)
            fp = f + ((-f) % gop)
            mv, cblob = _split_mv_section(
                blob, f, ph // block, pw // block
            )
            imode = None
            if use_intra:
                imode, cblob, _ = _split_intra_section(
                    cblob, fp // gop, ph // block, pw // block
                )
            q = _decode_coeff_blob(cblob, f, ph // block, pw // block, block)
            if fp != f:
                q = jnp.concatenate(
                    [q, jnp.repeat(q[-1:], fp - f, axis=0)], axis=0
                )
            if use_mc and mv is not None:
                mvp = np.concatenate(
                    [mv, np.repeat(mv[-1:], fp - f, axis=0)], axis=0
                ) if fp != f else mv
                if imode is not None:
                    rec = _decode_device_mc_intra(
                        q, jnp.asarray(mvp), jnp.asarray(imode),
                        jnp.float32(qstep_of(qp)),
                        jnp.float32(maxval), block, gop, use_db,
                    )
                else:
                    rec = _decode_device_mc(
                        q, jnp.asarray(mvp), jnp.float32(qstep_of(qp)),
                        jnp.float32(maxval), block, gop, use_db,
                    )
            elif imode is not None:
                rec = _decode_device_intra(
                    q, jnp.asarray(imode),
                    jnp.float32(qstep_of(qp)), jnp.float32(maxval),
                    block, gop, use_db,
                )
            else:
                rec = _decode_device(
                    q, jnp.float32(qstep_of(qp)), jnp.float32(maxval),
                    block, gop, use_db,
                )
            planes.append(np.asarray(rec)[: f, :h, :w].astype(dtype))
    return Video(width, height, bitdepth, fmt, planes)


def _reencode_lossless(
    payload: bytes, new_qp: int, new_gop: int | None, zlib_level: int
) -> bytes:
    """Lossless input has no coefficient domain: transcoding it to a lossy
    rate point is a first quantisation — full decode -> encode (the
    reference transcoder's behavior on lossless HM input,
    PCCTranscoder.cpp:374 decode/re-encode loop)."""
    _, _, _, _, _, _, block, gop, _ = _parse_header(payload)
    video = decode(payload)
    out, _ = encode(video, RbvParams(
        qp=new_qp, block_size=block, gop_size=max(1, new_gop or gop),
        zlib_level=zlib_level,
    ))
    return out


def requantize(payload: bytes, new_qp: int, zlib_level: int = 6) -> bytes:
    """DCT-domain transcode: re-quantise coefficients to a new QP without a
    pixel-domain round trip.  This is the fast path the reference cannot
    take (its codecs are opaque HM/x265 streams; ours is RBV, so the
    transform domain is directly accessible).  I-frames requantise exactly;
    P-frame residuals requantise open-loop (drift bounded by the GOP length,
    default 2).  Lossless streams take the decode->encode path (a first
    quantisation — there are no coefficients to requantise)."""
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    if flags & 1:
        return _reencode_lossless(payload, new_qp, None, zlib_level)
    if new_qp == qp:
        return payload
    header = _HEADER.pack(
        _MAGIC, 2, flags, width, height, bitdepth, chroma, f, block, gop,
        new_qp, 0,
    )
    dims = _plane_dims(width, height, ColorFormat(chroma))
    qs_old = jnp.float32(qstep_of(qp))
    qs_new = jnp.float32(qstep_of(new_qp))
    out = bytearray(header)
    for (h, w), blob in zip(dims, _iter_blobs(payload, len(dims))):
        ph = h + ((-h) % block)
        pw = w + ((-w) % block)
        mv_section = b""
        cblob = blob
        mv = None
        if flags & 2:
            mv, cblob = _split_mv_section(blob, f, ph // block, pw // block)
            if mv is not None:
                mv_section = _encode_mv_section(mv, zlib_level)
        if flags & 8:
            # the mode map passes through unchanged (the decoder needs the
            # encoder's DC/planar choice); the mosaic rides in the DC slots
            # and rescales with the coefficients like any DC would
            fp_ = f + ((-f) % gop)
            _imode, cblob, raw_i = _split_intra_section(
                cblob, fp_ // gop, ph // block, pw // block
            )
            mv_section += raw_i
        q = _decode_coeff_blob(cblob, f, ph // block, pw // block, block)
        if not (flags & 2) and gop > 1:
            # zero-MV P chains: fold each frame's requantisation error into
            # the next residual (exact in the linear DCT domain) — kills
            # the open-loop drift at no extra link traffic
            q2 = _requant_compensated_device(q, qs_old, qs_new, gop)
        else:
            # MC streams stay open-loop: a zero-MV-masked compensation was
            # measured (8-frame CTC ladder A/B) to lower plane MSE but
            # WORSEN end-to-end D1 at the r1/r5 extremes — the error
            # feedback perturbs the background fill that occupancy-
            # precision superset points sample — so the simple rescale wins
            # on the metric that matters (mean d1_delta -0.030 vs +0.056)
            q2 = _requant_device(q, qs_old, qs_new)
        new_blob = mv_section + _encode_coeff_blob(q2, zlib_level)
        out.extend(struct.pack("<I", len(new_blob)))
        out.extend(new_blob)
    return bytes(out)


def transcode_payload(
    payload: bytes,
    new_qp: int,
    new_gop: int | None = None,
    zlib_level: int = 6,
    coeff_threshold: int = 0,
) -> bytes:
    """Drift-free transcode: fused decode->re-encode ON DEVICE (pixels never
    cross the host link).  The reference's transcodeVideo hot loop
    (PCCTranscoder.cpp:374) re-designed for the accelerator: host does only
    entropy; the link carries only sparse coefficients."""
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    if flags & 1:
        return _reencode_lossless(payload, new_qp, new_gop, zlib_level)
    use_mc = bool(flags & 2)
    use_db = bool(flags & 4)
    use_intra = bool(flags & 8)
    # MC streams keep their GOP structure (motion vectors are bound to it)
    gop_out = gop if use_mc else (new_gop or gop)
    header = _HEADER.pack(
        _MAGIC, 2, flags, width, height, bitdepth, chroma, f, block, gop_out,
        new_qp, 0,
    )
    dims = _plane_dims(width, height, ColorFormat(chroma))
    qs_in = jnp.float32(qstep_of(qp))
    qs_out = jnp.float32(qstep_of(new_qp))
    maxval = jnp.float32((1 << bitdepth) - 1)

    # per-plane tasks run in a thread pool: host entropy (inflate/deflate)
    # overlaps across planes while the device queue serialises the compute;
    # output order is preserved by ex.map
    import concurrent.futures as cf

    plane_blobs = list(_iter_blobs(payload, len(dims)))

    def one_plane(args):
        (h, w), blob = args
        ph = h + ((-h) % block)
        pw = w + ((-w) % block)
        nby, nbx = ph // block, pw // block
        mv = None
        cblob = blob
        if use_mc:
            mv, cblob = _split_mv_section(blob, f, nby, nbx)
        imode = None
        fp_in = f + ((-f) % gop)
        if use_intra:
            imode, cblob, _ = _split_intra_section(
                cblob, fp_in // gop, nby, nbx
            )
        q = _decode_coeff_blob(cblob, f, nby, nbx, block)
        if fp_in != f:
            q = jnp.concatenate(
                [q, jnp.repeat(q[-1:], fp_in - f, axis=0)], axis=0
            )
        if use_mc and mv is not None:
            mvp = (
                np.concatenate([mv, np.repeat(mv[-1:], fp_in - f, axis=0)])
                if fp_in != f
                else mv
            )
            if imode is not None:
                q2, mode2 = _transcode_device_mc_intra(
                    q, jnp.asarray(mvp), jnp.asarray(imode),
                    qs_in, qs_out, maxval, block, gop, use_db,
                    coeff_threshold,
                )
                return (
                    _encode_mv_section(mv, zlib_level)
                    + _encode_intra_section(np.asarray(mode2), zlib_level)
                    + _encode_coeff_blob(q2[:f], zlib_level)
                )
            q2 = _transcode_device_mc(
                q, jnp.asarray(mvp), qs_in, qs_out, maxval, block, gop,
                use_db, coeff_threshold,
            )[:f]
            return _encode_mv_section(mv, zlib_level) + _encode_coeff_blob(
                q2, zlib_level
            )
        fp_out = fp_in + ((-fp_in) % gop_out)
        if fp_out != fp_in:
            q = jnp.concatenate(
                [q, jnp.repeat(q[-1:], fp_out - fp_in, axis=0)], axis=0
            )
        if imode is not None:
            n_i_out = (f + ((-f) % gop_out)) // gop_out
            # frame padding for gop_out can add whole input-side GOPs of
            # repeated tail frames; give them the tail mode map (their
            # decode is dropped by the [:f] slice anyway)
            n_i_pad = q.shape[0] // gop
            if len(imode) < n_i_pad:
                reps = n_i_pad - len(imode)
                imode = np.concatenate(
                    [imode, np.repeat(imode[-1:], reps, axis=0)]
                )
            q2, mode2 = _transcode_device_intra(
                q, jnp.asarray(imode), qs_in, qs_out,
                maxval, block, gop, gop_out, use_db, coeff_threshold,
            )
            return (
                _encode_intra_section(np.asarray(mode2)[:n_i_out],
                                      zlib_level)
                + _encode_coeff_blob(q2[:f], zlib_level)
            )
        q2 = _transcode_device(
            q, qs_in, qs_out, maxval, block, gop, gop_out, use_db,
            coeff_threshold,
        )[:f]
        return _encode_coeff_blob(q2, zlib_level)

    out = bytearray(header)
    with cf.ThreadPoolExecutor(max_workers=max(1, len(dims))) as ex:
        blobs = list(ex.map(one_plane, zip(dims, plane_blobs)))
    for full in blobs:
        out.extend(struct.pack("<I", len(full)))
        out.extend(full)
    return bytes(out)


def probe(payload: bytes) -> dict:
    """Read stream parameters without decoding (the PccHevcParser-analog
    width/height/bitdepth probe the transcoder needs)."""
    flags, width, height, bitdepth, chroma, f, block, gop, qp = _parse_header(
        payload
    )
    return {
        "width": width, "height": height, "bitdepth": bitdepth,
        "format": ColorFormat(chroma), "frame_count": f,
        "block_size": block, "gop_size": gop, "qp": qp,
        "lossless": bool(flags & 1),
        "motion": bool(flags & 2),
        "deblock": bool(flags & 4),
        "intra": bool(flags & 8),
    }
