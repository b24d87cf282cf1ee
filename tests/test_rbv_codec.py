"""Unit tests: the RBV video codec (transforms, closed loop, container)."""

import numpy as np
import pytest

from rabbit_transcoding_tpu.core.image import Video
from rabbit_transcoding_tpu.ops import dct
from rabbit_transcoding_tpu.utils.enums import CodecId, ColorFormat
from rabbit_transcoding_tpu.video import VideoDecoder, VideoEncoder, VideoEncoderParams
from rabbit_transcoding_tpu.video import rbv

import jax.numpy as jnp


def psnr(a, b, maxval):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return np.inf
    return 10 * np.log10(maxval * maxval / mse)


def smooth_video(frames=4, h=64, w=96, bitdepth=8, fmt=ColorFormat.YUV420, seed=0):
    """Synthetic smooth moving-gradient video (codec-friendly, like depth maps)."""
    rng = np.random.default_rng(seed)
    maxval = (1 << bitdepth) - 1
    dtype = np.uint8 if bitdepth <= 8 else np.uint16
    v = Video.zeros(frames, w, h, bitdepth, fmt)
    for c, p in enumerate(v.planes):
        hh, ww = p.shape[1:]
        y, x = np.mgrid[0:hh, 0:ww]
        for f in range(frames):
            img = (
                maxval / 2
                + maxval / 4 * np.sin(2 * np.pi * (x + 5 * f) / ww)
                * np.cos(2 * np.pi * (y - 3 * f) / hh)
            )
            img += rng.normal(0, maxval * 0.005, img.shape)
            p[f] = np.clip(img, 0, maxval).astype(dtype)
    return v


class TestDctOps:
    def test_dct_orthonormal(self):
        d = dct.dct_matrix(16)
        np.testing.assert_allclose(d @ d.T, np.eye(16), atol=1e-5)

    def test_dct_idct_roundtrip(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(10, 16, 16)).astype(np.float32))
        y = dct.idct2d(dct.dct2d(x))
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-3)

    def test_blockify_roundtrip(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.normal(size=(3, 64, 96)).astype(np.float32))
        b = dct.blockify(x, 16)
        assert b.shape == (3, 4, 6, 16, 16)
        np.testing.assert_array_equal(np.asarray(dct.deblockify(b)), np.asarray(x))

    def test_dc_coefficient(self):
        x = jnp.full((1, 16, 16), 100.0)
        c = np.asarray(dct.dct2d(x))
        assert abs(c[0, 0, 0] - 100.0 * 16) < 1e-2  # DC = N * mean
        assert np.abs(c[0]).sum() - abs(c[0, 0, 0]) < 1e-2  # all energy in DC


class TestRbvCodec:
    @pytest.mark.parametrize("gop", [1, 2, 4])
    def test_closed_loop_recon_matches_decode(self, gop):
        v = smooth_video(frames=4)
        payload, recon = rbv.encode(v, rbv.RbvParams(qp=28, gop_size=gop))
        dec = rbv.decode(payload)
        for a, b in zip(recon.planes, dec.planes):
            np.testing.assert_array_equal(a, b)

    def test_quality_vs_qp(self):
        v = smooth_video(frames=2)
        qualities = []
        sizes = []
        for qp in (12, 24, 36):
            payload, _ = rbv.encode(v, rbv.RbvParams(qp=qp, gop_size=1))
            dec = rbv.decode(payload)
            qualities.append(psnr(v.planes[0], dec.planes[0], 255))
            sizes.append(len(payload))
        assert qualities[0] > qualities[1] > qualities[2]
        assert sizes[0] > sizes[1] > sizes[2]
        assert qualities[0] > 45  # near-transparent at QP 12 on smooth content
        assert qualities[1] > 38

    def test_lossless(self):
        v = smooth_video(frames=3, bitdepth=10)
        payload, recon = rbv.encode(v, rbv.RbvParams(lossless=True))
        dec = rbv.decode(payload)
        for a, b in zip(v.planes, dec.planes):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(v.planes, recon.planes):
            np.testing.assert_array_equal(a, b)

    def test_10bit_geometry_like(self):
        v = smooth_video(frames=2, bitdepth=10, fmt=ColorFormat.YUV400)
        payload, _ = rbv.encode(v, rbv.RbvParams(qp=16, gop_size=2))
        dec = rbv.decode(payload)
        assert dec.bitdepth == 10 and dec.planes[0].dtype == np.uint16
        assert psnr(v.planes[0], dec.planes[0], 1023) > 45

    def test_nonmultiple_dimensions(self):
        v = smooth_video(frames=3, h=50, w=70, fmt=ColorFormat.YUV400)
        payload, _ = rbv.encode(v, rbv.RbvParams(qp=20, gop_size=2))
        dec = rbv.decode(payload)
        assert dec.planes[0].shape == (3, 50, 70)
        assert psnr(v.planes[0], dec.planes[0], 255) > 38

    def test_probe(self):
        v = smooth_video(frames=2, bitdepth=10, fmt=ColorFormat.YUV400)
        payload, _ = rbv.encode(v, rbv.RbvParams(qp=18))
        info = rbv.probe(payload)
        assert info["width"] == 96 and info["height"] == 64
        assert info["bitdepth"] == 10 and info["frame_count"] == 2
        assert info["qp"] == 18 and not info["lossless"]

    def test_not_rbv_raises(self):
        with pytest.raises(ValueError):
            rbv.decode(b"JUNKJUNKJUNKJUNKJUNKJUNK")

    def test_p_frames_predict_static_content(self):
        # on static content, P-frame residuals must quantise to (nearly)
        # all-zero coefficients — the device-level prediction property.
        # (At the entropy layer, sparse+DEFLATE also dedupes identical intra
        # frames, so payload size alone no longer isolates the P gain.)
        import jax.numpy as jnp
        from rabbit_transcoding_tpu.video.rbv import _encode_device, qstep_of

        v = smooth_video(frames=4, h=256, w=256, fmt=ColorFormat.YUV400, seed=3)
        frames = jnp.asarray(np.repeat(v.planes[0][:1], 4, axis=0))
        qs = jnp.float32(qstep_of(24))
        q_intra, _ = _encode_device(frames, qs, jnp.float32(255.0), 16, 1)
        q_gop4, _ = _encode_device(frames, qs, jnp.float32(255.0), 16, 4)
        nnz_intra = int(np.count_nonzero(np.asarray(q_intra)[1:]))
        nnz_p = int(np.count_nonzero(np.asarray(q_gop4)[1:]))
        # a few residual coefficients may exceed qstep/2 where the I recon
        # differs from the source (quant error); P frames must still be
        # orders of magnitude sparser than intra
        assert nnz_p < 0.05 * nnz_intra, (nnz_p, nnz_intra)
        assert nnz_intra > 1000
        # and the payload must not regress vs all-intra
        for p in v.planes:
            p[1:] = p[0]
        p_all_intra, _ = rbv.encode(v, rbv.RbvParams(qp=24, gop_size=1))
        p_gop4, _ = rbv.encode(v, rbv.RbvParams(qp=24, gop_size=4))
        assert len(p_gop4) <= 1.02 * len(p_all_intra)


class TestFactory:
    def test_factory_roundtrip(self):
        v = smooth_video(frames=2)
        enc = VideoEncoder.create(CodecId.RBV)
        payload, recon = enc.encode(v, VideoEncoderParams(qp=24))
        dec = VideoDecoder.create(CodecId.RBV).decode(payload)
        for a, b in zip(recon.planes, dec.planes):
            np.testing.assert_array_equal(a, b)

    def test_lossless_codec_id(self):
        v = smooth_video(frames=2, fmt=ColorFormat.YUV400)
        enc = VideoEncoder.create(CodecId.RBV_LOSSLESS)
        payload, _ = enc.encode(v, VideoEncoderParams())
        dec = VideoDecoder.create(CodecId.RBV).decode(payload)
        np.testing.assert_array_equal(v.planes[0], dec.planes[0])

    def test_bitdepth_align_on_decode(self):
        v = smooth_video(frames=2, bitdepth=8, fmt=ColorFormat.YUV400)
        enc = VideoEncoder.create(CodecId.RBV)
        payload, _ = enc.encode(v, VideoEncoderParams(qp=20))
        dec = VideoDecoder.create(CodecId.RBV).decode(payload, output_bitdepth=10)
        assert dec.bitdepth == 10


class TestCompensatedRequant:
    """Drift-compensated DCT-domain requant: each frame's requantisation
    error folds into the next residual (linear DCT), so zero-MV P chains
    track the drift-free decode->re-encode within clipping error."""

    def _video(self, frames=8, w=64, h=48):
        import numpy as np

        from rabbit_transcoding_tpu.core.image import Video
        from rabbit_transcoding_tpu.utils.enums import ColorFormat

        yy, xx = np.mgrid[0:h, 0:w]
        planes = np.stack([
            np.clip(
                300 + 150 * np.sin((xx + 3 * f) / 9.0)
                * np.cos((yy - 2 * f) / 7.0),
                0, 1023,
            ).astype(np.uint16)
            for f in range(frames)
        ])
        return Video(w, h, 10, ColorFormat.YUV400, [planes])

    def test_requant_tracks_driftfree_reencode(self, monkeypatch):
        import numpy as np

        from rabbit_transcoding_tpu.video import rbv

        video = self._video()
        payload, _ = rbv.encode(
            video, rbv.RbvParams(qp=10, gop_size=4, motion=False)
        )
        hi = 28
        ref = np.asarray(
            rbv.decode(rbv.transcode_payload(payload, hi)).planes[0]
        ).astype(np.float64)
        comp = np.asarray(
            rbv.decode(rbv.requantize(payload, hi)).planes[0]
        ).astype(np.float64)
        # open-loop baseline: force the naive rescale kernel
        monkeypatch.setattr(
            rbv, "_requant_compensated_device",
            lambda q, a, b, gop: rbv._requant_device(q, a, b),
        )
        open_loop = np.asarray(
            rbv.decode(rbv.requantize(payload, hi)).planes[0]
        ).astype(np.float64)
        # last frame of each GOP carries the accumulated drift
        last = slice(3, None, 4)
        mse_comp = float(np.mean((comp[last] - ref[last]) ** 2))
        mse_open = float(np.mean((open_loop[last] - ref[last]) ** 2))
        assert mse_comp < mse_open * 0.5, (mse_comp, mse_open)


class TestFusedTranscode:
    """The fused decode->re-encode device program (what every reencode
    transcode of a P-chain stream runs) against its plain reference: the
    decode program, pixels on the host, then the encode program."""

    @pytest.mark.parametrize("gop", [1, 2, 4])
    def test_matches_unfused_reference(self, gop):
        f, h, w = 8, 48, 64
        v = smooth_video(frames=f, h=h, w=w, bitdepth=10,
                         fmt=ColorFormat.YUV400, seed=gop)
        payload, _ = rbv.encode(v, rbv.RbvParams(qp=16, gop_size=gop))
        blob = next(rbv._iter_blobs(payload, 1))
        q = rbv._decode_coeff_blob(blob, f, h // 16, w // 16, 16)
        qs_in = jnp.float32(rbv.qstep_of(16))
        qs_out = jnp.float32(rbv.qstep_of(30))
        maxval = jnp.float32(1023.0)
        fused = np.asarray(rbv._transcode_device(
            q, qs_in, qs_out, maxval, 16, gop, gop))
        pixels = np.asarray(rbv._decode_device(q, qs_in, maxval, 16, gop))
        ref, _ = rbv._encode_device(jnp.asarray(pixels), qs_out, maxval,
                                    16, gop)
        assert fused.shape == (f, h // 16, w // 16, 16, 16)
        assert np.count_nonzero(fused) > 0
        np.testing.assert_array_equal(fused, np.asarray(ref))


class TestDeblock:
    """In-loop deblocking (flags bit 2).  Default OFF for V-PCC atlas
    content (BD-rate A/B in scripts/rbv_rd.py: it loses there and wins
    only on smooth natural video) — these tests pin the closed loop and
    flag plumbing, not a quality claim."""

    def _video(self, f=8, mc=False):
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(0)
        h = w = 96
        base = gaussian_filter(rng.normal(size=(h + f * 4, w + f * 4)),
                               4) * 300 + 500
        frames = np.stack([
            np.clip(base[4 * i:4 * i + h, 4 * i:4 * i + w], 0,
                    1023).astype(np.uint16)
            for i in range(f)
        ])
        return Video(w, h, 10, ColorFormat.YUV400, [frames])

    @pytest.mark.parametrize("mc", [False, True])
    def test_closed_loop(self, mc):
        vid = self._video(mc=mc)
        payload, recon = rbv.encode(
            vid, rbv.RbvParams(qp=30, gop_size=4, motion=mc, deblock=True)
        )
        assert rbv.probe(payload)["deblock"] is True
        back = rbv.decode(payload)
        assert np.array_equal(np.asarray(recon.planes[0]),
                              np.asarray(back.planes[0]))

    def test_flag_survives_transcode_and_requant(self):
        vid = self._video()
        payload, _ = rbv.encode(
            vid, rbv.RbvParams(qp=28, gop_size=4, deblock=True)
        )
        assert rbv.probe(rbv.transcode_payload(payload, 34))["deblock"]
        assert rbv.probe(rbv.requantize(payload, 34))["deblock"]
        # and decodes consistently after each
        rbv.decode(rbv.transcode_payload(payload, 34))
        rbv.decode(rbv.requantize(payload, 34))

    def test_helps_on_smooth_natural_video(self):
        """The regime the filter exists for: same QP, higher PSNR."""
        vid = self._video()
        src = np.asarray(vid.planes[0], np.float64)

        def quality(db):
            _, rec = rbv.encode(
                vid, rbv.RbvParams(qp=32, gop_size=4, deblock=db)
            )
            mse = np.mean((np.asarray(rec.planes[0], np.float64) - src) ** 2)
            return 10 * np.log10(1023.0 ** 2 / mse)

        assert quality(True) > quality(False) + 0.3


class TestCoeffThreshold:
    """Coefficient-level RDO (RbvParams.coeff_threshold): encoder-side
    only, so the payload needs no flag and old decoders read it."""

    def _depth_video(self, f=4):
        rng = np.random.default_rng(1)
        h = w = 128
        yy, xx = np.mgrid[0:h, 0:w]
        frames = np.stack([
            (400 + 100 * np.sin((xx + 2 * t) / 19.0) * np.cos(yy / 23.0)
             + rng.normal(0, 2, (h, w))).astype(np.uint16)
            for t in range(f)
        ])
        return Video(w, h, 10, ColorFormat.YUV400, [frames])

    def test_saves_bytes_small_quality_cost(self):
        """At the operating QP where isolated +/-1 coefficients are mostly
        quantisation noise (qp 28 on piecewise-smooth depth), dropping
        them buys a real byte saving for near-zero PSNR cost."""
        vid = self._depth_video()
        src = np.asarray(vid.planes[0], np.float64)
        p0, r0 = rbv.encode(vid, rbv.RbvParams(qp=28, gop_size=2))
        p1, r1 = rbv.encode(
            vid, rbv.RbvParams(qp=28, gop_size=2, coeff_threshold=16)
        )
        assert len(p1) < 0.9 * len(p0), (len(p1), len(p0))

        def psnr(r):
            mse = np.mean((np.asarray(r.planes[0], np.float64) - src) ** 2)
            return 10 * np.log10(1023.0 ** 2 / mse)

        assert psnr(r1) > psnr(r0) - 0.1, (psnr(r1), psnr(r0))

    def test_stream_compatible(self):
        """Thresholded payloads decode with the standard decoder and the
        closed loop still holds."""
        vid = self._depth_video()
        payload, recon = rbv.encode(
            vid, rbv.RbvParams(qp=22, gop_size=2, coeff_threshold=16)
        )
        back = rbv.decode(payload)
        assert np.array_equal(np.asarray(recon.planes[0]),
                              np.asarray(back.planes[0]))

    def test_transcode_payload_threshold(self):
        vid = self._depth_video()
        payload, _ = rbv.encode(vid, rbv.RbvParams(qp=12, gop_size=2))
        t0 = rbv.transcode_payload(payload, 22)
        t1 = rbv.transcode_payload(payload, 22, coeff_threshold=16)
        assert len(t1) < len(t0)
        rbv.decode(t1)


class TestIntraPrediction:
    """RBV intra (flags bit 3): mosaic DC/planar on I-frames — the HEVC
    intra role (PCCHMLibVideoEncoderImpl.cpp:92-193) in block-parallel
    form.  BD-rate evidence: RBV_RD_INTRA_AB=1 scripts/rbv_rd.py."""

    def _video(self, f=6, h=80, w=96):
        # piecewise-smooth depth-like content with a gradient (the regime
        # intra exists for) plus a hard step edge (the regime the per-block
        # DC fallback exists for)
        yy, xx = np.mgrid[0:h, 0:w]
        frames = []
        for i in range(f):
            p = (yy * 4 + xx * 3 + 20 * i) % 900 + 60
            p[:, w // 2:] = 120  # flat region behind a depth step
            frames.append(p.astype(np.uint16))
        return Video(w, h, 10, ColorFormat.YUV400, [np.stack(frames)])

    @pytest.mark.parametrize("gop,mc", [(1, False), (2, False), (3, True)])
    def test_closed_loop(self, gop, mc):
        vid = self._video()
        payload, recon = rbv.encode(
            vid, rbv.RbvParams(qp=26, gop_size=gop, motion=mc, intra=True)
        )
        assert rbv.probe(payload)["intra"] is True
        back = rbv.decode(payload)
        assert np.array_equal(np.asarray(recon.planes[0]),
                              np.asarray(back.planes[0]))

    def test_flag_survives_transcode_and_requant(self):
        vid = self._video()
        payload, _ = rbv.encode(
            vid, rbv.RbvParams(qp=22, gop_size=2, intra=True)
        )
        t = rbv.transcode_payload(payload, 32)
        r = rbv.requantize(payload, 32)
        assert rbv.probe(t)["intra"] and rbv.probe(r)["intra"]
        rbv.decode(t)
        rbv.decode(r)

    def test_requant_keeps_mode_map_verbatim(self):
        """The I section (the mode map) must pass through requantisation
        untouched: the decoder needs the encoder's DC/planar choice; the
        mosaic itself rides in the DC slots and rescales like any DC."""
        vid = self._video()
        payload, _ = rbv.encode(
            vid, rbv.RbvParams(qp=22, gop_size=2, intra=True)
        )
        from rabbit_transcoding_tpu.video.rbv import (
            _iter_blobs, _parse_header, _plane_dims, _split_intra_section,
        )

        def isection(pay):
            flags, w, h, bd, ch, f, blk, gop, qp = _parse_header(pay)
            (ph, pw), = _plane_dims(w, h, ColorFormat(ch))
            blob = next(_iter_blobs(pay, 1))
            fp = f + ((-f) % gop)
            return _split_intra_section(
                blob, fp // gop, (ph + (-ph) % blk) // blk,
                (pw + (-pw) % blk) // blk)[2]

        assert isection(payload) == isection(rbv.requantize(payload, 34))

    def test_wins_on_atlas_geometry(self):
        """BD-rate over a small QP ladder must favor intra on REAL atlas
        geometry video (patch layout + push-pull padding — the content the
        tool ships for; synthetic gradients are fully absorbed by the DC
        DPCM and show nothing).  Slow-marked: runs the real encoder once."""
        from rabbit_transcoding_tpu.core.gof import GroupOfFrames
        from rabbit_transcoding_tpu.encoder.encoder import Encoder
        from rabbit_transcoding_tpu.encoder.params import EncoderParameters
        from rabbit_transcoding_tpu.testdata import make_frame
        from rabbit_transcoding_tpu.utils.enums import CodecId, VideoType
        from rabbit_transcoding_tpu.video import VideoDecoder

        srcs = GroupOfFrames([make_frame(i, n=15000) for i in range(4)])
        enc = Encoder(EncoderParameters(
            minimumImageWidth=512, minimumImageHeight=128,
            geometryQP=4, attributeQP=4, occupancyPrecision=2))
        ctx, _ = enc.encode(srcs)
        vid = VideoDecoder.create(CodecId.RBV).decode(
            ctx.atlas(0).video_bitstreams[VideoType.GEOMETRY].data)
        src = np.asarray(vid.planes[0], np.float64)

        def ladder(intra):
            pts = []
            for qp in (16, 22, 28, 34):
                pay, rec = rbv.encode(
                    vid, rbv.RbvParams(qp=qp, gop_size=1, intra=intra))
                mse = max(1e-9, float(np.mean(
                    (np.asarray(rec.planes[0], np.float64) - src) ** 2)))
                pts.append((len(pay), 10 * np.log10(1023.0**2 / mse)))
            return pts

        a, t = ladder(False), ladder(True)
        ra, pa = np.log10([r for r, _ in a]), [p for _, p in a]
        rt, pt = np.log10([r for r, _ in t]), [p for _, p in t]
        lo, hi = max(min(pa), min(pt)), min(max(pa), max(pt))
        ia = np.polyint(np.polyfit(pa, ra, 3))
        it = np.polyint(np.polyfit(pt, rt, 3))
        avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
        avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
        bd = (10 ** (avg_t - avg_a) - 1) * 100
        assert bd < 0, f"intra BD-rate {bd:+.2f}% (should win)"

    def test_gop_restructure(self):
        vid = self._video(f=5)
        payload, _ = rbv.encode(
            vid, rbv.RbvParams(qp=22, gop_size=3, intra=True)
        )
        t = rbv.transcode_payload(payload, 30, new_gop=2)
        d = rbv.decode(t)
        assert d.planes[0].shape == vid.planes[0].shape
