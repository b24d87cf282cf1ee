#!/usr/bin/env python
"""On-card smoke test of the live V3C transcoder.

Drives the served path once on one GPU, at the full width of the bench
stream, and compares every phase with the same work on the host's CPU
device in the same process (a second process could not get card memory):

  phase 0  JAX's devices are GPUs and the native rANS entropy coder built;
  phase 1  ``rabbit-stream`` (apps.stream.main) transcodes the 1024x1024,
           32-frame bench stream at geometryQP 32 / attributeQP 42: one GOF
           cold, then three warm.  The output is compared with the CPU's;
  phase 2  Encoder (motion compensation + intra, the shipping stream
           shape) -> Transcoder in auto mode -> Decoder on the dense vox10
           scene, with the closed-loop checksum and D1/D2/colour PSNR,
           D1 compared with the CPU run;
  phase 3  RBV payloads encoded on the CPU decode on the GPU.

``--four-gpus`` runs only the sharded multi-stream path (what
``rabbit-stream --sharded`` runs) on a 2x2 mesh of four cards, with the
sequential single-card transcode it must reproduce.

Prints the card's name and power limit, every phase's wall time and
comparison figures, and as its last line one JSON object
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, on
any failure and when JAX finds no GPU.

    python chip_smoke.py [--four-gpus]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Output of the GPU against the CPU (phase 1, and the sharded path against
# the sequential one).  The two backends run the same float32 programs,
# but XLA orders sums differently, so a coefficient whose value sits on a
# quantiser decision boundary can round the other way.  On an H100 (700 W)
# 1.8e-7 of the bench stream's coefficients differed (max pixel
# difference 3, plane PSNR 101 dB); these bounds allow ~50x that and fail
# on anything systematic.
MAX_COEFF_DIFF_SHARE = 1e-5
MIN_PLANE_PSNR_DB = 80.0
# D1 of the GPU's phase-2 loop against the CPU's: the repo's D1 bar
MAX_D1_DELTA_DB = 0.05
# Phase 3: pixels of a CPU-encoded payload decoded on the GPU that may
# differ from the CPU decode (the same rounding flips, carried through the
# P chain).  Measured on an H100 (700 W): 1.05e-5 (P chain) and 1.4e-6
# (MC + intra), max difference 1.
MAX_XDECODE_PIXEL_SHARE = 1e-4

GEOMETRY_QP = 32
ATTRIBUTE_QP = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


@contextlib.contextmanager
def on_device(device):
    """Make ``device`` JAX's default device in every thread (the stream
    app and the codec run work in thread pools) for the ``with`` body."""
    import jax

    prev = jax.config.jax_default_device
    jax.config.update("jax_default_device", device)
    try:
        yield
    finally:
        jax.config.update("jax_default_device", prev)


# ---------------------------------------------------------------------------
# Comparison of two transcoder outputs
# ---------------------------------------------------------------------------
def _rbv_coefficients(payload: bytes) -> list:
    """Quantised coefficients (and motion/mode side info) of every plane
    of a lossy RBV payload, as numpy arrays."""
    import numpy as np

    from rabbit_transcoding_tpu.utils.enums import ColorFormat
    from rabbit_transcoding_tpu.video import rbv

    flags, w, h, _, chroma, f, block, gop, _ = rbv._parse_header(payload)
    dims = rbv._plane_dims(w, h, ColorFormat(chroma))
    out = []
    for (ph, pw), blob in zip(dims, rbv._iter_blobs(payload, len(dims))):
        nby, nbx = -(-ph // block), -(-pw // block)
        side = []
        if flags & 2:
            mv, blob = rbv._split_mv_section(blob, f, nby, nbx)
            side.append(mv)
        if flags & 8:
            fp = f + ((-f) % gop)
            mode, blob, _ = rbv._split_intra_section(blob, fp // gop, nby,
                                                     nbx)
            side.append(mode)
        q = np.asarray(rbv._decode_coeff_blob(blob, f, nby, nbx, block))
        out.append((q, side))
    return out


def _plane_psnr(a, b, bitdepth: int) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0.0:
        return math.inf
    return 10.0 * math.log10(((1 << bitdepth) - 1) ** 2 / mse)


def compare_streams(a: bytes, b: bytes) -> dict:
    """Compare two V3C streams of the same layout, video by video.

    -> {"identical", "coeff_diff_share", "max_abs_diff", "min_psnr_db",
        "planes": [...]}.  Coefficients are the quantised RBV coefficients
    of every lossy plane, counted over the videos whose bytes differ;
    pixels are both payloads decoded by the same decoder; side info (motion
    vectors, intra modes) must match exactly."""
    import numpy as np

    from rabbit_transcoding_tpu.bitstream import V3CReader
    from rabbit_transcoding_tpu.video import rbv

    if a == b:
        return {"identical": True, "coeff_diff_share": 0.0,
                "max_abs_diff": 0, "min_psnr_db": math.inf, "planes": []}
    reader = V3CReader()
    gofs_a, gofs_b = reader.read(a), reader.read(b)
    if len(gofs_a) != len(gofs_b):
        raise AssertionError(f"GOF count {len(gofs_a)} != {len(gofs_b)}")
    n_coeff = n_diff = 0
    max_abs = 0
    planes = []
    for gi, (ga, gb) in enumerate(zip(gofs_a, gofs_b)):
        ca, cb = reader.decode(ga), reader.decode(gb)
        for at_a, at_b in zip(ca.atlases, cb.atlases):
            vids_a = dict(at_a.video_bitstreams)
            vids_b = dict(at_b.video_bitstreams)
            if vids_a.keys() != vids_b.keys():
                raise AssertionError("video sub-streams differ in kind")
            for vt, vb_a in vids_a.items():
                pa, pb = vb_a.data, vids_b[vt].data
                info = rbv.probe(pa)
                if info != rbv.probe(pb):
                    raise AssertionError(f"{vt.name}: RBV headers differ")
                if pa == pb:
                    continue
                if not info["lossless"]:
                    for (qa, sa), (qb, sb) in zip(_rbv_coefficients(pa),
                                                  _rbv_coefficients(pb)):
                        for xa, xb in zip(sa, sb):
                            if not np.array_equal(xa, xb):
                                raise AssertionError(
                                    f"{vt.name}: motion/intra side info "
                                    "differs")
                        n_coeff += qa.size
                        n_diff += int(np.count_nonzero(qa != qb))
                va, vb = rbv.decode(pa), rbv.decode(pb)
                for pi, (xa, xb) in enumerate(zip(va.planes, vb.planes)):
                    d = int(np.abs(xa.astype(np.int32)
                                   - xb.astype(np.int32)).max(initial=0))
                    max_abs = max(max_abs, d)
                    planes.append({
                        "gof": gi, "video": vt.name, "plane": pi,
                        "max_abs_diff": d,
                        "psnr_db": _plane_psnr(xa, xb, info["bitdepth"]),
                    })
    return {
        "identical": False,
        "coeff_diff_share": n_diff / max(1, n_coeff),
        "max_abs_diff": max_abs,
        "min_psnr_db": min((p["psnr_db"] for p in planes),
                           default=math.inf),
        "planes": planes,
    }


def check_comparison(report: dict) -> None:
    """Fail unless a `compare_streams` report is inside the bounds."""
    if report["identical"]:
        return
    if report["coeff_diff_share"] > MAX_COEFF_DIFF_SHARE:
        raise AssertionError(
            f"{report['coeff_diff_share']:.3e} of coefficients differ "
            f"(bound {MAX_COEFF_DIFF_SHARE:.0e})")
    if report["min_psnr_db"] < MIN_PLANE_PSNR_DB:
        raise AssertionError(
            f"plane PSNR {report['min_psnr_db']:.2f} dB < "
            f"{MIN_PLANE_PSNR_DB} dB")


def _fmt(report: dict) -> str:
    if report["identical"]:
        return "bytes identical"
    return (f"bytes differ: coeff_diff_share={report['coeff_diff_share']:.3e}"
            f" max_abs_diff={report['max_abs_diff']}"
            f" min_plane_psnr={report['min_psnr_db']:.2f} dB")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase1_stream(cpu, tag: str, frames: int = 32, width: int = 1024,
                  warm_gofs: int = 3) -> None:
    """rabbit-stream on the bench stream: one GOF cold, `warm_gofs` warm,
    and the one-GOF transcode again on the CPU device."""
    from rabbit_transcoding_tpu.apps import stream
    from rabbit_transcoding_tpu.bitstream import V3CReader
    from rabbit_transcoding_tpu.bitstream.v3c import (
        sample_stream_header,
        write_sample_stream_units,
    )
    from rabbit_transcoding_tpu.testdata import make_bench_stream

    t0 = time.perf_counter()
    units = V3CReader().read(make_bench_stream(frames, width, width))[0]
    gof = write_sample_stream_units(units, 4)
    log(f"[{tag}] phase 1: input {frames} frames {width}x{width}, "
        f"{len(gof)} bytes/GOF, made in {time.perf_counter() - t0:.2f}s")

    with tempfile.TemporaryDirectory() as work:
        def run(n_gofs: int, name: str) -> tuple[bytes, float]:
            src = os.path.join(work, f"{name}_in.bin")
            dst = os.path.join(work, f"{name}_out.bin")
            with open(src, "wb") as fh:
                fh.write(sample_stream_header(4) + gof * n_gofs)
            t = time.perf_counter()
            rc = stream.main([
                f"--compressedStreamPath={src}", f"--outStreamPath={dst}",
                f"--geometryQP={GEOMETRY_QP}",
                f"--attributeQP={ATTRIBUTE_QP}",
            ])
            wall = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"rabbit-stream {name} exited {rc}")
            with open(dst, "rb") as fh:
                return fh.read(), wall

        gpu1, cold = run(1, "gpu_cold")
        gpun, warm = run(warm_gofs, "gpu_warm")
        with on_device(cpu):
            cpu1, cpu_wall = run(1, "cpu")
    log(f"[{tag}] phase 1: GPU first GOF (cold) {cold:.3f}s; "
        f"{warm_gofs} warm GOFs {warm:.3f}s "
        f"({warm_gofs * frames / warm:.2f} frames/s); "
        f"CPU one GOF {cpu_wall:.3f}s")

    # every warm GOF must be the cold GOF's bytes: same input, same program
    reader = V3CReader()
    first = reader.read(gpu1)
    warm_gofs_out = reader.read(gpun)
    if len(warm_gofs_out) != warm_gofs or any(
        g != first[0] for g in warm_gofs_out
    ):
        raise AssertionError("warm GOFs differ from the cold GOF's output")
    report = compare_streams(gpu1, cpu1)
    log(f"[{tag}] phase 1: GPU vs CPU output ({len(gpu1)} vs {len(cpu1)} "
        f"bytes): {_fmt(report)}; bounds: coeff share <= "
        f"{MAX_COEFF_DIFF_SHARE:.0e}, plane PSNR >= {MIN_PLANE_PSNR_DB} dB")
    for p in report["planes"]:
        log(f"[{tag}]   {p['video']} plane {p['plane']}: max |diff| "
            f"{p['max_abs_diff']}, PSNR {p['psnr_db']:.2f} dB")
    check_comparison(report)


def _phase2_loop(frames: int, points: int, width: int):
    """Encoder -> closed-loop check -> Transcoder(auto) -> Decoder ->
    metrics on the dense scene, on the current default device."""
    from rabbit_transcoding_tpu.bitstream import V3CReader, V3CWriter
    from rabbit_transcoding_tpu.core.gof import GroupOfFrames
    from rabbit_transcoding_tpu.decoder.decoder import Decoder
    from rabbit_transcoding_tpu.encoder.encoder import Encoder
    from rabbit_transcoding_tpu.encoder.params import EncoderParameters
    from rabbit_transcoding_tpu.metrics.metrics import (
        MetricsParams,
        compute_sequence_metrics,
    )
    from rabbit_transcoding_tpu.testdata import make_dense_frame
    from rabbit_transcoding_tpu.transcoder.params import TranscoderParameters
    from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder
    from rabbit_transcoding_tpu.utils.enums import VideoType
    from rabbit_transcoding_tpu.video import rbv

    sources = GroupOfFrames(
        [make_dense_frame(i, n=points) for i in range(frames)])
    t = time.perf_counter()
    context, recon = Encoder(EncoderParameters(
        minimumImageWidth=width, frameCount=frames,
        groupOfFramesSize=frames,
    )).encode(sources)
    t_enc = time.perf_counter() - t
    writer, reader = V3CWriter(), V3CReader()
    encoded = writer.write(writer.encode(context))
    geo = rbv.probe(context.atlas(0).get_video_bitstream(
        VideoType.GEOMETRY).data)
    if not (geo["motion"] and geo["intra"]):
        raise AssertionError(f"geometry is not MC + intra: {geo}")

    t = time.perf_counter()
    decoded = Decoder().decode(reader.decode(reader.read(encoded)[0]))
    t_dec = time.perf_counter() - t
    if [c.compute_checksum() for c in decoded] != [
        c.compute_checksum() for c in recon
    ]:
        raise AssertionError("closed loop broken: encoder reconstruction "
                             "!= decoder output")

    t = time.perf_counter()
    ctx = reader.decode(reader.read(encoded)[0])
    Transcoder(TranscoderParameters(
        mode="auto", geometryQP=GEOMETRY_QP, attributeQP=ATTRIBUTE_QP,
    )).transcode(ctx)
    out = writer.write(writer.encode(ctx))
    t_tc = time.perf_counter() - t
    clouds = Decoder().decode(reader.decode(reader.read(out)[0]))
    _, m = compute_sequence_metrics(list(sources), clouds,
                                    MetricsParams(resolution=1023))
    return {
        "points": [s.point_count for s in sources],
        "encode_s": t_enc, "decode_s": t_dec, "transcode_s": t_tc,
        "in_bytes": len(encoded), "out_bytes": len(out),
        "d1": m.d1_psnr, "d2": m.d2_psnr, "y": m.color_psnr[0],
    }


def phase2_shipping_shape(cpu, tag: str, frames: int = 2,
                          points: int = 500000, width: int = 1024) -> None:
    g = _phase2_loop(frames, points, width)
    with on_device(cpu):
        c = _phase2_loop(frames, points, width)
    for name, r in (("GPU", g), ("CPU", c)):
        log(f"[{tag}] phase 2 {name}: {frames} frames "
            f"{r['points']} points; encode {r['encode_s']:.3f}s, decode "
            f"{r['decode_s']:.3f}s, transcode(auto) {r['transcode_s']:.3f}s;"
            f" {r['in_bytes']} -> {r['out_bytes']} bytes; D1 "
            f"{r['d1']:.4f} dB, D2 {r['d2']:.4f} dB, Y {r['y']:.4f} dB")
    delta = g["d1"] - c["d1"]
    log(f"[{tag}] phase 2: closed-loop checksum equal on both; D1 GPU-CPU "
        f"{delta:+.4f} dB (bound |delta| <= {MAX_D1_DELTA_DB})")
    if not all(math.isfinite(g[k]) for k in ("d1", "d2", "y")):
        raise AssertionError(f"non-finite GPU metrics: {g}")
    if abs(delta) > MAX_D1_DELTA_DB:
        raise AssertionError(f"D1 GPU-CPU {delta:+.4f} dB")


def phase3_cross_decode(cpu, tag: str, frames: int = 8,
                        width: int = 1024) -> None:
    """RBV payloads encoded on the CPU, decoded on the GPU and the CPU."""
    import numpy as np

    from rabbit_transcoding_tpu.core.image import Video
    from rabbit_transcoding_tpu.utils.enums import ColorFormat
    from rabbit_transcoding_tpu.video import rbv

    yy, xx = np.mgrid[0:width, 0:width]
    geo = np.stack([
        (300 + 120 * np.sin((xx + 7 * f) / 37.0)
         * np.cos((yy - 3 * f) / 29.0)).astype(np.uint16)
        for f in range(frames)
    ])
    video = Video(width, width, 10, ColorFormat.YUV400, [geo])
    for name, params in (
        ("P chain", rbv.RbvParams(qp=28, gop_size=2)),
        ("MC + intra", rbv.RbvParams(qp=28, gop_size=2, motion=True,
                                     intra=True)),
    ):
        with on_device(cpu):
            payload, _ = rbv.encode(video, params)
            ref = rbv.decode(payload).planes[0]
        t = time.perf_counter()
        got = rbv.decode(payload).planes[0]
        wall = time.perf_counter() - t
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        share = float(np.count_nonzero(diff)) / diff.size
        log(f"[{tag}] phase 3 {name}: GPU decode {wall:.3f}s; vs CPU decode"
            f" max |diff| {int(diff.max())}, differing pixels {share:.3e} "
            f"(bound {MAX_XDECODE_PIXEL_SHARE:.0e})")
        if share > MAX_XDECODE_PIXEL_SHARE:
            raise AssertionError(f"{name}: {share:.3e} of pixels differ")


def four_gpu_sharded(devices, tag: str, frames: int = 32,
                     width: int = 1024) -> None:
    """5 streams of the phase-1 shape, sharded over a 2x2 mesh, against
    the sequential single-card Transcoder; sharded decode and D1."""
    from __graft_entry__ import check_multichip
    from rabbit_transcoding_tpu.testdata import make_bench_stream

    def compare(sharded: list[bytes], sequential: list[bytes]) -> None:
        for i, (a, b) in enumerate(zip(sharded, sequential)):
            report = compare_streams(a, b)
            log(f"[{tag}] sharded vs sequential stream {i}: {_fmt(report)}")
            check_comparison(report)

    streams = [make_bench_stream(frames, width, width, seed=i)
               for i in range(5)]
    t = time.perf_counter()
    summary = check_multichip(devices, streams, compare=compare)
    log(f"[{tag}] four GPUs: {summary} ({time.perf_counter() - t:.3f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded multi-stream path on 4 cards")
    args = ap.parse_args(argv)

    # the CPU device is the reference every phase compares with
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from rabbit_transcoding_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache = enable_compile_cache()  # before JAX starts its backends
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU ({devices[0].platform} devices only)",
              file=sys.stderr)
        return 2
    n_want = 4 if args.four_gpus else 1
    if len(devices) < n_want:
        print(f"chip_smoke: {len(devices)} GPU(s), need {n_want}",
              file=sys.stderr)
        return 2
    devices = devices[:n_want]

    from rabbit_transcoding_tpu import native

    cards = card_lines()
    for line in cards:
        log(f"card: {line}")
    tag = cards[0]
    log(f"jax {jax.__version__}; compile cache {cache}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}")
    log(f"[{tag}] phase 0: {len(devices)} x {devices[0].device_kind}")
    if not native.available():
        raise AssertionError("native rANS library unavailable")
    cpu = jax.devices("cpu")[0]

    phases = (
        [("four GPUs", lambda: four_gpu_sharded(devices, tag))]
        if args.four_gpus else [
            ("phase 1", lambda: phase1_stream(cpu, tag)),
            ("phase 2", lambda: phase2_shipping_shape(cpu, tag)),
            ("phase 3", lambda: phase3_cross_decode(cpu, tag)),
        ]
    )
    for name, run in phases:
        t = time.perf_counter()
        run()
        log(f"[{tag}] {name} passed in {time.perf_counter() - t:.3f}s")

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
