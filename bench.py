#!/usr/bin/env python
"""Headline benchmark: live V-PCC transcode throughput per device.

Transcodes a 1024x1024-atlas V-PCC stream (geometry 10-bit + attribute
YUV420 + occupancy, 32-frame GOF, testdata.make_bench_stream) to a lower
rate point end to end — V3C demux, video decode, re-encode at new QPs,
remux — including all host entropy work.  Prints ONE JSON line on stdout
(diagnostics go to stderr):
  {"metric": ..., "value": fps, "unit": "frames/sec/chip", "vs_baseline": x}
The headline is the median of BENCH_WINDOWS windows of BENCH_GOFS GOFs
each, every window counted.  vs_baseline is against the 30 fps
live-transcode target (BASELINE.md).  Any failed phase fails the run.

Env knobs: BENCH_MODE=reencode|requant, BENCH_FRAMES, BENCH_GOFS,
BENCH_WINDOWS, BENCH_STREAMS, BENCH_PIPELINE (GOFs in flight, default 3),
BENCH_MULTI=0 (skip the 4-stream aggregate).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prewarm(mode: str, frames: int) -> None:
    """Compile the bench shapes' device programs (run concurrently with
    stream synthesis, so a cold start overlaps compile with host work)."""
    import jax.numpy as jnp

    from rabbit_transcoding_tpu.video.rbv import (
        _freq_nnz,
        _from_freq_slab,
        _requant_compensated_device,
        _requant_device,
        _to_freq_major,
        _transcode_device,
        qstep_of,
    )

    qs_in = jnp.float32(qstep_of(16))
    qs_out = jnp.float32(qstep_of(32))
    for nby, nbx, maxv in (
        (64, 64, 1023.0),   # geo/attr luma 1024x1024
        (32, 32, 255.0),    # attr chroma 512x512
    ):
        coeffs = jnp.zeros((frames, nby, nbx, 16, 16), jnp.int16)
        if mode == "requant":
            _requant_device(coeffs, qs_in, qs_out)
            _requant_compensated_device(coeffs, qs_in, qs_out, 2)
        else:
            _transcode_device(coeffs, qs_in, qs_out, jnp.float32(maxv), 16,
                              2, 2)
        # the entropy-side helpers every payload crosses: freq-major
        # reorder + per-frequency census (shape-keyed) and the slab
        # densifier for the kmax buckets bench content lands in
        _freq_nnz(_to_freq_major(coeffs))
        for kmax in (16, 32, 64, 128):
            _from_freq_slab(
                jnp.zeros((frames, kmax, nby, nbx), jnp.int16), 16, kmax
            )


def quality_probe(geometry_qp: int, attribute_qp: int) -> dict:
    """D1/Y of the live transcode against the full decode->re-encode
    baseline, from the CPU reference in a child process (this process
    holds the accelerator)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "rabbit_transcoding_tpu.metrics.quality_probe",
         str(geometry_qp), str(attribute_qp)],
        capture_output=True, text=True, timeout=1800, env=env, check=True,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    t_setup = time.perf_counter()
    from rabbit_transcoding_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import jax

    from rabbit_transcoding_tpu.bitstream import V3CReader, V3CWriter
    from rabbit_transcoding_tpu.testdata import make_bench_stream
    from rabbit_transcoding_tpu.transcoder.multistream import (
        MultiStreamTranscoder,
    )
    from rabbit_transcoding_tpu.transcoder.params import TranscoderParameters
    from rabbit_transcoding_tpu.transcoder.transcoder import Transcoder

    mode = os.environ.get("BENCH_MODE", "reencode")
    frames = int(os.environ.get("BENCH_FRAMES", "32"))
    n_gofs = int(os.environ.get("BENCH_GOFS", "3"))
    n_windows = int(os.environ.get("BENCH_WINDOWS", "7"))
    n_streams = int(os.environ.get("BENCH_STREAMS", "1"))
    depth = int(os.environ.get("BENCH_PIPELINE", "3"))
    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}  mode={mode} frames/gof={frames} "
        f"streams={n_streams}")

    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        warm = ex.submit(prewarm, mode, frames)
        data = make_bench_stream(frames)
        warm.result()  # a failed prewarm fails the run
    log(f"input stream: {len(data)} bytes "
        f"({len(data) * 8 / frames / 30:.0f} kbit/s @30fps); "
        f"setup {time.perf_counter() - t_setup:.1f}s")

    params = TranscoderParameters(
        geometryQP=32, attributeQP=42, mode=mode, computeHashSei=False
    )
    reader = V3CReader()
    units = reader.read(data)[0]

    # ONE Transcoder per stream, exactly like rabbit-stream: per-stream
    # state (the ABR QP cache) must persist across that stream's GOFs
    transcoders = [Transcoder(params) for _ in range(max(1, n_streams))]

    def one_gof(stream_idx: int = 0) -> int:
        context = reader.decode(list(units))
        transcoders[stream_idx].transcode(context)
        w = V3CWriter()
        return len(w.write(w.encode(context)))

    # first GOF: compilation not covered by prewarm lands here
    t0 = time.perf_counter()
    out_size = one_gof()
    warmup_s = time.perf_counter() - t0
    log(f"warmup gof: {warmup_s:.2f}s; out {out_size} bytes")

    walls = []
    if n_streams <= 1:
        # GOF pipelining like rabbit-stream (pipelineDepth, ordered
        # output): host entropy of one GOF overlaps device work of the next
        for _ in range(n_windows):
            t0 = time.perf_counter()
            if depth <= 1:
                for _ in range(n_gofs):
                    one_gof()
            else:
                with cf.ThreadPoolExecutor(max_workers=depth) as ex:
                    for fu in [ex.submit(one_gof) for _ in range(n_gofs)]:
                        fu.result()
            walls.append(time.perf_counter() - t0)
            log(f"window: {walls[-1]:.4f}s")
        total_frames = frames * n_gofs
    else:
        # BASELINE config #5: concurrent streams, per-stream threads
        # overlapping host entropy with device compute
        for _ in range(n_windows):
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=n_streams) as ex:
                list(ex.map(
                    lambda si: [one_gof(si) for _ in range(n_gofs)],
                    range(n_streams),
                ))
            walls.append(time.perf_counter() - t0)
            log(f"window: {walls[-1]:.4f}s")
        total_frames = frames * n_gofs * n_streams
    wall = statistics.median(walls)
    fps = total_frames / wall
    fps_best = total_frames / min(walls)
    log(f"{total_frames} frames/window, median window {wall:.4f}s -> "
        f"{fps:.2f} fps (best window {fps_best:.2f})")

    ms_fps = None
    if n_streams <= 1 and os.environ.get("BENCH_MULTI", "1") != "0":
        # the 4-stream aggregate (BASELINE config #5) through the product
        # multi-stream path: all 4 streams' video planes run as ONE batched
        # device program per plane (transcoder/multistream.py); host
        # entropy (decode/remux) stays 4-way threaded
        mst = MultiStreamTranscoder(params)

        def ms_window() -> float:
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                contexts = list(ex.map(
                    lambda _i: reader.decode(list(units)), range(4)
                ))
            mst.transcode_many(contexts)

            def wr(c) -> int:
                w = V3CWriter()
                return len(w.write(w.encode(c)))

            with cf.ThreadPoolExecutor(max_workers=4) as ex:
                list(ex.map(wr, contexts))
            return time.perf_counter() - t0

        ms_window()  # the batched shapes compile here
        ms_wall = statistics.median(ms_window() for _ in range(n_windows))
        ms_fps = frames * 4 / ms_wall
        log(f"4-stream aggregate (batched device path): {ms_fps:.2f} fps")

    # quality half of the north star: D1/Y delta of the live transcode vs
    # the full decode->re-encode baseline at the same QPs
    q = quality_probe(params.geometryQP, params.attributeQP)
    # the SHIPPING live mode is `auto` — its D1 and Y deltas are the gated
    # numbers (D1 <= 0.05 dB, Y <= 0.1 dB vs the full-re-encode baseline);
    # the raw requant-path deltas ride along for the DCT-domain fast path
    d1_delta = q["d1_delta_auto"]
    y_delta = q["y_delta_auto"]
    log(
        f"quality: auto D1 delta={d1_delta:+.4f} dB (bar <=0.05), "
        f"auto Y delta={y_delta:+.4f} dB (bar <=0.1); requant-path "
        f"D1 delta={q['d1_delta']:+.4f}, Y delta={q['y_delta']:+.4f} "
        f"(live={q['d1_live']:.2f} vs baseline={q['d1_baseline']:.2f})"
    )

    suffix = f"_{n_streams}streams" if n_streams > 1 else ""
    record = {
        "metric": f"vpcc_transcode_fps_1024_{mode}{suffix}",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / 30.0, 3),
        "fps_best_window": round(fps_best, 2),
        "windows_s": [round(w, 4) for w in walls],
        "n_windows": len(walls),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "d1_delta_db": d1_delta,
        "d1_bar_db": 0.05,
        "d1_delta_requant_db": q["d1_delta"],
        "y_delta_db": y_delta,
        "y_bar_db": 0.1,
        "y_delta_requant_db": q["y_delta"],
        "quality_bars_met": bool(d1_delta <= 0.05 and y_delta <= 0.1),
        "warmup_s": round(warmup_s, 3),
    }
    if ms_fps is not None:
        record["aggregate_fps_4stream"] = round(ms_fps, 2)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
