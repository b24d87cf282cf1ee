"""Transcode quality probe: the D1-delta half of the north star.

BASELINE.md's target is two-sided: >=30 fps AND <=0.05 dB D1-PSNR delta
**vs the full decode->re-encode baseline** (the reference's
--transcodeBaseline, the HM loop of transcode_HM.sh).  The measurement
protocol is the reference smoke loop's (transcode.sh:32-37): decode each
output, compute D1 PSNR against the original source cloud.  Reported:

    d1_delta = D1(source, decode(baseline_transcode(hq)))
             - D1(source, decode(live_transcode(hq)))

where baseline = drift-free on-device decode->re-encode ('reencode') and
live = the DCT-domain fast path ('requant') at the SAME QPs.  The in->out
drop (d1_in - d1_out) is also reported for context, but it mixes the
*intended* rate reduction into the number, so it is not the target metric.

Runs on a synthetic vox10 sequence (testdata sphere), always on the CPU:
it is the host reference the device benchmark's quality is judged by, and
as a separate process it must not open the accelerator the benchmark
holds.

Run standalone:  python -m rabbit_transcoding_tpu.metrics.quality_probe
Prints one JSON line with d1_*/y_* PSNRs and deltas.
"""

from __future__ import annotations

import json
import os
import sys


def measure(
    geometry_qp: int = 32,
    attribute_qp: int = 42,
    frames: int = 2,
    hq_geometry_qp: int = 8,
    hq_attribute_qp: int = 12,
) -> dict:
    from ..bitstream import V3CReader, V3CWriter
    from ..core.gof import GroupOfFrames
    from ..decoder.decoder import Decoder
    from ..encoder.encoder import Encoder
    from ..encoder.params import EncoderParameters
    from ..metrics.metrics import MetricsParams, compute_sequence_metrics
    from ..testdata import make_frame
    from ..transcoder.params import TranscoderParameters
    from ..transcoder.transcoder import Transcoder

    sources = GroupOfFrames(
        [make_frame(i, n=30000) for i in range(frames)]
    )
    enc = Encoder(EncoderParameters(
        minimumImageWidth=512, minimumImageHeight=128,
        geometryQP=hq_geometry_qp, attributeQP=hq_attribute_qp,
        occupancyPrecision=2,
    ))
    context, _ = enc.encode(sources)
    writer = V3CWriter()
    hq = writer.write(writer.encode(context))

    reader = V3CReader()

    def decode_clouds(stream: bytes):
        return Decoder().decode(reader.decode(reader.read(stream)[0]))

    params = MetricsParams(resolution=1023)
    clouds_in = decode_clouds(hq)
    _, m_in = compute_sequence_metrics(list(sources), clouds_in, params)

    def transcoded_metrics(mode: str):
        tc = Transcoder(TranscoderParameters(
            geometryQP=geometry_qp, attributeQP=attribute_qp, mode=mode,
            computeHashSei=False,
        ))
        ctx = reader.decode(reader.read(hq)[0])
        tc.transcode(ctx)
        out = writer.write(writer.encode(ctx))
        _, m = compute_sequence_metrics(
            list(sources), decode_clouds(out), params
        )
        return m, len(out)

    m_base, base_bytes = transcoded_metrics("reencode")
    m_fast, fast_bytes = transcoded_metrics("requant")
    m_auto, _ = transcoded_metrics("auto")

    return {
        "d1_in": round(m_in.d1_psnr, 4),
        "d1_baseline": round(m_base.d1_psnr, 4),
        "d1_live": round(m_fast.d1_psnr, 4),
        # the north-star number: live fast path vs full-re-encode baseline
        "d1_delta": round(m_base.d1_psnr - m_fast.d1_psnr, 4),
        # the shipping live mode: requant at fine QPs, reencode at coarse
        # ones (mode='auto') — closes the r1 gap by construction
        "d1_auto": round(m_auto.d1_psnr, 4),
        "d1_delta_auto": round(m_base.d1_psnr - m_auto.d1_psnr, 4),
        # context: quality drop due to the intended rate reduction itself
        "d1_drop_in_to_out": round(m_in.d1_psnr - m_base.d1_psnr, 4),
        "y_baseline": round(m_base.color_psnr[0], 4),
        "y_live": round(m_fast.color_psnr[0], 4),
        "y_delta": round(m_base.color_psnr[0] - m_fast.color_psnr[0], 4),
        # color bar for the SHIPPING mode (round-4 verdict: the D1-only
        # bar let requant trade Y for bytes unbounded; auto must also hold
        # Y within 0.1 dB of the full-re-encode baseline)
        "y_auto": round(m_auto.color_psnr[0], 4),
        "y_delta_auto": round(
            m_base.color_psnr[0] - m_auto.color_psnr[0], 4
        ),
        "in_bytes": len(hq),
        "baseline_bytes": base_bytes,
        "live_bytes": fast_bytes,
        "geometry_qp": geometry_qp,
        "attribute_qp": attribute_qp,
    }


def main(argv=None) -> int:
    # the CPU reference (module docstring); set before JAX starts
    os.environ["JAX_PLATFORMS"] = "cpu"
    argv = sys.argv[1:] if argv is None else argv
    gqp = int(argv[0]) if len(argv) > 0 else 32
    aqp = int(argv[1]) if len(argv) > 1 else 42
    print(json.dumps(measure(gqp, aqp)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
