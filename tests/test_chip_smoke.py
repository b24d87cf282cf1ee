"""chip_smoke.py off the card: its stream comparison, and its refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rabbit_transcoding_tpu.bitstream import (  # noqa: E402
    V3CReader,
    V3CWriter,
    VideoBitstream,
)
from rabbit_transcoding_tpu.core.image import Video  # noqa: E402
from rabbit_transcoding_tpu.testdata import make_bench_stream  # noqa: E402
from rabbit_transcoding_tpu.utils.enums import ColorFormat, VideoType  # noqa: E402
from rabbit_transcoding_tpu.video import rbv  # noqa: E402


@pytest.fixture(scope="module")
def stream():
    return make_bench_stream(4, 128, 128)


def _with_perturbed_geometry(data: bytes) -> bytes:
    """The same stream with its geometry re-encoded from noisy planes
    (same RBV header, different coefficients)."""
    reader = V3CReader()
    ctx = reader.decode(reader.read(data)[0])
    atlas = ctx.atlas(0)
    pay = atlas.get_video_bitstream(VideoType.GEOMETRY).data
    info = rbv.probe(pay)
    geo = rbv.decode(pay).planes[0].astype(np.int32)
    noise = np.random.default_rng(0).integers(-40, 40, geo.shape)
    noisy = np.clip(geo + noise, 0, 1023).astype(np.uint16)
    new, _ = rbv.encode(
        Video(info["width"], info["height"], 10, ColorFormat.YUV400, [noisy]),
        rbv.RbvParams(qp=info["qp"], gop_size=info["gop_size"]),
    )
    atlas.set_video_bitstream(VideoBitstream(VideoType.GEOMETRY, new))
    w = V3CWriter()
    return w.write(w.encode(ctx))


def test_comparison_accepts_identical(stream):
    report = chip_smoke.compare_streams(stream, bytes(stream))
    assert report["identical"] and report["coeff_diff_share"] == 0.0
    chip_smoke.check_comparison(report)


def test_comparison_rejects_perturbed(stream):
    report = chip_smoke.compare_streams(_with_perturbed_geometry(stream),
                                        stream)
    assert not report["identical"]
    assert report["coeff_diff_share"] > chip_smoke.MAX_COEFF_DIFF_SHARE
    assert {p["video"] for p in report["planes"]} == {"GEOMETRY"}
    with pytest.raises(AssertionError, match="coefficients differ"):
        chip_smoke.check_comparison(report)


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    got = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert got.returncode != 0
    assert '"ok"' not in got.stdout
    assert "no GPU" in got.stderr
