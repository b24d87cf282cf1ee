"""Test environment: JAX on 8 virtual CPU devices, so the multi-device
sharding paths compile and run without accelerator hardware.

Must run before any jax import.  The compilation cache stays off in tests:
the CPU compiles in milliseconds and six workers would share one cache.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)


# ---------------------------------------------------------------------------
# Fast gate: `pytest -m "not slow"` (<2 min) for inner-loop development; the
# full suite stays the commit gate.  Long-running e2e tests are marked from
# this central list (measured with --durations) instead of
# per-file decorators so the cut line is auditable in one place.
# Entries are nodeid prefixes relative to tests/.
_SLOW_PREFIXES = (
    "test_attribute_partitions.py::TestPartitionedE2E",
    "test_attribute_partitions.py::TestReflectanceTranscode",
    "test_dualmap.py::TestDualMap",
    "test_dualmap.py::TestPixelInterleaving",
    "test_e2e_codec.py::TestLevelOfDetail",
    "test_e2e_codec.py::TestGridBasedSegmentation",
    "test_eom.py::TestEom::test_interior_layers_recovered",
    "test_eom.py::TestEom::test_eom_closed_loop",
    "test_cfg_corpus.py::TestCascadeDrivesExternalCodec",
    "test_external_pipeline.py::TestExternalEncodePipeline",
    "test_external_pipeline.py::TestMixedCodecs",
    "test_foreign_transcode.py::TestForeignReencode",
    "test_inter_coding.py::TestInterCoding",
    "test_inter_coding.py::TestGlobalPacking",
    "test_lossless.py::TestLowDelayCondition",
    "test_lossless_mapstream.py::TestLosslessPredictedMapE2E",
    "test_mapstreams.py::TestMapStreams",
    "test_mapstreams.py::TestDeltaQPAndPTL",
    "test_motion.py::TestMotionCompensation::test_mc_closed_loop",
    "test_native.py::TestSanitizedBuild",
    "test_parallel.py::TestMultiStreamPayloads",
    "test_rbv_codec.py::TestIntraPrediction::test_wins_on_atlas_geometry",
    "test_parallel.py::TestMultiStreamEdgeCases",
    "test_plr.py::TestPlr::test_plr_mode_survives_syntax",
    "test_plr.py::TestPlr::test_plr_ignored_with_dual_maps",
    "test_projection45.py::TestProjection45",
    "test_raw_points.py::TestMortonSort",
    "test_raw_points.py::TestLossyRawPoints",
    "test_reconstruct.py::TestPbfRefine::test_e2e_pbf_sei_closed_loop",
    "test_stream_app.py::TestShardedStreams",
    "test_stream_app.py::TestShardedMixedInputs",
    "test_stream_app.py::TestStreamDriver",
    "test_tiles.py::TestTiles::test_tiled_closed_loop",
    "test_tiles.py::TestTiles::test_tile_structure",
    "test_padding_knobs.py::TestPaddingE2E::"
    "test_harmonic_fill_and_rim_padding_closed_loop",
    "test_quantizer_knobs.py::TestPatchSizeQuantizer",
    "test_quantizer_knobs.py::TestTranscodeNewSyntax",
    "test_vox11.py",
    "test_encoder_units.py::TestMaxPatchSize",
    "test_encoder_units.py::TestColorPreSmoothing",
    "test_encoder_units.py::TestOccupancyMapRefinement",
    "test_knn.py::TestDeviceRecolor",
    "test_knn.py::TestGridKnn",
    "test_color_filters.py::TestPatchAwareSubsampling",
    "test_color_filters.py::TestFilterBanks",
    "test_conformance.py::TestConformance::test_matching_run_passes",
    "test_eom.py::TestEom::test_eom_colors_lossless_aux",
    "test_plr.py::TestPlr::test_plr_improves_single_map_quality",
    "test_mapstreams.py::TestAbrOnMapStreams",
    "test_motion.py::TestMotionCompensation::test_mc_beats_zero_mv",
    "test_tiles.py::TestTiles::test_tiled_quality_matches_untiled",
    "test_robustness.py::TestConcurrencyDeterminism",
    "test_reconstruct.py::TestPbfRefine",
    "test_e2e_codec.py::TestReflectance",
    "test_e2e_codec.py::TestOccupancyCoding::test_lossy_occupancy_roundtrip",
    "test_parallel.py::TestMesh",
    "test_transcoder.py::TestMultiAtlas",
    "test_transcoder.py::TestTranscoder::test_geometry_only_all_intra",
    "test_attribute_partitions.py::TestAbrOnPartitions",
    "test_projection45.py",
)


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        nodeid = item.nodeid.split("tests/")[-1]
        if nodeid.startswith(_SLOW_PREFIXES):
            item.add_marker(pytest.mark.slow)
