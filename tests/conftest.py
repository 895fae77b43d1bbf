"""Test configuration: force a virtual 8-device CPU mesh.

Tests run on CPU so they are fast and deterministic; multi-chip sharding
logic is exercised on 8 virtual devices (the driver separately dry-runs the
multi-chip path).  Must run before jax initializes its backends.
"""

import os

# Tests always run on CPU, so override rather than setdefault.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# never spawn the WPCR prewarm thread under tests: background compiles
# skew other measurements and outlive the test that started them
os.environ.setdefault("RR_NO_PREWARM", "1")

# ---------------------------------------------------------------------------
# Quick tier: `pytest -m "not slow"` finishes in a few minutes for
# iteration; CI runs the full suite.  Tests are marked slow by name from
# the measured r5 duration table (everything >= ~4 s single-threaded).
import pytest  # noqa: E402

_SLOW_TESTS = {
    "test_symbol_sync_events_fuzz_params",
    "test_symbol_sync_events_block_stream_equals_offline",
    "test_ax25_graph_events_sync_decodes",
    "test_wpcr_batch_equals_eager",
    "test_sharded_symbol_sync_bank",
    "test_iq_balance_removes_dc",
    "test_symbol_sync_unroll_bit_exact",
    "test_decode_rate_events_sync",
    "test_symbol_sync_events_decode_equivalent",
    "test_recover_symbols_batch_events_method",
    "test_hard_corpus_events_sync_matches",
    "test_hundred_frame_stress",
    "test_recover_symbols_batch_valid_and_method_validation",
    "test_wpcr_batch_decodes_real_packets",
    "test_symbol_sync_events_unroll_invariant",
    "test_decode_band_three_stations",
    "test_symbol_sync_events_long_runs",
    "test_decode_band_events_method",
    "test_scanner_decode_flag",
    "test_symbol_sync_events_valid_flag",
    "test_g3ruh_tx_feeds_9600_wpcr",
    "test_g3ruh_loopback",
    "test_mesh_checkpoint_resume",
    "test_recover_symbols_batch_matches_single",
    "test_wpcr_batch_long_burst_fallback",
    "test_sharded_bell202_decodes_packets",
    "test_random_chain_stream_equals_offline",
    "test_mesh_with_scan_chunks",
    "test_scramble_blocked_matches_scan",
    "test_ax25_receiver_from_blocks_on_mesh",
    "test_streaming_equals_offline_dense_chain",
    "test_ax25_1200_wpcr_synthetic",
    "test_decode_rate_discriminator",
    "test_decode_rate_tones",
    "test_ax25_9600_wpcr_synthetic",
    "test_wpcr_decode_rate",
    "test_sharded_fir_matches_offline",
    "test_sharded_fft_filter_matches_offline",
    "test_wpcr_blocks_batched",
    "test_sharded_bell202_demod_matches_offline",
    "test_resampler_mesh_offline_one_segment",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
