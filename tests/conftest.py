"""Test configuration: the CPU with a virtual 8-device mesh by default.

The standard JAX trick for testing multi-device sharding without hardware
(SURVEY.md §4): ``xla_force_host_platform_device_count=8``. The CPU is
chosen only when ``JAX_PLATFORMS`` is unset; an explicit setting is left
alone, so ``chip_smoke.py`` can run the ``gpu``-marked tests in its own
process on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Test tiering (VERDICT r3 #7). The default tier must stay < 5 min serial on
# the 4-core host; everything below is measured >= ~10 s there (durations
# from the round-4 full run). Centralized here instead of scattered
# decorators so re-tiering after a timing change is one edit. Run the full
# suite with plain `pytest tests/` exactly as before — the marker only
# matters with `-m "not slow"` (and `-n 4` roughly halves either tier).
# ---------------------------------------------------------------------------

# whole modules that are slow by nature (statistical calibration sweeps,
# virtual-mesh distributed resampling, long-scan documentation examples)
SLOW_MODULES = {
    "test_calibration.py",
    "test_distributed_resample.py",
    "test_examples.py",
}

# individual heavy tests in otherwise-fast modules
SLOW_TESTS = {
    "test_canonicalize_projection_is_per_particle_masked",
    "test_batch_update_rejuvenation_does_not_retrace_per_record_length",
    "test_candidate_chunking_matches_unchunked",
    "test_liu_west_fill_strategy_override",
    "test_gather_free_no_zero_injection_at_scale",
    "test_gather_free_resample_locations_matches_ancestors",
    "test_gather_free_one_hot_weights",
    "test_counting_fill_strategies_agree",
    "test_liu_west_high_dim_uses_gather_path",
    "test_liu_west_preserves_moments",
    "test_process_tomography_two_qubit_channel",
    "test_process_tomography_infers_depolarizing",
    "test_500k_config_smoke",
    "test_general_dim_canonicalize_projects_tol_valid_states",
    "test_product_heuristic_two_qubits",
    "test_best_of_k_beats_or_matches_random",
    "test_bcrb_adaptive_vs_prior_ensembles",
    "test_orbax_roundtrip",
    "test_sharded_rejuvenation_runs_and_preserves_sharding",
    "test_directview_smc_end_to_end",
    "test_sharded_experiment_design_scores",
    "test_shard_existing_updater",
    "test_designer_bounds_and_string_algo",
    "test_perf_test_scan_batch_vmap_and_shard",
    "test_systematic_variance_below_multinomial",
    "test_accelerated_model_in_smc_loop",
    "test_rejuvenated_updater_matches_conjugate_posterior",
    "test_log_pdfs_match_scipy",
    "test_multinomial_smc_update_vector_outcomes",
    "test_bcrb_tracking",
    "test_plot_rebit_posterior",
    "test_plot_decaying_exponentials",
    "test_tomography_smc_recovers_state",
    "test_product_heuristic_rejects_dimension_mismatch",
    "test_bcsz_choi_states_are_physical",
    "test_general_dim_validity_cholesky_matches_spectrum",
    "test_stabilizer_heuristic",
    "test_bcrb_consumes_only_first_experiment_of_batch",
    "test_explicit_resample_resets_weights",
    "test_exp_sparse_heuristic",
    "test_pgh_time_scales_with_uncertainty",
    "test_simple_est_rb",
    "test_simple_est_prec_ndarray",
    "test_resampler_enforces_strict_canonicalize",
    "test_liu_west_bootstrap_degenerate",
    "test_gated_resample_traced_predicate_in_scan",
    "test_scan_batch_resample_interval",
    "test_mh_chain_equivalence",
    "test_updater_compressed_record_matches_full",
    "test_design_from_candidates_binomial_process",
    "test_roundtrip_preserves_rejuvenation_record",
    "test_updater_waste_free_engine_paths",
    "test_waste_free_recovers_conjugate_posterior",
    "test_sharded_waste_free_engine",
    "test_sharded_compressed_rejuvenation",
    "test_updater_mcmc_canonicalize_flag",
    "test_error_replay_rolls_back_phantom_pool_rows",
    "test_compressed_ll_differs_by_constant",
    "test_rejuvenate_no_canonicalize_stays_valid",
    "test_liu_west_canonicalizes",
    "test_resampler_no_warning_when_valid",
    "test_smc_inference_with_calibration",
    "test_score_mixin_matches_autodiff",
    "test_ale_smc_inference",
    "test_beta_binomial",
    "test_ginibre_rank1_is_pure",
    "test_haar_uniform_qutrit",
    "test_ginibre_uniform",
    "test_postselected",
    "test_crosscheck_rb",
    "test_crosscheck_tomography",
    "test_crosscheck_ramsey",
    "test_engine_call_counters",
    "test_track_resampling_divergence",
    "test_batch_update_equivalent_convergence",
    "test_resampler_fallback_warns_and_counts",
    "test_bcrb_fresh_updater_does_not_raise",
    "test_sharded_scan_loop",
    "test_sharded_updater_convergence_and_sharding_preserved",
    "test_batch_update_commits_prefix_on_zero_weight",
    "test_perf_test_multiple_serial_and_injected_apply",
    "test_perf_test_scan_matches_host_loop_statistically",
    "test_gadfli_concentrates_near_fiducial",
    "test_random_pauli_heuristic_effects_valid",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.fspath.basename in SLOW_MODULES
                or item.originalname in SLOW_TESTS
                or item.name.split("[")[0] in SLOW_TESTS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _derandomize():
    """Reference parity: ``tests/base_test.py::DerandomizedTestCase`` seeds
    NumPy's global RNG; JAX code uses explicit keys per test."""
    np.random.seed(0)
    yield


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips otherwise. Tests that
    need the card carry ``@pytest.mark.gpu`` and take this fixture (the
    decision is made here, never at import or collection time)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
