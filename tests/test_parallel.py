"""Parallel backend tests — multi-device sharding on the virtual 8-device
CPU mesh, plus the DirectView parity shim with a serial mock.

Reference parity: ``src/qinfer/tests/test_parallel.py`` pattern — the
reference tests ``DirectViewParallelizedModel`` with an in-process mock view
(SURVEY.md §4 "Distributed tests without a cluster"); the mesh tests are the
device-mesh equivalent using ``xla_force_host_platform_device_count``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qinfer_tpu as q
from qinfer_tpu.parallel import ParticleMesh, DirectViewParallelizedModel


def test_virtual_mesh_present():
    assert len(jax.devices()) == 8


def test_particle_mesh_properties():
    pm = ParticleMesh()
    assert pm.n_devices == 8
    assert pm.pad_particles(1000) == 1000
    assert pm.pad_particles(1001) == 1008


def test_sharded_updater_convergence_and_sharding_preserved():
    pm = ParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    u = q.SMCUpdater(model, 8000, prior, seed=1,
                     sharding=pm.particle_sharding)
    key = jax.random.key(2)
    for k in range(40):
        t = (9 / 8) ** k / 10
        key, sk = jax.random.split(key)
        o = model.simulate_experiment(
            sk, jnp.array([[0.62]]), {"t": jnp.array([t])})
        u.update(o, {"t": jnp.array([t])})
    std = float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
    assert abs(float(u.est_mean()[0]) - 0.62) < 6 * std + 0.01
    # the particle axis must still be sharded over all 8 devices
    assert len(u.particle_weights.sharding.device_set) == 8
    assert len(u.particle_locations.sharding.device_set) == 8


def test_sharded_matches_unsharded():
    """Same seed: sharded and single-device runs must agree numerically
    (sharding is a layout, not an algorithm change)."""
    pm = ParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])

    def run(sharding):
        u = q.SMCUpdater(model, 4000, prior, seed=7, sharding=sharding)
        key = jax.random.key(3)
        for k in range(15):
            t = float(k + 1)
            key, sk = jax.random.split(key)
            o = model.simulate_experiment(
                sk, jnp.array([[0.5]]), {"t": jnp.array([t])})
            # resampling disabled: a single ancestor-index difference from
            # reduction reordering would chaotically diverge trajectories;
            # the pure reweighting path must agree to float tolerance.
            u.update(o, {"t": jnp.array([t])}, check_for_resample=False)
        return np.asarray(u.est_mean()), np.asarray(u.est_covariance_mtx())

    mean_s, cov_s = run(pm.particle_sharding)
    mean_u, cov_u = run(None)
    np.testing.assert_allclose(mean_s, mean_u, atol=1e-4)
    np.testing.assert_allclose(cov_s, cov_u, atol=1e-5)


def test_sharded_scan_loop():
    pm = ParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    u, rec = q.perf_testing.perf_test_scan(
        model, 8000, prior, 30, seed=11, sharding=pm.particle_sharding)
    assert float(rec["loss"][-1]) < 0.05
    assert len(u.particle_weights.sharding.device_set) == 8


def test_shard_existing_updater():
    pm = ParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    u = q.SMCUpdater(model, 800, prior, seed=0)
    pm.shard_updater(u)
    assert len(u.particle_weights.sharding.device_set) == 8
    u.update(0, {"t": jnp.array([1.0])})
    assert np.isfinite(float(u.est_mean()[0]))


def test_sharded_experiment_design_scores():
    """BASELINE config 5 path: EIG / Bayes-risk scoring over a candidate
    batch with the particle axis sharded — the (n_out, n, n_cand)
    likelihood contraction must cross the sharding (XLA auto-collectives)
    and agree with the unsharded scores."""
    pm = ParticleMesh()
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    cand = {"t": jnp.geomspace(0.5, 50.0, 12).astype(jnp.float32)}

    u_sh = q.SMCUpdater(model, 4000, prior, seed=21,
                        sharding=pm.particle_sharding)
    u_ser = q.SMCUpdater(model, 4000, prior, seed=21)
    for k in range(5):
        t = {"t": jnp.array([(9 / 8) ** k])}
        u_sh.update(1, t)
        u_ser.update(1, t)

    eig_sh = np.asarray(u_sh.expected_information_gain(cand))
    eig_ser = np.asarray(u_ser.expected_information_gain(cand))
    risk_sh = np.asarray(u_sh.bayes_risk(cand))
    risk_ser = np.asarray(u_ser.bayes_risk(cand))
    assert eig_sh.shape == (12,) and np.all(np.isfinite(eig_sh))
    np.testing.assert_allclose(eig_sh, eig_ser, rtol=1e-5, atol=1e-6)
    # risk's posterior variance (E[x²] − μ²) is cancellation-sensitive, so
    # the sharded reduction order shifts it more than the entropy sums
    np.testing.assert_allclose(risk_sh, risk_ser, rtol=2e-3, atol=1e-6)


def test_sharded_rejuvenation_runs_and_preserves_sharding():
    """Resample-move rejuvenation with the particle axis sharded: the
    record-likelihood pass and the MH moves must cross the sharding (XLA
    auto-collectives for the ensemble covariance / acceptance reductions)
    and hand back a sharded, statistically-correct ensemble."""
    import scipy.stats as st

    pm = ParticleMesh()
    model = q.BinomialModel(q.CoinModel(), n_meas_max=20)
    prior = q.UniformDistribution([[0.0, 1.0]])
    counts = jnp.asarray([14, 15, 13, 14, 14], jnp.int32)
    eps = {"exp_num": jnp.zeros((5,), jnp.int32),
           "n_meas": jnp.full((5,), 20, jnp.int32)}
    u = q.SMCUpdater(model, 4000, prior, seed=5, n_mcmc_moves=5,
                     resample_thresh=0.9, sharding=pm.particle_sharding)
    u.batch_update(counts, eps, resample_interval=1)
    ref = st.beta(71, 31)
    assert abs(float(u.est_mean()[0]) - ref.mean()) < 0.02
    assert abs(float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
               - ref.std()) < 0.015
    assert len(u.particle_locations.sharding.device_set) == 8


def test_sharded_compressed_rejuvenation():
    """The round-4 sufficient-statistic rejuvenation under a sharded
    particle axis: the (n, E) pool likelihood pass and the MH reductions
    must cross the sharding exactly like the full-record path, with the
    conjugate Beta posterior recovered and the sharding preserved."""
    import scipy.stats as st

    pm = ParticleMesh()
    model = q.BinomialModel(q.CoinModel(), n_meas_max=20)
    prior = q.UniformDistribution([[0.0, 1.0]])
    counts = jnp.asarray([14, 15, 13, 14, 14], jnp.int32)
    eps = {"exp_num": jnp.zeros((5,), jnp.int32),
           "n_meas": jnp.full((5,), 20, jnp.int32)}
    u = q.SMCUpdater(model, 4000, prior, seed=5, n_mcmc_moves=5,
                     resample_thresh=0.9, sharding=pm.particle_sharding,
                     compress_mcmc_record=True, mcmc_canonicalize=False)
    u.batch_update(counts, eps, resample_interval=1)
    assert len(u._pool_eps) == 1  # one distinct experiment, 100 trials
    assert u._pool_trials[0] == 100.0
    ref = st.beta(71, 31)
    assert abs(float(u.est_mean()[0]) - ref.mean()) < 0.02
    assert abs(float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
               - ref.std()) < 0.015
    assert len(u.particle_locations.sharding.device_set) == 8


def test_sharded_waste_free_engine():
    """SMCUpdater(waste_free_stages=P) under an 8-device particle
    sharding: the ancestor resample-gather, chain scan, and pool pass
    cross the mesh; posterior matches the conjugate Beta and the output
    stays distributed."""
    import scipy.stats as st

    pm = ParticleMesh()
    model = q.BinomialModel(q.CoinModel(), n_meas_max=20)
    prior = q.UniformDistribution([[0.0, 1.0]])
    counts = jnp.asarray([14, 15, 13, 14, 14], jnp.int32)
    eps = {"exp_num": jnp.zeros((5,), jnp.int32),
           "n_meas": jnp.full((5,), 20, jnp.int32)}
    u = q.SMCUpdater(model, 4096, prior, seed=5, resample_thresh=0.9,
                     sharding=pm.particle_sharding,
                     compress_mcmc_record=True, waste_free_stages=8,
                     zero_weight_policy="reset")
    u.batch_update(counts, eps, resample_interval=1)
    assert int(u.resample_count) >= 1
    ref = st.beta(71, 31)
    assert abs(float(u.est_mean()[0]) - ref.mean()) < 0.02
    assert abs(float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
               - ref.std()) < 0.015
    assert len(u.particle_locations.sharding.device_set) == 8


class MockDirectView:
    """Serial stand-in for an ipyparallel DirectView (the reference's test
    pattern)."""

    def __init__(self, n_engines=4):
        self.n = n_engines
        self.apply_calls = 0

    def __len__(self):
        return self.n

    def apply(self, f, *args):
        self.apply_calls += 1
        return f(*args)


def test_directview_matches_serial():
    model = q.SimplePrecessionModel()
    view = MockDirectView(4)
    par = DirectViewParallelizedModel(model, view, serial_threshold=1)
    mps = jnp.linspace(0, 1, 64)[:, None]
    eps = {"t": jnp.array([1.0, 2.0])}
    L_par = par.likelihood(jnp.array([0, 1]), mps, eps)
    L_ser = model.likelihood(jnp.array([0, 1]), mps, eps)
    np.testing.assert_allclose(np.asarray(L_par), np.asarray(L_ser),
                               atol=1e-6)
    assert view.apply_calls == 4  # one chunk per engine
    assert par.n_engines == 4


def test_directview_serial_fallback_below_threshold():
    model = q.SimplePrecessionModel()
    view = MockDirectView(4)
    par = DirectViewParallelizedModel(model, view, serial_threshold=1000)
    mps = jnp.linspace(0, 1, 8)[:, None]
    par.likelihood(jnp.array([0]), mps, {"t": jnp.array([1.0])})
    assert view.apply_calls == 0


def test_directview_smc_end_to_end():
    model = q.SimplePrecessionModel()
    par = DirectViewParallelizedModel(model, MockDirectView(2),
                                      serial_threshold=1)
    prior = q.UniformDistribution([[0.0, 1.0]])
    u = q.SMCUpdater(par, 400, prior, seed=0)
    key = jax.random.key(1)
    for k in range(10):
        key, sk = jax.random.split(key)
        o = model.simulate_experiment(
            sk, jnp.array([[0.5]]), {"t": jnp.array([float(k + 1)])})
        u.update(o, {"t": jnp.array([float(k + 1)])})
    assert np.isfinite(float(u.est_mean()[0]))
