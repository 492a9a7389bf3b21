"""Regression tests for the round-1 judge's confirmed bugs and parity gaps
(VERDICT.md round 1, "What's weak" #1-#4 and "Parity polish").

Each test reproduces a probe from the verdict:
* ALE wrapping a time-dependent simulator crashed (update_timestep dropped
  the engine's key argument).
* MultinomialModel delegated its design-time outcome grid to the underlying
  die, so bayes_risk marginalized over the wrong outcomes.
* SMCUpdaterBCRB.current_bcrb raised LinAlgError on a fresh updater with a
  flat prior.
* GaussianRandomWalkModel(diagonal=False) was silently ignored.
* experiment_cost defaulted to the 't' field where the reference returns 1.
* The resampler's bounded-redraw fallback was silent (no ResamplerWarning).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qinfer_tpu as q
from qinfer_tpu._exceptions import ResamplerWarning


# ---------------------------------------------------------------------------
# ALE + time dependence (VERDICT weak #1)
# ---------------------------------------------------------------------------

def test_ale_wraps_time_dependent_simulator():
    """Reference parity: ``src/qinfer/ale.py::ALEApproximateModel`` must
    compose with ``derived_models.py::RandomWalkModel`` (update_timestep
    keyed contract)."""
    walk = q.RandomWalkModel(
        q.CoinModel(), q.NormalDistribution(0.0, 1e-6))
    model = q.ALEApproximateModel(walk, error_tol=0.1, min_samp=10,
                                  samp_step=10)
    assert model.is_time_dependent
    u = q.SMCUpdater(model, 200, q.UniformDistribution([[0.1, 0.9]]),
                     seed=0)
    eps = {"exp_num": jnp.array([0])}
    u.update(jnp.asarray(1), eps)
    u.update(jnp.asarray(0), eps)
    assert np.isfinite(float(u.est_mean()[0]))

    # direct keyed call matches the Simulatable contract shape
    out = model.update_timestep(
        jax.random.key(0), jnp.array([[0.5]]), {"exp_num": jnp.array([0])})
    assert out.shape == (1, 1, 1)


# ---------------------------------------------------------------------------
# MultinomialModel design grid (VERDICT weak #2)
# ---------------------------------------------------------------------------

def test_multinomial_outcome_grid_covers_count_vectors():
    die = q.NDieModel(3)
    model = q.MultinomialModel(die, n_meas_max=4)
    eps = {"n_meas": jnp.array([4])}

    grid = np.asarray(model.outcomes(eps))
    mask = np.asarray(model.outcome_mask(eps))
    # grid enumerates every count vector with total <= n_meas_max once
    assert grid.shape == (model.n_outcomes(), 3)
    from math import comb

    assert model.n_outcomes() == comb(4 + 3, 3)
    totals = grid.sum(axis=1)
    assert set(map(tuple, grid)) == {
        (a, b, c) for a in range(5) for b in range(5) for c in range(5)
        if a + b + c <= 4}
    # the masked rows are exactly the C(n+k-1, k-1) = 15 vectors of
    # MultinomialDomain(4, 3)
    assert mask[:, 0].sum() == 15
    np.testing.assert_array_equal(mask[:, 0], totals == 4)

    # likelihood over the masked grid sums to 1 for every particle
    # (the round-1 probe measured 0.144 against the die's scalar grid)
    # NDieModel's modelparams are ALL n face probabilities (3 columns).
    # (Round-2 note: this check previously ran with 2-column params AND an
    # empty inner expparams dict, which collapsed the likelihood to an
    # n_e=0 array — assert_allclose passes vacuously on empty arrays. The
    # round-3 canonicalize_expparams({}) fix made the evaluation real.)
    mps = jnp.array([[0.2, 0.5, 0.3], [0.4, 0.3, 0.3]])
    L = np.asarray(model.likelihood(model.outcomes(eps), mps, eps))
    assert L.shape == (model.n_outcomes(), 2, 1)
    masked_sum = (L * mask[:, None, :]).sum(axis=0)
    np.testing.assert_allclose(masked_sum, 1.0, atol=1e-5)


def test_multinomial_bayes_risk_and_ig_finite():
    die = q.NDieModel(3)
    model = q.MultinomialModel(die, n_meas_max=3)
    prior = q.UniformDistribution(
        [[0.1, 0.4], [0.1, 0.4], [0.1, 0.4]])
    u = q.SMCUpdater(model, 100, prior, seed=0)
    eps = {"n_meas": jnp.array([3, 2]),
           "exp_num": jnp.array([0, 0])}
    risk = np.asarray(u.bayes_risk(eps))
    ig = np.asarray(u.expected_information_gain(eps))
    assert risk.shape == (2,) and np.all(np.isfinite(risk))
    assert ig.shape == (2,) and np.all(np.isfinite(ig))
    assert np.all(ig >= -1e-6)
    # more repetitions are more informative
    assert ig[0] > ig[1]


def test_multinomial_n_outcomes_trace_safe():
    model = q.MultinomialModel(q.NDieModel(3), n_meas_max=3)

    @jax.jit
    def f(n_meas):
        eps = {"n_meas": n_meas, "exp_num": jnp.array([0])}
        # n_outcomes/outcomes/outcome_mask must not int() traced values
        mask = model.outcome_mask(eps)
        return mask.sum()

    assert int(f(jnp.array([2]))) == 6  # C(2+3-1, 3-1) = 6 vectors


# ---------------------------------------------------------------------------
# BCRB pinv (VERDICT weak #3)
# ---------------------------------------------------------------------------

def test_bcrb_fresh_updater_does_not_raise():
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    u = q.SMCUpdaterBCRB(model, 200, prior, seed=0)
    bcrb = u.current_bcrb  # round-1 probe: LinAlgError here
    assert bcrb.shape == (1, 1)
    u.update(0, {"t": jnp.array([5.0])})
    assert np.isfinite(u.current_bcrb).all()
    assert u.current_bcrb[0, 0] > 0


# ---------------------------------------------------------------------------
# GaussianRandomWalkModel full covariance (VERDICT missing #6)
# ---------------------------------------------------------------------------

class _TwoParamCoin(q.CoinModel):
    """Two-parameter test model (second parameter inert)."""

    @property
    def n_modelparams(self):
        return 2

    @property
    def modelparam_names(self):
        return ["p", "nuisance"]

    def likelihood(self, outcomes, modelparams, expparams):
        return super().likelihood(outcomes, modelparams[:, :1], expparams)

    def are_models_valid(self, modelparams):
        p = modelparams[:, 0]
        return (p >= 0) & (p <= 1)


def test_gaussian_random_walk_full_covariance_steps():
    cov = np.array([[1e-2, 0.9e-2], [0.9e-2, 1e-2]])
    model = q.GaussianRandomWalkModel(
        _TwoParamCoin(), scale=cov, diagonal=False)
    mps = jnp.tile(jnp.array([[0.5, 0.5]]), (4000, 1))
    stepped = model.update_timestep(
        jax.random.key(0), mps, {"exp_num": jnp.array([0])})[:, :, 0]
    steps = np.asarray(stepped - mps)
    emp = np.cov(steps.T)
    np.testing.assert_allclose(emp, cov, atol=2e-3)


def test_gaussian_random_walk_learned_full_covariance():
    model = q.GaussianRandomWalkModel(
        _TwoParamCoin(), diagonal=False, model_mu_sigma=True)
    # 2 underlying + 3 Cholesky entries
    assert model.n_modelparams == 5
    assert len(model.modelparam_names) == 5
    assert np.asarray(model.Q).shape == (5,)
    # per-particle Cholesky L = [[e^a, 0], [b, e^c]] drives the walk
    a, b, c = np.log(0.1), 0.05, np.log(0.2)
    mps = jnp.tile(jnp.array([[0.5, 0.5, a, b, c]]), (4000, 1))
    stepped = model.update_timestep(jax.random.key(1), mps, {"exp_num": jnp.array([0])})[:, :, 0]
    steps = np.asarray(stepped[:, :2] - mps[:, :2])
    L = np.array([[0.1, 0.0], [0.05, 0.2]])
    np.testing.assert_allclose(np.cov(steps.T), L @ L.T, atol=2e-3)
    # learned tail is carried through unchanged
    np.testing.assert_allclose(np.asarray(stepped[:, 2:]),
                               np.asarray(mps[:, 2:]), atol=1e-7)


def test_gaussian_random_walk_matrix_scale_requires_full():
    with pytest.raises(ValueError):
        q.GaussianRandomWalkModel(
            _TwoParamCoin(), scale=np.eye(2), diagonal=True)


# ---------------------------------------------------------------------------
# experiment_cost default (VERDICT missing #6)
# ---------------------------------------------------------------------------

def test_experiment_cost_defaults_to_ones():
    model = q.SimplePrecessionModel()
    eps = {"t": jnp.array([3.0, 7.0])}
    np.testing.assert_array_equal(
        np.asarray(model.experiment_cost(eps)), [1.0, 1.0])


# ---------------------------------------------------------------------------
# ResamplerWarning emission (VERDICT missing #4)
# ---------------------------------------------------------------------------

class _NeverValidCoin(q.CoinModel):
    """Every proposal is invalid — forces the bounded-redraw fallback."""

    def are_models_valid(self, modelparams):
        return jnp.zeros((modelparams.shape[0],), dtype=bool)


def test_resampler_fallback_warns_and_counts():
    model = _NeverValidCoin()
    prior = q.UniformDistribution([[0.2, 0.8]])
    u = q.SMCUpdater(model, 64, prior, seed=0)
    assert u.resampler_fallback_count == 0
    with pytest.warns(ResamplerWarning):
        u.resample()
    assert u.resampler_fallback_count == 64


def test_resampler_no_warning_when_valid():
    import warnings as _w

    u = q.SMCUpdater(q.CoinModel(), 64,
                     q.UniformDistribution([[0.2, 0.8]]), seed=0)
    with _w.catch_warnings():
        _w.simplefilter("error", ResamplerWarning)
        u.resample()
    assert u.resampler_fallback_count == 0


def test_fallback_warning_through_jitted_update():
    """The count must survive the fused jitted step (lax.cond branch)."""
    model = _NeverValidCoin()
    prior = q.UniformDistribution([[0.2, 0.8]])
    u = q.SMCUpdater(model, 64, prior, resample_thresh=1.1, seed=0)
    with pytest.warns(ResamplerWarning):
        u.update(jnp.asarray(1), {"exp_num": jnp.array([0])})
    assert u.resampler_fallback_count == 64


# ---------------------------------------------------------------------------
# est_kl_divergence chunking (VERDICT weak #4)
# ---------------------------------------------------------------------------

def test_est_kl_divergence_matches_dense_reference():
    prior = q.UniformDistribution([[0.0, 1.0]])
    u1 = q.SMCUpdater(q.SimplePrecessionModel(), 300, prior, seed=0)
    u2 = q.SMCUpdater(q.SimplePrecessionModel(), 300, prior, seed=1)
    u1.update(0, {"t": jnp.array([5.0])})
    chunked = float(u1.est_kl_divergence(u2, kernel_bandwidth=0.05))

    # dense re-computation of the same estimator
    def log_kde(pts, w_ref, x_ref, h2):
        d2 = np.sum((pts[:, None, :] - x_ref[None, :, :]) ** 2, axis=-1)
        lw = np.log(np.clip(np.asarray(w_ref), 1e-35, None))
        m = (-0.5 * d2 / h2 + lw[None, :])
        mx = m.max(axis=1, keepdims=True)
        lse = np.log(np.exp(m - mx).sum(axis=1)) + mx[:, 0]
        return lse - 0.5 * pts.shape[1] * np.log(2 * np.pi * h2)

    xp = np.asarray(u1.particle_locations)
    wp = np.asarray(u1.particle_weights)
    xq = np.asarray(u2.particle_locations)
    wq = np.asarray(u2.particle_weights)
    dense = float(np.sum(wp * (log_kde(xp, wp, xp, 0.05 ** 2)
                               - log_kde(xp, wq, xq, 0.05 ** 2))))
    np.testing.assert_allclose(chunked, dense, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# ops/resample duplicate removal (VERDICT weak #7)
# ---------------------------------------------------------------------------

def test_ancestor_multiplicities_shares_guarded_impl():
    from qinfer_tpu.ops.resample import ancestor_multiplicities
    from qinfer_tpu.resamplers import counting_multiplicities_from_u

    w = jnp.asarray(np.random.default_rng(0).random(4096).astype(np.float32))
    w = w / w.sum()
    m1 = np.asarray(ancestor_multiplicities(w, 0.37))
    m2, _ = counting_multiplicities_from_u(0.37, w, w.shape[0])
    np.testing.assert_array_equal(m1, np.asarray(m2))
    assert m1.sum() == 4096
    assert m1.min() >= 0


# ---------------------------------------------------------------------------
# Round-2 review findings
# ---------------------------------------------------------------------------

def test_liu_west_fill_strategy_override():
    """``LiuWestResampler(fill_strategy=...)`` pins the ancestor-fill
    strategy (benchmarks use this to compare the fills through the full
    engine); all strategies implement the same resampling law, so
    posteriors must stay statistically identical."""
    from qinfer_tpu.resamplers import LiuWestResampler

    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (512, 2))
    w = jax.random.dirichlet(k2, jnp.ones(512))
    model = q.SimplePrecessionModel()

    outs = {}
    for strat in ("gather", "scan", "telescope"):
        rs = LiuWestResampler(a=0.98, fill_strategy=strat)
        outs[strat] = rs(model, key, w, x)
    # same key + same counting prelude: ancestors agree, so the proposals
    # agree up to fill-strategy float-associativity (telescope cancels)
    np.testing.assert_allclose(np.asarray(outs["scan"][1]),
                               np.asarray(outs["telescope"][1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(outs["scan"][1]),
                                  np.asarray(outs["gather"][1]))
    with pytest.raises(ValueError):
        LiuWestResampler(fill_strategy="bogus")


def test_multinomial_huge_grid_fails_fast():
    """A combinatorially intractable design grid must raise a pointed
    error from ``outcomes()`` instead of hanging in a recursive Python
    enumeration and then OOMing in bayes_risk; simulation paths that
    never touch the grid keep working."""
    die = q.NDieModel(n=6)
    m = q.MultinomialModel(die, n_meas_max=32)   # C(38,6) ~ 2.76e6 rows
    eps = {"exp_num": jnp.array([0], dtype=jnp.int32),
           "n_meas": jnp.array([4], dtype=jnp.int32)}
    mps = jnp.asarray(die.canonicalize(
        jnp.full((1, die.n_modelparams), 1.0 / 6.0)))
    out = m.simulate_experiment(jax.random.key(0), mps, eps)
    assert np.asarray(out).sum() == 4
    with pytest.raises(ValueError, match="n_meas_max"):
        m.outcomes(eps)


def test_log_reweight_shift_includes_weights():
    """The log-space reweight must shift by max(log w + logL), not
    max(logL): when the best-FITTING particle carries negligible weight,
    the old shift underflowed every summand and raised a spurious
    ZeroWeightError at healthy ESS (probe: BinomialModel, 50 shots,
    resample_interval=5)."""
    model = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=50)
    w = jnp.concatenate([jnp.full((999,), 1e-3 / 999),
                         jnp.array([1.0 - 1e-3])])
    # the heavy particle fits the outcome poorly, light particles span
    # the space; previously only near-max-logL particles survived the
    # shift and the heavy particle's summand underflowed
    locs = jnp.linspace(0.0, 1.0, 1000)[:, None]
    eps = {"t": jnp.array([25.0], jnp.float32),
           "n_meas": jnp.array([50], jnp.int32)}
    from qinfer_tpu.smc import _reweight

    hyp, norm, log_norm = _reweight(model, w, locs, jnp.asarray(25), eps,
                                    None)
    assert float(norm) > 0.0
    assert np.isfinite(float(log_norm))
    post = np.asarray(hyp / norm)
    assert np.isfinite(post).all() and abs(post.sum() - 1.0) < 1e-5
