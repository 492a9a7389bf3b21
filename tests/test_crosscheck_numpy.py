"""Matched-config posterior cross-check against an independent float64
NumPy SMC implementation.

BASELINE.md's correctness bar is "posterior mean/cov vs reference within
MC error at matched particle counts". The reference mount is empty
(SURVEY.md §0), so the closest attainable evidence is agreement with an
INDEPENDENT re-implementation of the reference algorithm (written here
from the algorithm statement in SURVEY.md §3.2/§2#5 — plain f64 NumPy,
multinomial ancestors, scipy-free Liu-West) on the SAME fixed data
record. Both engines approximate the same fixed posterior, so their
estimates must agree within combined Monte-Carlo error.

The NumPy engine runs several independent seeds to measure its own MC
spread; the qinfer_tpu posterior mean must land within a few of those
standard errors, and posterior standard deviations must match to ~10%.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qinfer_tpu as q


# ---------------------------------------------------------------------------
# Independent reference engine (f64 NumPy, algorithm per SURVEY.md)
# ---------------------------------------------------------------------------

def numpy_smc(likelihood_fn, prior_sample_fn, valid_fn, outcomes, eps_list,
              n_particles, seed, a=0.98, resample_thresh=0.5, maxiter=10):
    """Plain-NumPy SMC with Liu-West resampling (multinomial ancestors,
    exactly the reference's law).

    :param likelihood_fn: (outcome, particles (n, d), eps) -> (n,) f64
    :param prior_sample_fn: (rng, n) -> (n, d)
    :param valid_fn: (particles) -> bool mask
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(prior_sample_fn(rng, n_particles), dtype=np.float64)
    w = np.full(n_particles, 1.0 / n_particles)
    h = np.sqrt(max(1.0 - a * a, 0.0))
    for outcome, eps in zip(outcomes, eps_list):
        L = np.asarray(likelihood_fn(outcome, x, eps), dtype=np.float64)
        w = w * L
        s = w.sum()
        assert s > 0
        w = w / s
        n_ess = 1.0 / np.sum(w * w)
        if n_ess <= resample_thresh * n_particles:
            mu = w @ x
            cov = (w[:, None] * (x - mu)).T @ (x - mu)
            cov += 1e-10 * np.eye(x.shape[1])
            S = np.linalg.cholesky(cov)
            anc = rng.choice(n_particles, size=n_particles, p=w)
            centers = a * x[anc] + (1 - a) * mu
            prop = centers + h * rng.standard_normal(x.shape) @ S.T
            bad = ~valid_fn(prop)
            for _ in range(maxiter):
                if not bad.any():
                    break
                fresh = centers[bad] + h * rng.standard_normal(
                    (bad.sum(), x.shape[1])) @ S.T
                ok = valid_fn(fresh)
                idx = np.nonzero(bad)[0][ok]
                prop[idx] = fresh[ok]
                bad = ~valid_fn(prop)
            prop[bad] = x[anc][bad]   # ancestor fallback
            x = prop
            w = np.full(n_particles, 1.0 / n_particles)
    return w, x


def _moments(w, x):
    mu = w @ x
    cov = (w[:, None] * (x - mu)).T @ (x - mu)
    return mu, cov


def compare_with_oracle(mu_t, sd_t, np_likelihood, np_prior, np_valid,
                        outcomes, eps_list, n_particles, n_ref_seeds=8,
                        sd_rtol=0.35):
    """Assert that posterior means ``mu_t`` and standard deviations
    ``sd_t`` agree with ``n_ref_seeds`` runs of the float64 NumPy engine
    at ``n_particles`` on the same record; return the diagnostics."""
    mus, sds = [], []
    for s in range(n_ref_seeds):
        w, x = numpy_smc(np_likelihood, np_prior, np_valid,
                         outcomes, eps_list, n_particles, seed=100 + s)
        mu, cov = _moments(w, x)
        mus.append(mu)
        sds.append(np.sqrt(np.diag(cov)))
    mus = np.asarray(mus)
    sds = np.asarray(sds)
    mu_ref = mus.mean(axis=0)
    # MC spread of one engine's estimate around the true posterior mean;
    # both engines carry it, hence the sqrt(2); guard against a degenerate
    # spread estimate with a floor at 10% of the posterior sd
    se = np.maximum(mus.std(axis=0, ddof=1), 0.1 * sds.mean(axis=0))
    z = np.abs(mu_t - mu_ref) / (np.sqrt(2.0) * se)
    # explicit raises: chip_smoke.py relies on these checks outside pytest
    if not np.all(z < 4.0):
        raise AssertionError(
            f"posterior means disagree beyond MC error: ours {mu_t}, "
            f"NumPy-f64 {mu_ref} ± {se}, z = {z}")
    rel = np.abs(sd_t - sds.mean(axis=0)) / sds.mean(axis=0)
    if not np.all(rel < sd_rtol):
        raise AssertionError(
            f"posterior sds disagree: ours {sd_t}, ref {sds.mean(axis=0)}")
    return {"mean": mu_t, "mean_ref": mu_ref, "z": z, "sd": sd_t,
            "sd_ref": sds.mean(axis=0), "sd_rel_err": rel}


def posterior_moments(updater):
    """float64 posterior mean and standard deviations of an updater."""
    mu = np.asarray(updater.est_mean(), dtype=np.float64)
    sd = np.sqrt(np.diag(np.asarray(updater.est_covariance_mtx(),
                                    dtype=np.float64)))
    return mu, sd


def _crosscheck(updater, np_likelihood, np_prior, np_valid,
                outcomes, eps_list, eps_batch, n_particles, n_ref_seeds=8,
                sd_rtol=0.35):
    updater.batch_update(jnp.asarray(outcomes), eps_batch)
    mu_t, sd_t = posterior_moments(updater)
    compare_with_oracle(mu_t, sd_t, np_likelihood, np_prior, np_valid,
                        outcomes, eps_list, n_particles, n_ref_seeds,
                        sd_rtol)


# ---------------------------------------------------------------------------
# BASELINE config 1: SimplePrecession + Binomial counts, 5k particles
# ---------------------------------------------------------------------------

class OracleProblem:
    """A fixed data record with the device model and the float64 NumPy
    oracle's likelihood, prior sampler and validity test for it."""

    def __init__(self, model, prior, np_likelihood, np_prior, np_valid,
                 outcomes, eps_list, eps_batch):
        self.model = model
        self.prior = prior
        self.np_likelihood = np_likelihood
        self.np_prior = np_prior
        self.np_valid = np_valid
        self.outcomes = outcomes
        self.eps_list = eps_list
        self.eps_batch = eps_batch

    def check(self, updater, n_ref_particles, n_ref_seeds=8, sd_rtol=0.35):
        """Compare ``updater``'s posterior (already conditioned on the
        record) with the oracle at ``n_ref_particles``."""
        mu_t, sd_t = posterior_moments(updater)
        return compare_with_oracle(
            mu_t, sd_t, self.np_likelihood, self.np_prior, self.np_valid,
            self.outcomes, self.eps_list, n_ref_particles, n_ref_seeds,
            sd_rtol)


def precession_binomial_problem(n_exp=30, n_shots=10, true_omega=0.57):
    """SimplePrecession + binomial counts at PGH-like growing times."""
    from scipy.stats import binom

    ts = np.asarray([(9 / 8) ** k / 4 for k in range(n_exp)],
                    dtype=np.float64)
    # one fixed data record, generated once
    rng = np.random.default_rng(0)
    counts = rng.binomial(n_shots, np.cos(true_omega * ts / 2) ** 2)

    def np_likelihood(outcome, x, t):
        p0 = np.cos(x[:, 0] * t / 2) ** 2
        return binom.pmf(outcome, n_shots, p0)

    return OracleProblem(
        q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=n_shots),
        q.UniformDistribution([[0.0, 1.0]]),
        np_likelihood,
        lambda rng, n: rng.uniform(0.0, 1.0, (n, 1)),
        lambda x: (x[:, 0] >= 0.0) & (x[:, 0] <= 1.0),
        counts, list(ts),
        {"t": jnp.asarray(ts, jnp.float32),
         "n_meas": jnp.full((len(ts),), n_shots, jnp.int32)})


def test_crosscheck_precession_binomial():
    n_particles = 5000
    prob = precession_binomial_problem()
    u = q.SMCUpdater(prob.model, n_particles, prob.prior, seed=7)
    _crosscheck(u, prob.np_likelihood, prob.np_prior, prob.np_valid,
                prob.outcomes, prob.eps_list, prob.eps_batch, n_particles)


# ---------------------------------------------------------------------------
# BASELINE config 3: randomized benchmarking (p, A, B)
# ---------------------------------------------------------------------------

def test_crosscheck_rb():
    n_particles = 5000
    n_shots = 25
    true = np.array([0.92, 0.3, 0.5])
    ms = np.asarray(sorted(list(range(1, 20)) * 2), dtype=np.float64)

    rng = np.random.default_rng(1)
    f = true[1] * true[0] ** ms + true[2]
    counts = rng.binomial(n_shots, f)

    from scipy.stats import binom

    lo = np.array([0.6, 0.2, 0.4])
    hi = np.array([0.99, 0.4, 0.5])

    def np_likelihood(outcome, x, m):
        p0 = np.clip(x[:, 1] * x[:, 0] ** m + x[:, 2], 0.0, 1.0)
        return binom.pmf(outcome, n_shots, p0)

    def np_valid(x):
        box = np.all((x >= lo) & (x <= hi), axis=1)
        return box & (x[:, 1] + x[:, 2] <= 1.0)

    model = q.BinomialModel(q.RandomizedBenchmarkingModel(),
                            n_meas_max=n_shots)
    u = q.SMCUpdater(model, n_particles,
                     q.UniformDistribution(np.stack([lo, hi], 1)), seed=9)
    eps_batch = {"m": jnp.asarray(ms, jnp.float32),
                 "n_meas": jnp.full((len(ms),), n_shots, jnp.int32)}
    _crosscheck(
        u,
        np_likelihood,
        lambda rng, n: rng.uniform(lo, hi, (n, 3)),
        np_valid,
        counts, list(ms), eps_batch, n_particles)


# ---------------------------------------------------------------------------
# BASELINE config 2: Ramsey with T2 nuisance (omega, Gamma)
# ---------------------------------------------------------------------------

def test_crosscheck_ramsey():
    n_particles = 8000
    n_shots = 20
    true = np.array([0.71, 0.08])
    ts = np.minimum(np.asarray([1.2 ** k for k in range(25)],
                               dtype=np.float64), 30.0)

    rng = np.random.default_rng(2)
    vis = np.exp(-true[1] * ts)
    pr0 = vis * np.cos(true[0] * ts / 2) ** 2 + (1 - vis) / 2
    counts = rng.binomial(n_shots, pr0)

    from scipy.stats import binom

    def np_likelihood(outcome, x, t):
        vis = np.exp(-x[:, 1] * t)
        p0 = vis * np.cos(x[:, 0] * t / 2) ** 2 + (1 - vis) / 2
        return binom.pmf(outcome, n_shots, p0)

    model = q.BinomialModel(q.RamseyModel(), n_meas_max=n_shots)
    u = q.SMCUpdater(model, n_particles,
                     q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                     seed=11)
    eps_batch = {"t": jnp.asarray(ts, jnp.float32),
                 "n_meas": jnp.full((len(ts),), n_shots, jnp.int32)}
    _crosscheck(
        u,
        np_likelihood,
        lambda rng, n: rng.uniform([0.0, 0.0], [1.0, 0.5], (n, 2)),
        lambda x: np.all((x >= 0) & (x <= [1.0, 0.5]), axis=1),
        counts, list(ts), eps_batch, n_particles)


# ---------------------------------------------------------------------------
# BASELINE config 4 family: qubit state tomography (Bloch coords)
# ---------------------------------------------------------------------------

def qubit_tomography_problem(n_exp=30, n_shots=15):
    """Qubit state tomography: a fixed cycle of Pauli-projector
    measurements on a fixed mixed state, Ginibre prior."""
    import qinfer_tpu.tomography as tomo
    from scipy.stats import binom

    basis = tomo.pauli_basis(1)
    # true state and a fixed cycle of Pauli-projector measurements
    rho_true = np.array([[0.8, 0.25 + 0.1j], [0.25 - 0.1j, 0.2]],
                        dtype=np.complex128)
    paulis = [np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]),
              np.array([[1, 0], [0, -1]])]
    projs = [(np.eye(2) + paulis[k % 3]) / 2 for k in range(n_exp)]

    # coordinates in the same normalized Pauli basis the device model uses
    def coords_of(H):
        ops = [np.eye(2)] + paulis
        return np.array([np.real(np.trace(op.conj().T @ H)) / np.sqrt(2)
                         for op in ops])

    meas_coords = [coords_of(E) for E in projs]
    rng = np.random.default_rng(3)
    counts = np.asarray([
        rng.binomial(n_shots, np.real(np.trace(E @ rho_true)))
        for E in projs])

    def np_likelihood(outcome, x, e_coords):
        # Born rule as a coordinate dot product; x excludes the (fixed)
        # trace coordinate 1/sqrt(2)
        full = np.concatenate(
            [np.full((x.shape[0], 1), 1 / np.sqrt(2)), x], axis=1)
        p0 = np.clip(full @ e_coords, 0.0, 1.0)
        return binom.pmf(outcome, n_shots, p0)

    def np_prior(rng, n):
        # Ginibre ensemble, rank 2
        g = (rng.standard_normal((n, 2, 2))
             + 1j * rng.standard_normal((n, 2, 2)))
        rho = g @ np.conj(np.transpose(g, (0, 2, 1)))
        rho /= np.trace(rho, axis1=1, axis2=2)[:, None, None].real
        out = np.empty((n, 3))
        for i, P in enumerate(paulis):
            out[:, i] = np.real(np.einsum("nab,ba->n", rho, P)) / np.sqrt(2)
        return out

    def np_valid(x):
        return 2.0 * np.sum(x * x, axis=1) <= 1.0 + 1e-6

    return OracleProblem(
        q.BinomialModel(tomo.TomographyModel(basis), n_meas_max=n_shots),
        tomo.GinibreDistribution(basis),
        np_likelihood, np_prior, np_valid, counts, meas_coords,
        {"meas": jnp.asarray(np.stack(meas_coords), jnp.float32),
         "n_meas": jnp.full((n_exp,), n_shots, jnp.int32)})


def test_crosscheck_tomography():
    n_particles = 8000
    prob = qubit_tomography_problem()
    u = q.SMCUpdater(prob.model, n_particles, prob.prior, seed=13)
    _crosscheck(u, prob.np_likelihood, prob.np_prior, prob.np_valid,
                prob.outcomes, prob.eps_list, prob.eps_batch, n_particles)
