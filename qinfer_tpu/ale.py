"""Approximate likelihood estimation (ALE).

Reference parity: ``src/qinfer/ale.py`` (SURVEY.md §2 #12) —
``ALEApproximateModel(simulator, error_tol, min_samp, samp_step, est_hedge,
adapt_hedge)`` wrapping a :class:`~qinfer_tpu.abstract_model.Simulatable`
that has no analytic likelihood, plus the hedged-beta estimator helpers
``binom_est_p`` / ``binom_est_error``.

Design: the reference hosts a loop that keeps adding
``samp_step`` simulations until the standard error drops below tolerance.
Here the same adaptivity runs *inside* jit: fixed-shape chunks of
``samp_step`` simulations accumulate under a ``lax.while_loop`` whose trip
count is data-dependent but whose every iteration is static-shaped, capped
by the worst-case budget ``n = clamp(0.25/tol^2, min_samp, max_samp)``. A
host-side ``ApproximationWarning`` fires when ``max_samp`` cannot reach the
requested tolerance (the reference warns in the same situation).
"""

from __future__ import annotations

import math
import warnings

import jax
import jax.numpy as jnp

from ._exceptions import ApproximationWarning
from .abstract_model import FiniteOutcomeModel, n_expparams

__all__ = ["ALEApproximateModel", "binom_est_p", "binom_est_error"]


def binom_est_p(n, N, hedge=0.0):
    """Hedged estimate of a binomial parameter: ``(n + h) / (N + 2h)``.

    Reference parity: ``src/qinfer/ale.py::binom_est_p``.
    """
    return (n + hedge) / (N + 2 * hedge)


def binom_est_error(p, N, hedge=0.0):
    """Standard error of the hedged binomial estimate.

    Reference parity: ``src/qinfer/ale.py::binom_est_error``.
    """
    return jnp.sqrt(p * (1 - p) / (N + 2 * hedge + 1))


class ALEApproximateModel(FiniteOutcomeModel):
    """Estimate likelihoods of a likelihood-free simulator by repeated
    simulation with a hedged beta estimator.

    Reference parity: ``src/qinfer/ale.py::ALEApproximateModel``.

    :param simulator: a :class:`Simulatable` with finite outcomes.
    :param float error_tol: target standard error of the estimate.
    :param int min_samp: minimum simulations per (model, experiment).
    :param int samp_step: granularity used to round the sample budget.
    :param float est_hedge: hedging for the returned estimate.
    :param float adapt_hedge: hedging used when sizing the sample budget.
    :param int max_samp: static cap on simulations (fixed-shape budget under jit).
    :param bool adaptive: when True (default), accumulate ``samp_step``-size
        simulation chunks under a ``lax.while_loop`` until the worst-cell
        standard error meets ``error_tol`` (jit-compatible adaptivity —
        reference parity with the host resampling loop); when False, always
        draw the full static worst-case budget in one batch.
    """

    #: The engine threads a fresh per-step PRNG key into ``likelihood`` so
    #: the Monte-Carlo estimate is re-drawn on every (scanned) update.
    wants_likelihood_key = True

    def __init__(self, simulator, error_tol=1e-2, min_samp=1,
                 samp_step=10, est_hedge=0.509, adapt_hedge=0.509,
                 max_samp=None, adaptive=True):
        super().__init__()
        if error_tol <= 0 or error_tol > 1:
            raise ValueError("error_tol must be in (0, 1]")
        self.adaptive = bool(adaptive)
        self.simulator = simulator
        self.error_tol = float(error_tol)
        self.min_samp = int(min_samp)
        self.samp_step = int(samp_step)
        self.est_hedge = float(est_hedge)
        self.adapt_hedge = float(adapt_hedge)
        # worst-case p = 1/2: err ≈ sqrt(0.25 / (N + 2h + 1)) ≤ tol
        needed = 0.25 / (self.error_tol ** 2) - 2 * self.adapt_hedge - 1
        needed = max(self.min_samp, int(math.ceil(
            max(needed, 1) / self.samp_step) * self.samp_step))
        self.n_samples = int(min(needed, max_samp) if max_samp else needed)
        if max_samp is not None and needed > max_samp:
            warnings.warn(
                f"ALE sample cap {max_samp} cannot reach error_tol="
                f"{self.error_tol}; worst-case std-err is "
                f"{0.5 / math.sqrt(max_samp):.3g}", ApproximationWarning)

    # -- delegation --------------------------------------------------------
    @property
    def n_modelparams(self):
        return self.simulator.n_modelparams

    @property
    def modelparam_names(self):
        return self.simulator.modelparam_names

    @property
    def expparams_dtype(self):
        return self.simulator.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.simulator.n_outcomes(expparams)

    def domain(self, expparams=None):
        return self.simulator.domain(expparams)

    def are_models_valid(self, modelparams):
        return self.simulator.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.simulator.canonicalize(modelparams)

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.simulator.simulate_experiment(
            key, modelparams, expparams, repeat=repeat)

    def update_timestep(self, key, modelparams, expparams):
        # keyed engine contract (abstract_model.py::Simulatable.
        # update_timestep): the key MUST be forwarded or wrapping any
        # time-dependent simulator crashes at the first update
        return self.simulator.update_timestep(key, modelparams, expparams)

    @property
    def is_time_dependent(self):
        # defining update_timestep above would otherwise make the base-class
        # override check report True unconditionally — delegate for real
        return self.simulator.is_time_dependent

    @property
    def Q(self):
        return self.simulator.Q

    # -- the approximation -------------------------------------------------

    def likelihood(self, outcomes, modelparams, expparams, key=None):
        """Monte-Carlo likelihood: simulate outcomes per (model,
        experiment) cell and return hedged frequency estimates for each
        requested outcome.

        With ``adaptive=True`` (the default) the sample count is genuinely
        adaptive, like the reference's host loop — but jit-compatible:
        fixed-size chunks of ``samp_step`` simulations accumulate under a
        ``lax.while_loop`` until the worst-cell hedged standard error drops
        below ``error_tol`` (or the ``n_samples`` static cap is hit). Every
        chunk has static shapes, so the whole estimate stays one compiled
        program; only the *trip count* is data-dependent.
        """
        self._bump("_call_count")
        if key is None:
            key = jax.random.key(self._fresh_seed())
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        outcomes = jnp.atleast_1d(outcomes)

        def chunk_counts(k, n_rep):
            sims = self.simulator.simulate_experiment(
                k, modelparams, eps, repeat=n_rep)
            if n_rep == 1:  # repeat==1 comes back squeezed
                sims = sims[None]
            return jnp.sum(
                sims[None, :, :, :] == outcomes[:, None, None, None],
                axis=1).astype(jnp.float32)  # (n_out, n_m, n_e)

        if not self.adaptive or self.samp_step >= self.n_samples:
            counts = chunk_counts(key, self.n_samples)
            return binom_est_p(counts, self.n_samples, self.est_hedge)

        step = self.samp_step
        max_iters = -(-self.n_samples // step)  # ceil
        min_iters = max(1, -(-self.min_samp // step))  # min_samp floor

        def cond(carry):
            i, counts, _ = carry
            n = i * step
            p = binom_est_p(counts, n, self.adapt_hedge)
            err = jnp.max(binom_est_error(p, n, self.adapt_hedge))
            return jnp.logical_and(i < max_iters,
                                   jnp.logical_or(i < min_iters,
                                                  err > self.error_tol))

        def body(carry):
            i, counts, k = carry
            k, sk = jax.random.split(k)
            return i + 1, counts + chunk_counts(sk, step), k

        n_out = outcomes.shape[0]
        n_m = modelparams.shape[0]
        n_e = n_expparams(eps)
        init = (jnp.asarray(0),
                jnp.zeros((n_out, n_m, n_e), jnp.float32), key)
        iters, counts, _ = jax.lax.while_loop(cond, body, init)
        return binom_est_p(counts, iters * step, self.est_hedge)

    def _fresh_seed(self):
        self._bump("_seed_counter")
        return getattr(self, "_seed_counter", 0)
