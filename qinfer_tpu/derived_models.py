"""Model decorators (models wrapping models).

Reference parity: ``src/qinfer/derived_models.py`` (SURVEY.md §2 #8) —
``DerivedModel``, ``PoisonedModel``, ``BinomialModel``, ``MultinomialModel``,
``MLEModel``, ``RandomWalkModel``, ``GaussianRandomWalkModel``.

Design: decorators stay pure pytree Modules, so a decorated model
passes through ``jit``/``scan`` exactly like a base model. The one
shape-hazard is :class:`BinomialModel` with per-experiment ``n_meas``: the
outcome grid must be static under jit, so the decorator carries a static
``n_meas_max`` and pads the outcome axis with a validity mask (SURVEY.md §7
"Static-shape variable outcomes"); padded slots get zero likelihood and the
engine's masked reductions ignore them.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .abstract_model import (
    Model,
    FiniteOutcomeModel,
    DifferentiableModel,
    n_expparams,
)
from .domains import IntegerDomain, MultinomialDomain
from .config import EPS
from .utils import log_binomial_pdf, sample_multinomial, multinomial_pdf

__all__ = [
    "DerivedModel",
    "PoisonedModel",
    "BinomialModel",
    "MultinomialModel",
    "MLEModel",
    "RandomWalkModel",
    "GaussianRandomWalkModel",
    "ReferencedPoissonModel",
]


class DerivedModel(Model):
    """Base for models that decorate an underlying model, delegating the
    full Simulatable/Model contract by default.

    Reference parity: ``derived_models.py::DerivedModel`` (``underlying_model``,
    ``base_model``, ``model_chain``).
    """

    def __init__(self, underlying_model):
        super().__init__()
        self.underlying_model = underlying_model

    @property
    def base_model(self):
        """The innermost non-derived model."""
        m = self.underlying_model
        while isinstance(m, DerivedModel):
            m = m.underlying_model
        return m

    @property
    def model_chain(self):
        """Tuple of models from this decorator down to the base model."""
        chain = [self]
        m = self.underlying_model
        while isinstance(m, DerivedModel):
            chain.append(m)
            m = m.underlying_model
        chain.append(m)
        return tuple(chain)

    # -- delegation --------------------------------------------------------
    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams

    @property
    def modelparam_names(self):
        return self.underlying_model.modelparam_names

    @property
    def expparams_dtype(self):
        return self.underlying_model.expparams_dtype

    @property
    def is_n_outcomes_constant(self):
        return self.underlying_model.is_n_outcomes_constant

    @property
    def Q(self):
        return self.underlying_model.Q

    def n_outcomes(self, expparams=None):
        return self.underlying_model.n_outcomes(expparams)

    def domain(self, expparams=None):
        return self.underlying_model.domain(expparams)

    def outcomes(self, expparams=None):
        return self.underlying_model.outcomes(expparams)

    def outcome_mask(self, expparams):
        return self.underlying_model.outcome_mask(expparams)

    def are_models_valid(self, modelparams):
        return self.underlying_model.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.underlying_model.canonicalize(modelparams)

    def experiment_cost(self, expparams):
        return self.underlying_model.experiment_cost(expparams)

    def update_timestep(self, key, modelparams, expparams):
        return self.underlying_model.update_timestep(
            key, modelparams, expparams)

    @property
    def is_time_dependent(self):
        # Delegating wrappers are time-dependent iff something below is.
        return self.underlying_model.is_time_dependent

    @property
    def outcome_ndim(self):
        return self.underlying_model.outcome_ndim

    def likelihood(self, outcomes, modelparams, expparams, **kwargs):
        return self.underlying_model.likelihood(
            outcomes, modelparams, expparams, **kwargs)

    def log_likelihood(self, outcomes, modelparams, expparams, **kwargs):
        """Pure delegation — only advertised (``has_log_likelihood``) when
        this wrapper does not transform the likelihood AND the underlying
        model provides a stable log form."""
        return self.underlying_model.log_likelihood(
            outcomes, modelparams, expparams, **kwargs)

    def _transforms_likelihood(self):
        """True when a subclass below ``DerivedModel`` overrides
        ``likelihood`` (Binomial/Multinomial/Poisoned/MLE…) — engine hooks
        of the underlying model must then NOT be blindly delegated."""
        for klass in type(self).__mro__:
            if klass is DerivedModel:
                return False
            if "likelihood" in vars(klass):
                return True
        return False

    @property
    def has_log_likelihood(self):
        """Engine hook: whether a stable ``log_likelihood`` is available
        (``smc.py`` then uses the max-shifted log-space weight update).
        Wrappers that define their own (BinomialModel,
        ReferencedPoissonModel) advertise it; pure delegators
        (RandomWalkModel…) inherit the underlying model's answer;
        likelihood-transforming wrappers without their own log form
        (PoisonedModel) do not."""
        for klass in type(self).__mro__:
            if klass is DerivedModel:
                break
            if "log_likelihood" in vars(klass):
                return True
            if "likelihood" in vars(klass):
                return False
        return bool(getattr(self.underlying_model,
                            "has_log_likelihood", False))

    @property
    def wants_likelihood_key(self):
        """Engine hook: per-step PRNG key threading for Monte-Carlo
        likelihoods (ALE). Delegated only when this wrapper's likelihood
        is a pure pass-through (a transforming wrapper's signature would
        not accept the key)."""
        if self._transforms_likelihood():
            return False
        return bool(getattr(self.underlying_model,
                            "wants_likelihood_key", False))

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.underlying_model.simulate_experiment(
            key, modelparams, expparams, repeat=repeat)


class PoisonedModel(DerivedModel):
    """Deliberately corrupt likelihoods with ALE-calibrated noise — the
    library's fault-injection tool for robustness studies.

    Reference parity: ``derived_models.py::PoisonedModel(model, tol /
    n_samples+hedge)`` — in ALE mode the perturbation std matches the
    hedged-beta standard error an :class:`~qinfer_tpu.ale.ALEApproximateModel`
    would incur; in tol mode it is a constant ``tol``.

    The engine threads a fresh PRNG key per update
    (``wants_likelihood_key``), so poison noise is re-drawn every step even
    under ``jit``/``scan``; direct ``likelihood()`` calls without a key fall
    back to an instance-held key (never stored when traced, so closures
    cannot leak tracers).
    """

    #: engine threads a per-step key so the corruption is fresh under scan
    wants_likelihood_key = True

    def __init__(self, underlying_model, tol=None, n_samples=None,
                 hedge=None, seed=0):
        super().__init__(underlying_model)
        if tol is None and n_samples is None:
            raise ValueError("specify tol (constant mode) or n_samples (ALE mode)")
        self.tol = float(tol) if tol is not None else None
        self.n_samples = int(n_samples) if n_samples is not None else None
        self.hedge = float(hedge) if hedge is not None else 0.0
        self._noise_key = jax.random.key(seed)

    def _next_key(self):
        key = getattr(self, "_noise_key", None)
        if key is None:
            key = jax.random.key(0)
        key, sub = jax.random.split(key)
        if not isinstance(key, jax.core.Tracer):
            # never store traced keys on the instance (closure-traced calls
            # would otherwise leak tracers into later eager calls)
            object.__setattr__(self, "_noise_key", key)
        return sub

    def likelihood(self, outcomes, modelparams, expparams, key=None):
        if key is None:
            key = self._next_key()
        L = self.underlying_model.likelihood(outcomes, modelparams, expparams)
        if self.tol is not None:
            sigma = self.tol
        else:
            # ALE-calibrated: hedged binomial standard error at probability L
            n, h = self.n_samples, self.hedge
            p_hat = (L * n + h) / (n + 2 * h)
            sigma = jnp.sqrt(p_hat * (1 - p_hat) / (n + 2 * h + 1))
        noise = jax.random.normal(key, L.shape) * sigma
        return jnp.clip(L + noise, 0.0, 1.0)


class BinomialModel(DerivedModel):
    """Lift a two-outcome model to batched repetitions: expparams gain an
    ``n_meas`` field and outcomes become success counts.

    Reference parity: ``derived_models.py::BinomialModel(two_outcome_model)``
    — likelihood is ``binomial_pdf(n_meas, outcome, pr0)``; simulation draws
    binomials.

    :param int n_meas_max: static upper bound on ``n_meas`` (jit needs a
        fixed outcome-grid shape for experiment design; updates themselves
        accept any count). Defaults to 128.
    """

    def __init__(self, underlying_model, n_meas_max=128):
        if underlying_model.n_outcomes(None) != 2:
            raise ValueError("BinomialModel requires a two-outcome model")
        super().__init__(underlying_model)
        self.n_meas_max = int(n_meas_max)

    @property
    def decorated_model(self):
        return self.underlying_model

    outcome_ndim = 0

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("n_meas", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        return self.n_meas_max + 1

    def domain(self, expparams=None):
        if expparams is None:
            return IntegerDomain(0, self.n_meas_max)
        eps = self.canonicalize_expparams(expparams)
        n_meas = np.asarray(eps["n_meas"])
        return [IntegerDomain(0, int(m)) for m in n_meas]

    def outcomes(self, expparams=None):
        return jnp.arange(self.n_meas_max + 1, dtype=jnp.int32)

    def outcome_mask(self, expparams):
        eps = self.canonicalize_expparams(expparams)
        n_meas = jnp.asarray(eps["n_meas"])
        grid = jnp.arange(self.n_meas_max + 1)
        return grid[:, None] <= n_meas[None, :]

    def _pr0(self, modelparams, eps):
        two_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        L0 = self.underlying_model.likelihood(
            jnp.array([0]), modelparams, two_eps)
        return L0[0]  # (n_models, n_eps)

    def likelihood(self, outcomes, modelparams, expparams):
        return jnp.exp(self.log_likelihood(outcomes, modelparams, expparams))

    def log_likelihood(self, outcomes, modelparams, expparams):
        """Analytically stable log-binomial — lets the engine's max-shifted
        weight update survive high-count outcomes whose linear pmf
        underflows float32 (e.g. n_meas=10⁴ repetitions)."""
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        pr0 = self._pr0(modelparams, eps)  # (n_m, n_e)
        n_meas = jnp.asarray(eps["n_meas"]).astype(pr0.dtype)
        outcomes = jnp.atleast_1d(outcomes).astype(pr0.dtype)
        # log-binomial over (n_out, n_m, n_e); success := outcome 0 count
        logp = log_binomial_pdf(
            n_meas[None, None, :], outcomes[:, None, None], pr0[None, :, :])
        valid = outcomes[:, None, None] <= n_meas[None, None, :]
        return jnp.where(valid, logp, -jnp.inf)

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        self._bump("_sim_count", int(repeat))
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        pr0 = self._pr0(modelparams, eps)  # (n_m, n_e)
        n_meas = jnp.asarray(eps["n_meas"])
        # Fixed-shape binomial draw: n_meas_max uniforms, masked by n_meas.
        u = jax.random.uniform(
            key, (repeat,) + pr0.shape + (self.n_meas_max,))
        trial_idx = jnp.arange(self.n_meas_max)
        active = trial_idx[None, None, None, :] < n_meas[None, None, :, None]
        successes = jnp.sum((u < pr0[None, :, :, None]) & active, axis=-1)
        out = successes.astype(jnp.int32)
        if repeat == 1:
            out = out[0]
        return out

    def update_timestep(self, key, modelparams, expparams):
        eps = self.canonicalize_expparams(expparams)
        two_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        return self.underlying_model.update_timestep(
            key, modelparams, two_eps)


class MultinomialModel(DerivedModel):
    """Lift a k-outcome model to batched repetitions with count-vector
    outcomes over a :class:`~qinfer_tpu.domains.MultinomialDomain`.

    Reference parity: ``derived_models.py::MultinomialModel``.
    """

    outcome_ndim = 1

    def __init__(self, underlying_model, n_meas_max=32):
        super().__init__(underlying_model)
        self.n_elements = int(underlying_model.n_outcomes(None))
        self.n_meas_max = int(n_meas_max)

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("n_meas", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        """Size of the STATIC padded outcome grid (all count vectors with
        sum ≤ ``n_meas_max``): C(n_meas_max + k, k). Trace-safe — never
        inspects expparams values (the per-experiment outcome count is
        conveyed by :meth:`outcome_mask`, as for BinomialModel)."""
        from math import comb

        return comb(self.n_meas_max + self.n_elements, self.n_elements)

    def outcomes(self, expparams=None):
        """Padded static design grid: every count vector of ``n_elements``
        non-negative integers with total ≤ ``n_meas_max``, shape
        ``(C(n_meas_max + k, k), k)``. For each experiment, exactly the
        rows summing to its ``n_meas`` are real (see :meth:`outcome_mask`)
        — the C(n+k−1, k−1) vectors of ``MultinomialDomain(n, k).values``
        (reference anchor: ``src/qinfer/domains.py::MultinomialDomain``).
        """
        grid = getattr(self, "_outcome_grid_cache", None)
        if grid is None:
            n_out = self.n_outcomes()
            if n_out > 200_000:
                raise ValueError(
                    f"MultinomialModel's static outcome grid would hold "
                    f"{n_out} count vectors (n_meas_max="
                    f"{self.n_meas_max}, {self.n_elements} outcomes) — "
                    f"design-time marginalization (bayes_risk / "
                    f"expected_information_gain) is intractable at this "
                    f"size; reduce n_meas_max. Simulation and likelihood "
                    f"updates do not need this grid and keep working.")
            from .domains import _compositions

            # compositions of n_meas_max into k+1 parts, dropping the slack
            # column, enumerate every sum-≤-n_meas_max vector exactly once
            grid = jnp.asarray(np.array(
                [c[:-1] for c in _compositions(
                    self.n_meas_max, self.n_elements + 1)],
                dtype=np.int32))
            object.__setattr__(self, "_outcome_grid_cache", grid)
        return grid

    def outcome_mask(self, expparams):
        """(n_outcomes, n_expparams) validity of each padded grid row:
        a count vector is a real outcome of experiment ``e`` iff its total
        equals that experiment's ``n_meas``."""
        eps = self.canonicalize_expparams(expparams)
        n_meas = jnp.asarray(eps["n_meas"])
        totals = jnp.sum(self.outcomes(), axis=-1)
        return totals[:, None] == n_meas[None, :]

    def domain(self, expparams=None):
        if expparams is None:
            return MultinomialDomain(self.n_meas_max, self.n_elements)
        eps = self.canonicalize_expparams(expparams)
        return [MultinomialDomain(int(m), self.n_elements)
                for m in np.asarray(eps["n_meas"])]

    def _category_probs(self, modelparams, eps):
        sub_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        outcomes = jnp.arange(self.n_elements)
        L = self.underlying_model.likelihood(outcomes, modelparams, sub_eps)
        return jnp.moveaxis(L, 0, -1)  # (n_m, n_e, k)

    def likelihood(self, outcomes, modelparams, expparams):
        """``outcomes``: (n_out, k) count vectors."""
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        probs = self._category_probs(modelparams, eps)  # (n_m, n_e, k)
        outcomes = jnp.atleast_2d(outcomes)  # (n_out, k)
        return multinomial_pdf(
            outcomes[:, None, None, :], probs[None, :, :, :])

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        """Fixed-shape multinomial draws honoring PER-EXPERIMENT ``n_meas``:
        ``n_meas_max`` categorical trials per cell, masked by each
        experiment's count (jit/vmap-safe; no host conversion)."""
        self._bump("_sim_count", int(repeat))
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        probs = self._category_probs(modelparams, eps)  # (n_m, n_e, k)
        n_meas = jnp.asarray(eps["n_meas"])  # (n_e,)
        n_m, n_e, k = probs.shape

        u = jax.random.uniform(
            key, (repeat, n_m, n_e, self.n_meas_max))
        cdf = jnp.cumsum(probs, axis=-1)  # (n_m, n_e, k)
        cdf = cdf / jnp.clip(cdf[..., -1:], EPS, None)
        active = (jnp.arange(self.n_meas_max)[None, None, None, :]
                  < n_meas[None, None, :, None])
        counts = []
        lower = jnp.zeros_like(cdf[..., 0])
        for c in range(k):
            upper = cdf[..., c]
            hit = ((u >= lower[None, :, :, None])
                   & (u < upper[None, :, :, None]) & active)
            counts.append(jnp.sum(hit, axis=-1))
            lower = upper
        out = jnp.stack(counts, axis=-1).astype(jnp.int32)
        # numerical guard: assign any unbinned trials (u == 1 edge) to the
        # last category so totals always equal n_meas
        deficit = n_meas[None, None, :] - jnp.sum(out, axis=-1)
        out = out.at[..., -1].add(deficit.astype(jnp.int32))
        if repeat == 1:
            out = out[0]
        return out


class MLEModel(DerivedModel):
    """Anneal likelihoods to a power so the SMC approximates maximum
    likelihood estimation.

    Reference parity: ``derived_models.py::MLEModel(model, likelihood_power)``.
    """

    def __init__(self, underlying_model, likelihood_power=1.0):
        super().__init__(underlying_model)
        self.likelihood_power = float(likelihood_power)

    def likelihood(self, outcomes, modelparams, expparams):
        L = self.underlying_model.likelihood(outcomes, modelparams, expparams)
        return jnp.clip(L, EPS, None) ** self.likelihood_power

    def log_likelihood(self, outcomes, modelparams, expparams):
        """Annealed log form: ``power * log L`` — annealing AMPLIFIES
        underflow (L^4 at 4x the exponent range), so the stable path
        matters more here than for the plain model."""
        logL = self.underlying_model.log_likelihood(
            outcomes, modelparams, expparams)
        return self.likelihood_power * jnp.maximum(
            logL, jnp.log(jnp.asarray(EPS)))

    @property
    def has_log_likelihood(self):
        # the annealed log form is only as stable as the underlying one
        return bool(getattr(self.underlying_model,
                            "has_log_likelihood", False))


class RandomWalkModel(DerivedModel):
    """Add a random step (drawn from ``step_distribution``) to the model
    parameters after each experiment — online tracking of drifting
    parameters.

    Reference parity: ``derived_models.py::RandomWalkModel(model,
    step_distribution)`` (implements ``update_timestep``).
    """

    def __init__(self, underlying_model, step_distribution):
        super().__init__(underlying_model)
        self.step_distribution = step_distribution

    @property
    def is_time_dependent(self):
        return True

    def update_timestep(self, key, modelparams, expparams):
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        n_e = n_expparams(eps)
        n_m = modelparams.shape[0]
        steps = self.step_distribution.sample(key, n_m * n_e)
        steps = steps.reshape(n_m, n_e, -1)
        return modelparams[:, :, None] + jnp.moveaxis(steps, 1, 2)


class GaussianRandomWalkModel(RandomWalkModel):
    """Gaussian random walk with fixed or **learned** (co)variance.

    Reference parity: ``derived_models.py::GaussianRandomWalkModel`` — with
    ``model_mu_sigma=True`` the walk scales become extra model parameters
    (appended after the underlying ones), so the SMC *learns the diffusion
    rate* along with the state; with the default they are fixed constants.
    ``diagonal=False`` uses a full covariance walk: in fixed mode ``scale``
    may be a ``(d, d)`` covariance matrix; in learned mode the extra
    parameters are the ``d(d+1)/2`` entries of the Cholesky factor of the
    step covariance (diagonal entries as log-σ for positivity, off-diagonal
    entries unconstrained).
    """

    def __init__(self, underlying_model, scale=0.01, diagonal=True,
                 model_mu_sigma=False):
        from .distributions import MultivariateNormalDistribution

        d = underlying_model.n_modelparams
        scale_np = np.asarray(scale, dtype=np.float64)
        if not diagonal and scale_np.ndim == 2:
            if scale_np.shape != (d, d):
                raise ValueError(
                    f"full-covariance scale must be ({d}, {d})")
            cov = scale_np
        else:
            if scale_np.ndim == 2:
                raise ValueError(
                    "matrix scale requires diagonal=False")
            scale_arr = np.broadcast_to(scale_np, (d,))
            cov = np.diag(scale_arr ** 2)
        step = MultivariateNormalDistribution(np.zeros(d), cov)
        super().__init__(underlying_model, step)
        self.diagonal = bool(diagonal)
        self.model_mu_sigma = bool(model_mu_sigma)

    # -- learned-sigma plumbing -------------------------------------------

    @property
    def _n_underlying(self):
        # derived (not stored): survives pytree unflattening inside jit
        return self.underlying_model.n_modelparams

    @property
    def _n_extra(self):
        """Number of learned walk parameters appended after the underlying
        ones: d log-σ (diagonal) or d(d+1)/2 Cholesky entries (full)."""
        if not self.model_mu_sigma:
            return 0
        d = self._n_underlying
        return d if self.diagonal else d * (d + 1) // 2

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + self._n_extra

    @property
    def modelparam_names(self):
        names = list(self.underlying_model.modelparam_names)
        if self.model_mu_sigma:
            under = self.underlying_model.modelparam_names
            if self.diagonal:
                names += [f"log_sigma_{n}" for n in under]
            else:
                d = self._n_underlying
                for i, j in zip(*np.tril_indices(d)):
                    names.append(
                        f"log_sigma_{under[i]}" if i == j
                        else f"chol_{under[i]}_{under[j]}")
        return names

    @property
    def Q(self):
        if not self.model_mu_sigma:
            return self.underlying_model.Q
        return jnp.concatenate([
            self.underlying_model.Q,
            jnp.zeros((self._n_extra,))])

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        base = self.underlying_model.are_models_valid(
            modelparams[:, :self._n_underlying])
        return base  # log-sigma coordinates are unconstrained

    def canonicalize(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        if not self.model_mu_sigma:
            return self.underlying_model.canonicalize(modelparams)
        head = self.underlying_model.canonicalize(
            modelparams[:, :self._n_underlying])
        return jnp.concatenate([head, modelparams[:, self._n_underlying:]],
                               axis=1)

    def likelihood(self, outcomes, modelparams, expparams):
        modelparams = jnp.atleast_2d(modelparams)
        return self.underlying_model.likelihood(
            outcomes, modelparams[:, :self._n_underlying], expparams)

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        modelparams = jnp.atleast_2d(modelparams)
        return self.underlying_model.simulate_experiment(
            key, modelparams[:, :self._n_underlying], expparams,
            repeat=repeat)

    def update_timestep(self, key, modelparams, expparams):
        modelparams = jnp.atleast_2d(modelparams)
        if not self.model_mu_sigma:
            return super().update_timestep(key, modelparams, expparams)
        eps = self.canonicalize_expparams(expparams)
        n_e = n_expparams(eps)
        n_m = modelparams.shape[0]
        d = self._n_underlying
        z = jax.random.normal(key, (n_m, d, n_e))
        if self.diagonal:
            sigma = jnp.exp(modelparams[:, d:])  # (n_m, d) per-particle
            step = z * sigma[:, :, None]
        else:
            # per-particle Cholesky factor from the learned tail:
            # diagonal entries live in log space, off-diagonals are raw
            tril_i, tril_j = np.tril_indices(d)
            theta = modelparams[:, d:]  # (n_m, d(d+1)/2)
            entries = jnp.where(
                jnp.asarray(tril_i == tril_j)[None, :],
                jnp.exp(theta), theta)
            L = jnp.zeros((n_m, d, d), modelparams.dtype).at[
                :, tril_i, tril_j].set(entries)
            step = jnp.einsum("mij,mjE->miE", L, z)
        head = modelparams[:, :d, None] + step
        tail = jnp.broadcast_to(
            modelparams[:, d:, None], (n_m, self._n_extra, n_e))
        return jnp.concatenate([head, tail], axis=1)


class ReferencedPoissonModel(DerivedModel):
    """Poisson-count readout referenced to bright/dark calibration rates.

    Wraps a two-outcome model: the observed datum is a Poisson count with
    rate interpolating between a bright reference ``alpha`` and a dark
    reference ``beta`` (both appended as model parameters):
    ``rate = p·alpha + (1−p)·beta`` with ``p = Pr(0)`` of the underlying
    model. Experiments carry a ``mode`` field — SIGNAL (0) probes the
    underlying model, BRIGHT (1) / DARK (2) calibrate the references.

    Reference parity: ``src/qinfer/derived_models.py::ReferencedPoissonModel``
    [SURVEY.md marks this LOW-confidence/era-dependent; semantics here
    follow the published ion-trap readout formulation the upstream class
    implements].
    """

    SIGNAL, BRIGHT, DARK = 0, 1, 2
    outcome_ndim = 0

    def __init__(self, underlying_model, max_count=512):
        if underlying_model.n_outcomes(None) != 2:
            raise ValueError(
                "ReferencedPoissonModel requires a two-outcome model")
        super().__init__(underlying_model)
        self.max_count = int(max_count)

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + 2

    @property
    def modelparam_names(self):
        return list(self.underlying_model.modelparam_names) + [
            "alpha", "beta"]

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("mode", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return True

    def n_outcomes(self, expparams=None):
        return self.max_count + 1

    def domain(self, expparams=None):
        return IntegerDomain(0, self.max_count)

    def outcomes(self, expparams=None):
        return jnp.arange(self.max_count + 1, dtype=jnp.int32)

    def outcome_mask(self, expparams):
        eps = self.canonicalize_expparams(expparams)
        n_e = n_expparams(eps)
        return jnp.ones((self.max_count + 1, n_e), dtype=bool)

    @property
    def Q(self):
        return jnp.concatenate([
            self.underlying_model.Q, jnp.zeros((2,))])

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        base = self.underlying_model.are_models_valid(modelparams[:, :-2])
        alpha = modelparams[:, -2]
        beta = modelparams[:, -1]
        return base & (alpha >= beta) & (beta >= 0)

    def _rates(self, modelparams, eps):
        sub_eps = {k: v for k, v in eps.items() if k != "mode"}
        mode = jnp.asarray(eps["mode"])  # (n_e,)
        p = self.underlying_model.likelihood(
            jnp.array([0]), modelparams[:, :-2], sub_eps)[0]  # (n_m, n_e)
        alpha = modelparams[:, -2:-1]
        beta = modelparams[:, -1:]
        signal_rate = p * alpha + (1.0 - p) * beta
        rate = jnp.where(
            mode[None, :] == self.SIGNAL, signal_rate,
            jnp.where(mode[None, :] == self.BRIGHT,
                      jnp.broadcast_to(alpha, signal_rate.shape),
                      jnp.broadcast_to(beta, signal_rate.shape)))
        return jnp.clip(rate, EPS, None)

    def likelihood(self, outcomes, modelparams, expparams):
        return jnp.exp(self.log_likelihood(outcomes, modelparams, expparams))

    def log_likelihood(self, outcomes, modelparams, expparams):
        """Stable log-Poisson pmf (high counts underflow the linear pmf in
        float32; the engine's max-shifted update uses this directly)."""
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        rate = self._rates(modelparams, eps)  # (n_m, n_e)
        counts = jnp.atleast_1d(outcomes).astype(rate.dtype)
        return (counts[:, None, None] * jnp.log(rate)[None]
                - rate[None]
                - gammaln(counts + 1.0)[:, None, None])

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        self._bump("_sim_count", int(repeat))
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        rate = self._rates(modelparams, eps)
        draws = jax.random.poisson(
            key, rate, (repeat,) + rate.shape).astype(jnp.int32)
        draws = jnp.clip(draws, 0, self.max_count)
        if repeat == 1:
            draws = draws[0]
        return draws

    def update_timestep(self, key, modelparams, expparams):
        eps = self.canonicalize_expparams(expparams)
        sub_eps = {k: v for k, v in eps.items() if k != "mode"}
        modelparams = jnp.atleast_2d(modelparams)
        head = self.underlying_model.update_timestep(
            key, modelparams[:, :-2], sub_eps)  # (n_m, d, n_e)
        n_e = head.shape[2]
        tail = jnp.broadcast_to(
            modelparams[:, -2:, None],
            (modelparams.shape[0], 2, n_e))
        return jnp.concatenate([head, tail], axis=1)
