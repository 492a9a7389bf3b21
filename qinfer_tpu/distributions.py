"""Prior / sampling distributions.

Reference parity: ``src/qinfer/distributions.py`` (SURVEY.md §2 #6) —
``Distribution`` ABC plus the uniform / normal / beta / gamma family, the
combinators (``ProductDistribution``, ``MixtureDistribution``,
``PostselectedDistribution``, ``ConstrainedSumDistribution``), the
inverse-CDF ``InterpolatedUnivariateDistribution``, the quantum Haar /
Ginibre / Hilbert-Schmidt priors, and ``ParticleDistribution`` (a weighted
particle cloud usable as a prior).

Design: sampling is **explicitly keyed** (``sample(key, n)``)
instead of mutating global NumPy RNG state, so priors compose with ``jit`` /
``vmap`` / ``lax.scan`` and shard across a device mesh; rejection sampling
(``PostselectedDistribution``) uses a fixed-round masked redraw so its shape
is static under jit.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ._pytree import Module
from .config import EPS

__all__ = [
    "Distribution",
    "SingleSampleMixin",
    "UniformDistribution",
    "DiscreteUniformDistribution",
    "MVUniformDistribution",
    "ConstantDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "SlantedNormalDistribution",
    "LogNormalDistribution",
    "BetaDistribution",
    "BetaBinomialDistribution",
    "GammaDistribution",
    "InterpolatedUnivariateDistribution",
    "ProductDistribution",
    "MixtureDistribution",
    "PostselectedDistribution",
    "ConstrainedSumDistribution",
    "ParticleDistribution",
    "HaarUniform",
    "GinibreUniform",
    "HilbertSchmidtUniform",
]


class Distribution(Module):
    """Abstract base: a distribution over ``n_rvs`` real random variables.

    Reference parity: ``src/qinfer/distributions.py::Distribution``
    (``n_rvs`` property + ``sample(n)``). The rebuild's ``sample`` takes an
    explicit PRNG key: ``sample(key, n) -> (n, n_rvs)``.
    """

    @property
    def n_rvs(self):
        raise NotImplementedError

    def sample(self, key, n=1):
        """Draw ``n`` samples, returned as a ``(n, n_rvs)`` array."""
        raise NotImplementedError

    # Optional protocol (consumed by SMC rejuvenation and BCRB tracking;
    # see qinfer_tpu.rejuvenation.resolve_prior_log_pdf):
    #   log_pdf(x: (n, n_rvs)) -> (n,)   log density (constants optional)
    #   grad_log_pdf(x)        -> (n, n_rvs)
    #   is_flat_on_support     -> bool   density constant on its support


class SingleSampleMixin:
    """Mixin implementing batched ``sample`` in terms of ``_sample_one(key)``.

    Reference parity: ``distributions.py::SingleSampleMixin`` — there it
    loops in Python; here the single-sample routine is ``vmap``-ped over a
    batch of keys, so it stays on-device.
    """

    def _sample_one(self, key):
        raise NotImplementedError

    def sample(self, key, n=1):
        keys = jax.random.split(key, n)
        return jax.vmap(self._sample_one)(keys)


# ---------------------------------------------------------------------------
# Uniform family
# ---------------------------------------------------------------------------

class UniformDistribution(Distribution):
    """Uniform over an axis-aligned box given as ``[[lo, hi], ...]``.

    Reference parity: ``distributions.py::UniformDistribution(ranges)``
    (also accepts a single ``[lo, hi]`` pair for one variable).
    """

    def __init__(self, ranges):
        ranges = jnp.atleast_2d(jnp.asarray(ranges, dtype=jnp.float32))
        if ranges.ndim != 2 or ranges.shape[-1] != 2:
            raise ValueError("ranges must be of shape (n_rvs, 2)")
        self.ranges = ranges

    @property
    def n_rvs(self):
        return self.ranges.shape[0]

    def sample(self, key, n=1):
        lo = self.ranges[:, 0]
        hi = self.ranges[:, 1]
        u = jax.random.uniform(key, (n, self.n_rvs))
        return lo + u * (hi - lo)

    def grad_log_pdf(self, x):
        """∇ log p = 0 inside the box (used by BCRB trackers)."""
        return jnp.zeros_like(jnp.asarray(x))

    is_flat_on_support = True

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))
        lo = self.ranges[:, 0]
        hi = self.ranges[:, 1]
        inside = jnp.all((x >= lo) & (x <= hi), axis=-1)
        log_vol = jnp.sum(jnp.log(hi - lo))
        return jnp.where(inside, -log_vol, -jnp.inf)


class DiscreteUniformDistribution(Distribution):
    """Uniform over integers ``0 .. 2**num_bits - 1``.

    Reference parity: ``distributions.py::DiscreteUniformDistribution``.
    """

    def __init__(self, num_bits):
        self.num_bits = int(num_bits)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        hi = 2 ** self.num_bits
        return jax.random.randint(key, (n, 1), 0, hi).astype(jnp.float32)


class MVUniformDistribution(Distribution):
    """Uniform over the probability simplex in ``dim`` dimensions (vectors of
    non-negative reals summing to 1).

    Reference parity: ``distributions.py::MVUniformDistribution(dim)``.
    """

    def __init__(self, dim=6):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim

    def sample(self, key, n=1):
        return jax.random.dirichlet(key, jnp.ones(self.dim), (n,))


class ConstantDistribution(Distribution):
    """A degenerate distribution returning a fixed vector.

    Reference parity: ``distributions.py::ConstantDistribution(values)``.
    """

    def __init__(self, values):
        self.values = jnp.atleast_1d(jnp.asarray(values, dtype=jnp.float32))

    @property
    def n_rvs(self):
        return self.values.shape[0]

    def sample(self, key, n=1):
        return jnp.broadcast_to(self.values, (n, self.n_rvs))


# ---------------------------------------------------------------------------
# Normal family
# ---------------------------------------------------------------------------

class NormalDistribution(Distribution):
    """Scalar normal with given mean and **variance**.

    Reference parity: ``distributions.py::NormalDistribution(mean, var)``.
    """

    def __init__(self, mean, var, trunc=None):
        self.mean = jnp.asarray(mean, dtype=jnp.float32)
        self.var = jnp.asarray(var, dtype=jnp.float32)
        self.trunc = trunc  # optional (lo, hi) truncation

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        std = jnp.sqrt(self.var)
        if self.trunc is not None:
            lo, hi = self.trunc
            a = (lo - self.mean) / std
            b = (hi - self.mean) / std
            z = jax.random.truncated_normal(key, a, b, (n, 1))
        else:
            z = jax.random.normal(key, (n, 1))
        return self.mean + std * z

    def grad_log_pdf(self, x):
        return -(jnp.asarray(x) - self.mean) / self.var

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))[:, 0]
        lp = (-0.5 * (x - self.mean) ** 2 / self.var
              - 0.5 * jnp.log(2 * jnp.pi * self.var))
        if self.trunc is not None:
            lo, hi = self.trunc
            lp = jnp.where((x >= lo) & (x <= hi), lp, -jnp.inf)
        return lp


class MultivariateNormalDistribution(Distribution):
    """Multivariate normal with mean vector and covariance matrix.

    Reference parity: ``distributions.py::MultivariateNormalDistribution``.
    """

    def __init__(self, mean, cov):
        self.mean = jnp.atleast_1d(jnp.asarray(mean, dtype=jnp.float32))
        self.cov = jnp.atleast_2d(jnp.asarray(cov, dtype=jnp.float32))

    @property
    def n_rvs(self):
        return self.mean.shape[0]

    def sample(self, key, n=1):
        return jax.random.multivariate_normal(
            key, self.mean, self.cov, (n,), method="eigh"
        )

    def grad_log_pdf(self, x):
        d = jnp.asarray(x) - self.mean
        return -jnp.linalg.solve(self.cov, d[..., :, None])[..., 0]

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))
        d = x - self.mean
        chol = jnp.linalg.cholesky(self.cov)
        z = jax.scipy.linalg.solve_triangular(chol, d.T, lower=True)
        log_det = jnp.sum(jnp.log(jnp.diagonal(chol)))
        k = self.n_rvs
        return (-0.5 * jnp.sum(z * z, axis=0) - log_det
                - 0.5 * k * jnp.log(2 * jnp.pi))


class SlantedNormalDistribution(Distribution):
    """Sum of a uniform over ``ranges`` and an independent zero-mean normal
    with standard deviation ``weight`` — a "slanted" box prior.

    Reference parity: ``distributions.py::SlantedNormalDistribution``.
    """

    def __init__(self, ranges=((0.0, 1.0),), weight=0.01):
        ranges = jnp.atleast_2d(jnp.asarray(ranges, dtype=jnp.float32))
        self.ranges = ranges
        self.weight = float(weight)

    @property
    def n_rvs(self):
        return self.ranges.shape[0]

    def sample(self, key, n=1):
        k1, k2 = jax.random.split(key)
        lo = self.ranges[:, 0]
        hi = self.ranges[:, 1]
        u = lo + jax.random.uniform(k1, (n, self.n_rvs)) * (hi - lo)
        z = jax.random.normal(k2, (n, self.n_rvs)) * self.weight
        return u + z


class LogNormalDistribution(Distribution):
    """Log-normal: ``exp(N(mu, sigma^2))``.

    Reference parity: ``distributions.py::LogNormalDistribution(mu, sigma)``.
    """

    def __init__(self, mu=0.0, sigma=1.0):
        self.mu = float(mu)
        self.sigma = float(sigma)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        z = jax.random.normal(key, (n, 1))
        return jnp.exp(self.mu + self.sigma * z)

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))[:, 0]
        safe = jnp.clip(x, EPS, None)
        lp = (-0.5 * ((jnp.log(safe) - self.mu) / self.sigma) ** 2
              - jnp.log(safe * self.sigma) - 0.5 * jnp.log(2 * jnp.pi))
        return jnp.where(x > 0, lp, -jnp.inf)


# ---------------------------------------------------------------------------
# Beta / Gamma family
# ---------------------------------------------------------------------------

def _beta_params(alpha, beta, mean, var):
    if alpha is not None and beta is not None:
        return float(alpha), float(beta)
    if mean is not None and var is not None:
        mean = float(mean)
        var = float(var)
        nu = mean * (1 - mean) / var - 1.0
        return mean * nu, (1 - mean) * nu
    raise ValueError("specify either (alpha, beta) or (mean, var)")


class BetaDistribution(Distribution):
    """Beta distribution, parameterized by (alpha, beta) or (mean, var).

    Reference parity: ``distributions.py::BetaDistribution``.
    """

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        self.alpha, self.beta = _beta_params(alpha, beta, mean, var)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        return jax.random.beta(key, self.alpha, self.beta, (n, 1))

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))[:, 0]
        return jax.scipy.stats.beta.logpdf(x, self.alpha, self.beta)


class BetaBinomialDistribution(Distribution):
    """Beta-binomial over counts out of ``n`` trials; parameterized like
    :class:`BetaDistribution`.

    Reference parity: ``distributions.py::BetaBinomialDistribution``.
    """

    def __init__(self, n, alpha=None, beta=None, mean=None, var=None):
        self.n = int(n)
        self.alpha, self.beta = _beta_params(alpha, beta, mean, var)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        kp, kb = jax.random.split(key)
        p = jax.random.beta(kp, self.alpha, self.beta, (n, 1))
        u = jax.random.uniform(kb, (n, 1, self.n))
        return jnp.sum(u < p[..., None], axis=-1).astype(jnp.float32)


class GammaDistribution(Distribution):
    """Gamma distribution, parameterized by (alpha, beta=rate) or (mean, var).

    Reference parity: ``distributions.py::GammaDistribution``.
    """

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        if alpha is not None and beta is not None:
            self.alpha, self.beta = float(alpha), float(beta)
        elif mean is not None and var is not None:
            self.alpha = float(mean) ** 2 / float(var)
            self.beta = float(mean) / float(var)
        else:
            raise ValueError("specify either (alpha, beta) or (mean, var)")

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        return jax.random.gamma(key, self.alpha, (n, 1)) / self.beta

    def log_pdf(self, x):
        x = jnp.atleast_2d(jnp.asarray(x))[:, 0]
        return jax.scipy.stats.gamma.logpdf(x, self.alpha,
                                            scale=1.0 / self.beta)


class InterpolatedUnivariateDistribution(Distribution):
    """Distribution defined by an arbitrary unnormalized pdf callable,
    sampled by inverse-CDF lookup on a dense grid.

    Reference parity:
    ``distributions.py::InterpolatedUnivariateDistribution(pdf, compactification_scale, n_interp_points)``
    — the reference builds a spline of the inverse CDF; here the CDF grid is
    precomputed once (host-side) and sampling is a jittable ``interp``.
    """

    def __init__(self, pdf, compactification_scale=1.0, n_interp_points=1500):
        self.compactification_scale = float(compactification_scale)
        self.n_interp_points = int(n_interp_points)
        # Build grid over the compactified real line: x = scale * arctanh(u)
        u = np.linspace(-1.0, 1.0, n_interp_points + 2)[1:-1]
        xs = self.compactification_scale * np.arctanh(u)
        ps = np.asarray(pdf(xs), dtype=np.float64)
        ps = np.clip(ps, 0.0, None)
        cdf = np.cumsum((ps[1:] + ps[:-1]) * np.diff(xs) / 2.0)
        cdf = np.concatenate([[0.0], cdf])
        cdf /= cdf[-1]
        self.xs = jnp.asarray(xs, dtype=jnp.float32)
        self.cdf = jnp.asarray(cdf, dtype=jnp.float32)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n=1):
        u = jax.random.uniform(key, (n,))
        return jnp.interp(u, self.cdf, self.xs)[:, None]


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

class ProductDistribution(Distribution):
    """Concatenation of independent factor distributions.

    Reference parity: ``distributions.py::ProductDistribution(*factors)``.
    """

    def __init__(self, *factors):
        # accept both ProductDistribution(a, b) and ProductDistribution([a, b])
        if len(factors) == 1 and isinstance(factors[0], (list, tuple)):
            factors = tuple(factors[0])
        self.factors = list(factors)

    @property
    def n_rvs(self):
        return sum(f.n_rvs for f in self.factors)

    def sample(self, key, n=1):
        keys = jax.random.split(key, len(self.factors))
        parts = [f.sample(k, n) for f, k in zip(self.factors, keys)]
        return jnp.concatenate(parts, axis=1)

    def log_pdf(self, x):
        """Sum of factor log-densities over their coordinate slices
        (requires every factor to implement ``log_pdf``)."""
        x = jnp.atleast_2d(jnp.asarray(x))
        lp = jnp.zeros(x.shape[0], dtype=x.dtype)
        off = 0
        for f in self.factors:
            lp = lp + f.log_pdf(x[:, off:off + f.n_rvs])
            off += f.n_rvs
        return lp


class MixtureDistribution(Distribution):
    """Finite mixture of component distributions.

    Reference parity: ``distributions.py::MixtureDistribution(weights, dist)``
    — supports both a list of component instances and a single distribution
    class plus per-component ctor arguments (``dist_args``/``dist_kw_args``).
    """

    def __init__(self, weights, dist, dist_args=None, dist_kw_args=None,
                 shuffle=True):
        # ``shuffle`` is accepted for reference API parity but vacuous here:
        # components are already assigned per-row at random in sample().
        del shuffle
        self.weights = jnp.asarray(weights, dtype=jnp.float32)
        if isinstance(dist, (list, tuple)):
            self.components = list(dist)
        else:
            n_comp = self.weights.shape[0]
            args = dist_args if dist_args is not None else [()] * n_comp
            kwargs = dist_kw_args if dist_kw_args is not None else [{}] * n_comp
            comps = []
            for i in range(n_comp):
                if isinstance(args[i], dict):
                    comps.append(dist(**{**args[i], **kwargs[i]}))
                else:
                    comps.append(dist(*np.atleast_1d(args[i]), **kwargs[i]))
            self.components = comps
        if len(self.components) != self.weights.shape[0]:
            raise ValueError("len(weights) must match number of components")

    @property
    def n_rvs(self):
        return self.components[0].n_rvs

    @property
    def n_dist(self):
        return len(self.components)

    def sample(self, key, n=1):
        k_choice, *k_comp = jax.random.split(key, 1 + self.n_dist)
        # Sample n draws from every component, then select per-row — a
        # static-shape formulation of mixture sampling (components are few).
        choice = jax.random.categorical(
            k_choice, jnp.log(jnp.clip(self.weights, EPS, None)), shape=(n,)
        )
        draws = jnp.stack(
            [c.sample(k, n) for c, k in zip(self.components, k_comp)], axis=0
        )  # (n_comp, n, d)
        return jnp.take_along_axis(
            draws, choice[None, :, None], axis=0
        )[0]


class PostselectedDistribution(Distribution):
    """Rejection-sample a base distribution against a model's validity
    constraint.

    Reference parity:
    ``distributions.py::PostselectedDistribution(distribution, model, maxiters)``.
    The redraw loop runs a *fixed* number of masked rounds
    (static shape under jit); slots still invalid after ``maxiters`` rounds
    keep the last draw, mirroring the reference's best-effort fallback.
    """

    def __init__(self, distribution, model, maxiters=100):
        self.distribution = distribution
        self.model = model
        self.maxiters = int(maxiters)

    @property
    def n_rvs(self):
        return self.distribution.n_rvs

    def log_pdf(self, x):
        """Base log-density restricted to the model's validity region —
        unnormalized (the acceptance-mass constant is omitted; constant
        shifts cancel in every consumer: MH ratios and BCRB gradients)."""
        x = jnp.atleast_2d(jnp.asarray(x))
        lp = self.distribution.log_pdf(x)
        return jnp.where(self.model.are_models_valid(x), lp, -jnp.inf)

    def sample(self, key, n=1):
        def body(carry, k):
            samples, valid = carry
            fresh = self.distribution.sample(k, n)
            fresh_valid = self.model.are_models_valid(fresh)
            take = (~valid) & fresh_valid
            samples = jnp.where(take[:, None], fresh, samples)
            valid = valid | fresh_valid
            return (samples, valid), None

        k0, krest = jax.random.split(key)
        init = self.distribution.sample(k0, n)
        valid = self.model.are_models_valid(init)

        def cond(carry):
            _, cur_valid, _, it = carry
            return (~jnp.all(cur_valid)) & (it < self.maxiters)

        def loop_body(carry):
            samples, cur_valid, k, it = carry
            k, sub = jax.random.split(k)
            (samples, cur_valid), _ = body((samples, cur_valid), sub)
            return samples, cur_valid, k, it + 1

        # early-exit: the common case (high-acceptance prior) pays ONE
        # round, not all maxiters
        samples, valid, _, _ = jax.lax.while_loop(
            cond, loop_body, (init, valid, krest, jnp.asarray(0)))
        if not isinstance(valid, jax.core.Tracer):
            # host-level call (the usual case: updater.reset): match the
            # reference, which RAISES when maxiters is exhausted, instead
            # of silently seeding the ensemble with invalid particles.
            # Inside jit (traced) the bounded best-effort result stands.
            n_bad = int(jnp.sum(~valid))
            if n_bad:
                raise RuntimeError(
                    f"PostselectedDistribution: {n_bad}/{n} samples still "
                    f"invalid after {self.maxiters} rejection rounds — "
                    "the model's validity region has very low acceptance "
                    "under the base distribution; raise maxiters or fix "
                    "the base distribution's support")
        return samples


class ConstrainedSumDistribution(Distribution):
    """Wrap an underlying distribution, rescaling each sample so its
    components sum to ``desired_total``.

    Reference parity: ``distributions.py::ConstrainedSumDistribution``.
    """

    def __init__(self, underlying_distribution, desired_total=1.0):
        self.underlying_distribution = underlying_distribution
        self.desired_total = float(desired_total)

    @property
    def n_rvs(self):
        return self.underlying_distribution.n_rvs

    def sample(self, key, n=1):
        s = self.underlying_distribution.sample(key, n)
        total = jnp.sum(s, axis=1, keepdims=True)
        return self.desired_total * s / jnp.where(total == 0, 1.0, total)


class ParticleDistribution(Distribution):
    """A weighted particle cloud usable as a distribution — e.g. an SMC
    posterior handed to a fresh updater (sequential/warm-start workflows).

    Reference parity: ``distributions.py::ParticleDistribution`` (SURVEY.md
    §2 #6 / §5 checkpoint-resume note).
    """

    def __init__(self, particle_locations, particle_weights=None):
        particle_locations = jnp.atleast_2d(
            jnp.asarray(particle_locations, dtype=jnp.float32))
        if particle_weights is not None and (
                jnp.ndim(particle_weights) != 1
                or jnp.shape(particle_weights)[0]
                != particle_locations.shape[0]):
            raise ValueError(
                f"particle_weights must be 1-D with one weight per "
                f"particle; got weights {jnp.shape(particle_weights)} vs "
                f"locations {particle_locations.shape} — note the "
                f"argument order is (locations, weights), matching the "
                f"reference")
        if particle_weights is None:
            n = particle_locations.shape[0]
            particle_weights = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
        particle_weights = jnp.asarray(particle_weights, dtype=jnp.float32)
        self.particle_locations = particle_locations
        self.particle_weights = particle_weights / jnp.sum(particle_weights)

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def n_ess(self):
        return 1.0 / jnp.sum(self.particle_weights ** 2)

    def est_mean(self):
        return self.particle_weights @ self.particle_locations

    def est_covariance_mtx(self):
        from .utils import particle_covariance_mtx

        return particle_covariance_mtx(
            self.particle_weights, self.particle_locations)

    def sample(self, key, n=1):
        idx = jax.random.categorical(
            key,
            jnp.log(jnp.clip(self.particle_weights, EPS, None)),
            shape=(n,),
        )
        return self.particle_locations[idx]


# ---------------------------------------------------------------------------
# Quantum priors (state vectors over the Bloch sphere / density matrices).
# The density-operator priors over a full TomographyBasis live in
# qinfer_tpu.tomography.distributions; these three are the small "qubit
# parameterized as (w, x, y, z)-style model parameter" priors the reference
# keeps in distributions.py.
# ---------------------------------------------------------------------------

class HaarUniform(SingleSampleMixin, Distribution):
    """Haar-uniform pure states of dimension ``dim``, returned as
    generalized Bloch coordinates ``Tr(rho·lambda_i)`` in the Gell-Mann
    basis (for qubits: the familiar ``(x, y, z)``).

    Reference parity: ``distributions.py::HaarUniform``.
    """

    def __init__(self, dim=2):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, key):
        # normalized complex-Gaussian vector == Haar pure state; complex
        # arithmetic unrolled to real (the device path stays real)
        ka, kb = jax.random.split(key)
        a = jax.random.normal(ka, (self.dim,))
        b = jax.random.normal(kb, (self.dim,))
        nrm = jnp.sqrt(jnp.sum(a * a + b * b))
        a, b = a / nrm, b / nrm
        re = jnp.outer(a, a) + jnp.outer(b, b)
        im = jnp.outer(b, a) - jnp.outer(a, b)
        return _bloch_coords(re, im)


class GinibreUniform(SingleSampleMixin, Distribution):
    """Ginibre-ensemble rank-``k`` mixed states of dimension ``dim``, as
    generalized (Gell-Mann) Bloch coordinates.

    Reference parity: ``distributions.py::GinibreUniform(dim, k)``.
    """

    def __init__(self, dim=2, k=2):
        self.dim = int(dim)
        self.k = int(k)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, key):
        return _ginibre_bloch(key, self.dim, self.k)


class HilbertSchmidtUniform(SingleSampleMixin, Distribution):
    """Hilbert-Schmidt-uniform mixed states (Ginibre with k = dim), as
    generalized (Gell-Mann) Bloch coordinates.

    Reference parity: ``distributions.py::HilbertSchmidtUniform``.
    """

    def __init__(self, dim=2):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, key):
        return _ginibre_bloch(key, self.dim, self.dim)


def _ginibre_bloch(key, dim, rank):
    """Generalized Bloch vector of a Ginibre-random state, computed with
    REAL arithmetic only (G = A + iB drawn as two real normals;
    ρ ∝ GG† has Re = AAᵀ + BBᵀ, Im = BAᵀ − ABᵀ — the device path stays
    real)."""
    kr, ki = jax.random.split(key)
    A = jax.random.normal(kr, (dim, rank))
    B = jax.random.normal(ki, (dim, rank))
    re = A @ A.T + B @ B.T
    im = B @ A.T - A @ B.T
    tr = jnp.trace(re)
    return _bloch_coords(re / tr, im / tr)


def _bloch_coords(re, im):
    """Coordinates ``Tr(rho·lambda_i)`` of the hermitian matrix
    ``rho = re + i·im`` in the Gell-Mann basis, ordered to match
    :func:`qinfer_tpu.tomography.bases.gell_mann_basis` (all symmetric
    pairs, then all antisymmetric pairs, then the d-1 diagonal
    generators) — for d=2 this is exactly ``(x, y, z)``, and for any d
    the result equals ``sqrt(2)`` times the tomography-model coordinates
    (the generators there are normalized to ``Tr(B_i B_j) = delta_ij``).

    Hermiticity gives the closed forms ``Tr(rho·lambda^s_jk) = 2 re[j,k]``
    and ``Tr(rho·lambda^a_jk) = 2 im[k,j]``; no complex ops needed.
    """
    dim = re.shape[0]
    out = []
    for j in range(dim):
        for k in range(j + 1, dim):
            out.append(2.0 * re[j, k])
    for j in range(dim):
        for k in range(j + 1, dim):
            out.append(2.0 * im[k, j])
    diag = jnp.diagonal(re)
    for l in range(1, dim):
        scale = math.sqrt(2.0 / (l * (l + 1)))
        out.append(scale * (jnp.sum(diag[:l]) - l * diag[l]))
    return jnp.stack(out)
