"""Model and simulator abstractions.

Reference parity: ``src/qinfer/abstract_model.py`` (SURVEY.md §2 #3) —
``Simulatable`` → ``Model`` → ``FiniteOutcomeModel`` plus
``DifferentiableModel`` and ``ScoreMixin``.

Design
------
* Models are :class:`~qinfer_tpu._pytree.Module` pytrees: instances pass
  straight through ``jit`` / ``vmap`` / ``lax.scan`` and shard over a mesh.
* ``likelihood(outcomes, modelparams, expparams)`` keeps the reference's
  ``(n_outcomes, n_models, n_expparams)`` shape contract
  (``src/qinfer/abstract_model.py::Model.likelihood``) and must be pure
  traceable JAX — it is the hot loop the engine fuses.
* **Experiment parameters are pytrees, not structured dtypes.** JAX has no
  structured arrays, so an ``expparams`` batch is a ``dict`` mapping field
  name → array with leading axis ``n_expparams``. Models still declare
  ``expparams_dtype`` (the reference's contract) and
  :func:`expparams_to_dict` / :func:`dict_to_expparams` convert between the
  NumPy structured-array convention and the pytree convention at the API
  boundary.
* Randomness is explicitly keyed: ``simulate_experiment(key, ...)``,
  ``update_timestep(key, ...)``.
* ``DifferentiableModel.score`` defaults to **autodiff** (``jax.grad`` of the
  log-likelihood) instead of the reference's central finite differences — a
  strictly more accurate replacement; the finite-difference path
  survives in :class:`ScoreMixin` for models whose likelihood is not
  differentiable.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ._pytree import Module
from .config import EPS
from .domains import IntegerDomain

__all__ = [
    "Simulatable",
    "Model",
    "FiniteOutcomeModel",
    "DifferentiableModel",
    "ScoreMixin",
    "expparams_to_dict",
    "dict_to_expparams",
    "n_expparams",
    "expparams_at",
    "concat_expparams",
]


# ---------------------------------------------------------------------------
# expparams pytree <-> structured array interop
# ---------------------------------------------------------------------------

def expparams_to_dict(eps, expparams_dtype=None):
    """Normalize experiment parameters to the pytree convention: a dict
    mapping field name → jnp array with leading axis ``n_expparams``.

    Accepts: an existing dict (validated/atleast-1d'd), a NumPy structured
    array (the reference convention, ``abstract_model.py::expparams_dtype``),
    or — for single-field models — a bare scalar/array.
    """
    if isinstance(eps, dict):
        return {k: jnp.atleast_1d(jnp.asarray(v)) for k, v in eps.items()}
    arr = np.asarray(eps)
    if arr.dtype.names:  # structured array
        return {
            name: jnp.atleast_1d(jnp.asarray(arr[name]))
            for name in arr.dtype.names
        }
    if expparams_dtype is not None:
        names = [f[0] for f in expparams_dtype]
        if len(names) == 1:
            return {names[0]: jnp.atleast_1d(jnp.asarray(arr))}
    raise ValueError(
        "cannot coerce expparams %r without a single-field dtype" % (eps,)
    )


def dict_to_expparams(eps_dict, expparams_dtype):
    """Convert a pytree expparams dict to a NumPy structured array (host-side
    interop with reference-style code)."""
    n = n_expparams(eps_dict)
    out = np.empty((n,), dtype=np.dtype(expparams_dtype))
    for name in out.dtype.names:
        out[name] = np.asarray(eps_dict[name])
    return out


def n_expparams(eps_dict):
    """Number of experiments in an expparams pytree (leading axis)."""
    leaves = jax.tree_util.tree_leaves(eps_dict)
    if not leaves:
        return 0
    return leaves[0].shape[0]


def expparams_at(eps_dict, idx):
    """Select experiment ``idx`` keeping the leading axis (length 1)."""
    return jax.tree_util.tree_map(lambda a: a[idx:idx + 1] if isinstance(idx, int)
                                  else jax.lax.dynamic_slice_in_dim(a, idx, 1, 0),
                                  eps_dict)


def concat_expparams(eps_list):
    """Concatenate expparams pytrees along the experiment axis."""
    return jax.tree_util.tree_map(
        lambda *a: jnp.concatenate(a, axis=0), *eps_list
    )


# ---------------------------------------------------------------------------
# Simulatable
# ---------------------------------------------------------------------------

class Simulatable(Module):
    """A parametric system that can be simulated, but need not expose an
    analytic likelihood.

    Reference parity: ``src/qinfer/abstract_model.py::Simulatable``
    (``n_modelparams``, ``modelparam_names``, ``expparams_dtype``,
    ``is_n_outcomes_constant``, ``n_outcomes``, ``domain``,
    ``are_models_valid``, ``canonicalize``, ``simulate_experiment``,
    ``experiment_cost``, ``update_timestep``, ``sim_count``/``call_count``).
    """

    # -- abstract interface ------------------------------------------------

    @property
    def n_modelparams(self):
        raise NotImplementedError

    @property
    def modelparam_names(self):
        return [f"x_{i}" for i in range(self.n_modelparams)]

    @property
    def expparams_dtype(self):
        """Reference-style dtype declaration: list of (name, dtype[, shape])."""
        raise NotImplementedError

    @property
    def is_n_outcomes_constant(self):
        return True

    def n_outcomes(self, expparams=None):
        """Number of possible outcomes (static upper bound for jit)."""
        raise NotImplementedError

    def domain(self, expparams=None):
        """Outcome :class:`~qinfer_tpu.domains.Domain` for the given
        experiments (a single Domain when constant)."""
        raise NotImplementedError

    def are_models_valid(self, modelparams):
        """(n_models,) boolean validity mask. Jittable."""
        raise NotImplementedError

    def canonicalize(self, modelparams):
        """Map model parameters to canonical form (default: identity)."""
        return modelparams

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        """Draw outcomes for each (model, experiment) pair.

        Returns an array of shape ``(repeat, n_models, n_expparams)`` (plus
        trailing outcome dims for vector-valued outcomes), squeezed like the
        reference when ``repeat == 1``.
        """
        raise NotImplementedError

    def experiment_cost(self, expparams):
        """Cost of running each experiment. Reference parity:
        ``abstract_model.py::Simulatable.experiment_cost`` — unit cost for
        every experiment by default; override for time-weighted designs
        (e.g. ``lambda eps: eps['t']``)."""
        eps = expparams_to_dict(expparams, self.expparams_dtype)
        return jnp.ones((n_expparams(eps),))

    @property
    def allow_identical_outcomes(self):
        return False

    @property
    def is_time_dependent(self):
        """True when this model genuinely evolves particles between
        experiments (the engine then runs ``update_timestep`` per step).
        Default: whether the class overrides ``update_timestep``."""
        return type(self).update_timestep is not Simulatable.update_timestep

    #: Trailing dimensionality of one outcome: 0 = scalar outcomes,
    #: 1 = vector-valued outcomes (e.g. multinomial count vectors).
    outcome_ndim = 0

    def update_timestep(self, key, modelparams, expparams):
        """Evolve model parameters after an experiment (time-dependent
        models). Returns ``(n_models, n_modelparams, n_expparams)`` like the
        reference; identity by default."""
        n_e = n_expparams(expparams_to_dict(expparams, self.expparams_dtype))
        return jnp.repeat(modelparams[:, :, None], n_e, axis=2)

    # -- bookkeeping -------------------------------------------------------

    def __init__(self):
        self._sim_count = 0
        self._call_count = 0

    def _bump(self, name, k=1):
        """Increment a host-side counter, robust to instances reconstructed
        by pytree unflattening (which drop underscore attributes)."""
        object.__setattr__(self, name, getattr(self, name, 0) + k)

    @property
    def sim_count(self):
        """Total single-experiment simulations requested via host calls.

        Reference parity: ``abstract_model.py::Simulatable.sim_count``. Under
        ``jit`` the count reflects host-level calls (trace-time), since
        device code cannot mutate Python state.
        """
        return getattr(self, "_sim_count", 0)

    @property
    def call_count(self):
        return getattr(self, "_call_count", 0)

    def reset_counters(self):
        self._sim_count = 0
        self._call_count = 0

    def clear_cache(self):
        """Reference parity: ``Simulatable.clear_cache`` (no-op hook)."""

    # -- misc --------------------------------------------------------------

    def canonicalize_expparams(self, expparams):
        """Coerce expparams (dict / structured array / scalar) to the pytree
        convention used by all engine internals. An EMPTY dict means "one
        default experiment": fields are synthesized as zeros of the model's
        ``expparams_dtype`` (the ergonomic analogue of the reference's
        size-1 structured array for models whose experiments carry no real
        parameters, e.g. ``CoinModel``)."""
        if isinstance(expparams, dict) and not expparams:
            out = {}
            for field in self.expparams_dtype:
                name, dtype = field[0], field[1]
                shape = (1,) + tuple(np.atleast_1d(field[2]).tolist()) \
                    if len(field) > 2 else (1,)
                out[name] = jnp.zeros(shape, dtype=dtype)
            return out
        return expparams_to_dict(expparams, self.expparams_dtype)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(Simulatable):
    """A simulatable system with an analytic likelihood.

    Reference parity: ``src/qinfer/abstract_model.py::Model`` — adds the
    ``likelihood(outcomes, modelparams, expparams)`` contract with output
    shape ``(n_outcomes, n_models, n_expparams)``, the quadratic-loss scale
    ``Q`` and ``distance``.
    """

    def likelihood(self, outcomes, modelparams, expparams):
        raise NotImplementedError

    def log_likelihood(self, outcomes, modelparams, expparams):
        """log of :meth:`likelihood`, same shape contract.

        Default: ``log(clip(likelihood))``. Models whose likelihoods
        underflow float32 (high-count binomial/Poisson tails) should
        override with an analytically stable form — the engine detects the
        override and switches the weight update to a max-shifted
        (logsumexp-style) path, so inference survives steps where every
        particle's linear likelihood would round to zero.
        """
        from .config import EPS

        return jnp.log(jnp.clip(
            self.likelihood(outcomes, modelparams, expparams), EPS, None))

    @property
    def has_log_likelihood(self):
        """Engine hook: True when the model provides an analytically
        STABLE ``log_likelihood`` override (the base clip-and-log default
        does not count — it inherits the linear form's underflow). The
        engine then uses the max-shifted log-space weight update.
        Delegating wrappers (``DerivedModel``) override this to walk the
        wrapper chain."""
        for klass in type(self).__mro__:
            if "log_likelihood" in vars(klass):
                return klass is not Model
        return False

    @property
    def Q(self):
        """Positive weights for the quadratic loss
        ``(est - true)^T diag(Q) (est - true)``.

        Reference parity: ``abstract_model.py::Model.Q`` (defaults to ones).
        """
        return jnp.ones((self.n_modelparams,))

    def distance(self, a, b):
        """Q-weighted distance between two batches of model parameters.

        Reference parity: ``abstract_model.py::Model.distance``.
        """
        a = jnp.atleast_2d(a)
        b = jnp.atleast_2d(b)
        d = a - b
        return jnp.sqrt(jnp.sum(self.Q * d * d, axis=-1))


# ---------------------------------------------------------------------------
# FiniteOutcomeModel
# ---------------------------------------------------------------------------

class FiniteOutcomeModel(Model):
    """A model whose outcomes form a finite set, enabling generic simulation
    by sampling the categorical likelihood and exact outcome
    marginalization for experiment design.

    Reference parity: ``src/qinfer/abstract_model.py::FiniteOutcomeModel``
    (generic ``simulate_experiment``; static ``pr0_to_likelihood_array``).
    """

    def domain(self, expparams=None):
        return IntegerDomain(0, self.n_outcomes(expparams) - 1)

    def outcomes(self, expparams=None):
        """Dense outcome values, shape ``(n_outcomes,)`` — the static grid
        the engine marginalizes over. Defaults to ``0..n_outcomes-1``."""
        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)

    def outcome_mask(self, expparams):
        """(n_outcomes, n_expparams) mask of which padded outcome slots are
        real for each experiment. All-true unless a subclass pads (e.g.
        BinomialModel with per-experiment ``n_meas``)."""
        eps = self.canonicalize_expparams(expparams)
        return jnp.ones(
            (self.n_outcomes(expparams), n_expparams(eps)), dtype=bool
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        # reference bookkeeping: one count per (model, experiment, repeat)
        self._bump("_sim_count",
                   int(repeat) * int(modelparams.shape[0])
                   * int(n_expparams(eps)))
        outcomes = self.outcomes(expparams)
        L = self.likelihood(outcomes, modelparams, eps)
        # (n_outcomes, n_models, n_eps) -> categorical over outcome axis
        logits = jnp.log(jnp.clip(L, EPS, None))
        idx = jax.random.categorical(
            key, jnp.moveaxis(logits, 0, -1), shape=(repeat,) + L.shape[1:]
        )
        sampled = outcomes[idx]
        if repeat == 1:
            sampled = sampled[0]
        return sampled

    @staticmethod
    def pr0_to_likelihood_array(outcomes, pr0):
        """Stack a two-outcome Pr(0) table into the full likelihood array.

        Reference parity:
        ``abstract_model.py::FiniteOutcomeModel.pr0_to_likelihood_array`` —
        outcome 0 ↦ pr0, anything else ↦ 1 − pr0.

        :param outcomes: (n_outcomes,) outcome labels (0 or 1).
        :param pr0: (n_models, n_expparams) probability of outcome 0.
        :return: (n_outcomes, n_models, n_expparams).
        """
        outcomes = jnp.asarray(outcomes)
        pr0 = jnp.asarray(pr0)
        o = outcomes.reshape((-1,) + (1,) * pr0.ndim)
        return jnp.where(o == 0, pr0[None], 1.0 - pr0[None])


# ---------------------------------------------------------------------------
# Differentiable models
# ---------------------------------------------------------------------------

class DifferentiableModel(Model):
    """A model exposing the score ∂ log L / ∂θ and Fisher information.

    Reference parity: ``src/qinfer/abstract_model.py::DifferentiableModel``
    (abstract ``score``, ``fisher_information``). Here the default
    ``score`` is exact reverse-mode autodiff of ``log likelihood`` — no
    finite differences needed for any JAX-differentiable likelihood.
    """

    def score(self, outcomes, modelparams, expparams, return_L=False):
        """∂ log L(outcome | θ, e) / ∂θ with shape
        ``(n_modelparams, n_outcomes, n_models, n_expparams)`` (reference
        convention)."""
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        outcomes = jnp.atleast_1d(outcomes)

        def log_L_single(x):
            # x: (d,) one particle -> (n_out, n_eps)
            L = self.likelihood(outcomes, x[None, :], eps)
            return jnp.log(jnp.clip(L[:, 0, :], EPS, None))

        # per-particle jacobian, vmapped: (n_m, n_out, n_eps, d).
        # (A whole-batch jacrev would materialize the (…, n_m, n_m, d)
        # cross-particle jacobian — O(n²) memory — just to take its
        # diagonal; the vmap form is O(n·d).)
        jac = jax.vmap(jax.jacrev(log_L_single))(modelparams)
        q = jnp.moveaxis(jac, (3, 0), (0, 2))  # (d, n_out, n_m, n_eps)
        if return_L:
            return q, self.likelihood(outcomes, modelparams, eps)
        return q

    def fisher_information(self, modelparams, expparams):
        """Fisher information matrix for each (model, experiment):
        ``E_outcomes[score scoreᵀ]``, shape ``(d, d, n_models, n_expparams)``
        (reference convention).

        Reference parity:
        ``abstract_model.py::DifferentiableModel.fisher_information``.
        """
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        outcomes = self.outcomes(eps) if hasattr(self, "outcomes") else None
        if outcomes is None:
            raise NotImplementedError(
                "fisher_information requires a finite outcome set"
            )
        scores, L = self.score(outcomes, modelparams, eps, return_L=True)
        # scores: (d, n_out, n_models, n_eps); L: (n_out, n_models, n_eps)
        return jnp.einsum("iomE,jomE,omE->ijmE", scores, scores, L)


class ScoreMixin:
    """Numerical score via central finite differences, for models whose
    likelihood is not autodiff-able (e.g. table lookups).

    Reference parity: ``src/qinfer/abstract_model.py::ScoreMixin`` (which
    uses ``finite_difference.py::FiniteDifference``).
    """

    _h = 1e-5

    def score(self, outcomes, modelparams, expparams, return_L=False):
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        outcomes = jnp.atleast_1d(outcomes)
        d = self.n_modelparams
        h = self._h

        def log_L(mps):
            return jnp.log(
                jnp.clip(self.likelihood(outcomes, mps, eps), EPS, None)
            )

        cols = []
        for i in range(d):
            dx = jnp.zeros((1, d)).at[0, i].set(h)
            cols.append((log_L(modelparams + dx) - log_L(modelparams - dx))
                        / (2 * h))
        q = jnp.stack(cols, axis=0)
        if return_L:
            return q, self.likelihood(outcomes, modelparams, eps)
        return q
