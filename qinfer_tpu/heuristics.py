"""Experiment-design heuristics.

Reference parity: ``src/qinfer/heuristics.py`` (SURVEY.md §2 #14) —
``Heuristic`` ABC, ``PGH`` (particle guess heuristic) and
``ExpSparseHeuristic``.

Design: every heuristic also exposes a **pure keyed form**
``heuristic.propose(key, weights, locations, idx_exp) -> eps_dict`` that is
jittable, so the whole adaptive loop (heuristic → simulate → update) can run
inside one ``lax.scan`` (see :mod:`qinfer_tpu.perf_testing`). The
``__call__(idx_exp)`` host API matches the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ._pytree import Module
from .config import EPS

__all__ = ["Heuristic", "PGH", "ExpSparseHeuristic", "IdentityHeuristic"]


class Heuristic(Module):
    """Abstract experiment heuristic bound to an updater.

    Reference parity: ``heuristics.py::Heuristic`` —
    ``__call__(idx_exp) -> expparams``.
    """

    def __init__(self, updater):
        self._updater = updater
        # the model is itself a pytree Module, so storing it as a regular
        # attribute lets `propose` survive flatten/unflatten (underscore
        # attrs like _updater are host bookkeeping and are dropped)
        self.model = getattr(updater, "model", None)

    @property
    def updater(self):
        return self._updater

    def __call__(self, idx_exp=0):
        st = self._updater.state
        key, sub = jax.random.split(st.key)
        self._updater.state = st._replace(key=key)
        return self.propose(sub, st.weights, st.locations,
                            jnp.asarray(idx_exp))

    def propose(self, key, weights, locations, idx_exp):
        """Pure keyed proposal — jittable; returns an expparams dict with
        one experiment."""
        raise NotImplementedError


class PGH(Heuristic):
    """Particle guess heuristic: draw two distinct particles x₁, x₂ from the
    posterior and choose ``t = 1 / ‖x₁ − x₂‖`` (the adaptive 1/σ rule),
    setting the inversion field to x₁.

    Reference parity: ``src/qinfer/heuristics.py::PGH(updater, inv_field,
    t_field, inv_func, t_func, maxiters, other_fields)`` — the reference
    redraws until the two particles differ; here the second draw excludes
    the first particle's index outright (the same conditional distribution,
    no loop) and the distance is clamped below by ``min_separation`` for
    exact location ties between distinct particles.
    """

    def __init__(self, updater, inv_field="x_", t_field="t",
                 inv_func=None, t_func=None, maxiters=10,
                 other_fields=None, min_separation=1e-12):
        super().__init__(updater)
        self.inv_field = inv_field
        self.t_field = t_field
        self.inv_func = inv_func
        self.t_func = t_func
        self.maxiters = int(maxiters)
        self.other_fields = dict(other_fields or {})
        self.min_separation = float(min_separation)

    def propose(self, key, weights, locations, idx_exp):
        k1, k2 = jax.random.split(key)
        logits = jnp.log(jnp.clip(weights, EPS, None))
        i = jax.random.categorical(k1, logits, shape=())
        # x2 is drawn from the posterior EXCLUDING particle i — exactly the
        # distribution of the reference's redraw-until-distinct loop (the
        # collision probability is 1/ESS, NOT measure-zero; a duplicated
        # cloud after resampling would otherwise propose t = 1/min_sep)
        j = jax.random.categorical(k2, logits.at[i].set(-jnp.inf), shape=())
        x1 = locations[i]
        x2 = locations[j]
        model = self.model
        if model is not None:
            # Q-weighted distance (reference parity: PGH uses
            # model.distance, not the raw euclidean norm — parameters on
            # different scales would otherwise mis-scale every proposal)
            sep = model.distance(x1[None, :], x2[None, :])[0]
        else:
            sep = jnp.linalg.norm(x1 - x2)
        t = 1.0 / jnp.maximum(sep, self.min_separation)
        if self.t_func is not None:
            t = self.t_func(t)
        eps = {self.t_field: jnp.atleast_1d(t)}
        # inversion fields: one scalar field per model parameter when the
        # model exposes them (e.g. SimpleInversionModel's 'w_')
        inv = x1 if self.inv_func is None else self.inv_func(x1)
        if model is not None:
            names = [f[0] for f in model.expparams_dtype]
            d = locations.shape[1]
            if d == 1:
                if self.inv_field in names:
                    eps[self.inv_field] = jnp.atleast_1d(inv[0])
            else:
                for k_idx in range(d):
                    fname = f"{self.inv_field}{k_idx}"
                    if fname in names:
                        eps[fname] = jnp.atleast_1d(inv[k_idx])
                if self.inv_field in names:
                    eps[self.inv_field] = inv[None, :]
        for fname, val in self.other_fields.items():
            eps[fname] = jnp.atleast_1d(jnp.asarray(val))
        return eps


class ExpSparseHeuristic(Heuristic):
    """Exponentially sparse non-adaptive times: ``t_k = scale * base**k``.

    Reference parity: ``src/qinfer/heuristics.py::ExpSparseHeuristic``.
    """

    def __init__(self, updater, scale=1.0, base=2.0, t_field="t",
                 other_fields=None):
        super().__init__(updater)
        self.scale = float(scale)
        self.base = float(base)
        self.t_field = t_field
        self.other_fields = dict(other_fields or {})

    def propose(self, key, weights, locations, idx_exp):
        # computed in log space and clamped: float32 base**idx overflows to
        # inf at idx >= 128 (base=2), which would silently NaN the whole
        # posterior through cos(inf)
        log_t = (jnp.log(jnp.asarray(self.scale))
                 + idx_exp.astype(jnp.float32) * jnp.log(
                     jnp.asarray(self.base)))
        t = jnp.exp(jnp.minimum(log_t, 60.0))  # cap at e^60 ~ 1.1e26
        eps = {self.t_field: jnp.atleast_1d(t)}
        for fname, val in self.other_fields.items():
            eps[fname] = jnp.atleast_1d(jnp.asarray(val))
        return eps


class IdentityHeuristic(Heuristic):
    """Always proposes fixed expparams (useful for tests and baselines)."""

    def __init__(self, updater, expparams):
        super().__init__(updater)
        self.expparams = {
            k: jnp.atleast_1d(jnp.asarray(v)) for k, v in expparams.items()
        }

    def propose(self, key, weights, locations, idx_exp):
        return self.expparams
