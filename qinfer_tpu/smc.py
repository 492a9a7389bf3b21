"""Sequential Monte Carlo updater — the inference engine core.

Reference parity: ``src/qinfer/smc.py`` (SURVEY.md §2 #4) — ``SMCUpdater``
(update / hypothetical_update / batch_update, ESS-triggered resampling,
moment & entropy estimators, cluster estimators, posterior sampling,
``bayes_risk`` / ``expected_information_gain`` adaptivity scores, credible
region estimation, marginals and plotting, model-selection evidence) and
``SMCUpdaterBCRB`` (Bayesian Cramér-Rao bound tracking).

Architecture
------------
* Engine state is an immutable pytree (:class:`SMCState`) of fixed-shape
  device arrays ``{weights (n,), locations (n, d), key, resample_count,
  log_total_likelihood, ...}``. The host-facing :class:`SMCUpdater` mirrors
  the reference's mutable API by swapping whole states.
* ``update`` is **one fused jitted step**: likelihood × weight × normalize ×
  ESS check × (conditional) Liu-West resample, compiled once and reused for
  every experiment — no per-step retraces, no host round-trips besides the
  outcome itself.
* ``batch_update`` is a single ``lax.scan`` over experiments — the entire
  data record is consumed on-device.
* ``bayes_risk`` / ``expected_information_gain`` marginalize over the
  outcome grid with masked fixed-shape reductions, vectorized over candidate
  experiment batches (the reference loops in scipy optimizers).
* All reductions are plain ``jnp`` sums/matmuls, so the same jitted code
  runs sharded over a ``jax.sharding.Mesh`` with XLA inserting ``psum`` /
  ``all_gather`` collectives (see :mod:`qinfer_tpu.parallel`).
* Host-side escape hatches exactly where the reference uses them: convex
  hulls, MVEE, DBSCAN clustering, plotting (SURVEY.md §7).
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import EPS
from ._exceptions import ZeroWeightError, ZeroWeightWarning
from .abstract_model import (
    Simulatable,
    expparams_at,
    n_expparams,
)
from .resamplers import LiuWestResampler
from .utils import (
    particle_covariance_mtx,
    weighted_moments,
    in_ellipsoid,
    mvee,
)

__all__ = ["SMCState", "SMCUpdater", "SMCUpdaterBCRB"]


class SMCState(NamedTuple):
    """The complete on-device state of an SMC run (a checkpointable pytree).

    Reference parity: the attribute set of ``smc.py::SMCUpdater``
    (``particle_weights``, ``particle_locations``, ``resample_count``, the
    log-evidence implicit in ``normalization_record``), made explicit so it
    can be donated through ``lax.scan``, sharded, and checkpointed (orbax or
    plain ``numpy.savez``).
    """

    weights: jax.Array        # (n,)
    locations: jax.Array      # (n, d)
    key: jax.Array            # PRNG key
    resample_count: jax.Array  # i32 scalar
    just_resampled: jax.Array  # bool scalar
    log_total_likelihood: jax.Array  # f32 scalar
    min_n_ess: jax.Array      # f32 scalar
    zero_weight_count: jax.Array  # i32 scalar
    resampler_fallback_count: jax.Array  # i32 scalar

    @property
    def n_particles(self):
        return self.weights.shape[0]

    @property
    def n_modelparams(self):
        return self.locations.shape[1]

    @classmethod
    def initial(cls, locations, key):
        """Fresh uniform-weight state over ``locations`` (the canonical
        post-``reset`` state; used by the engine, benchmarks and the driver
        entry points instead of hand-building all nine fields)."""
        locations = jnp.asarray(locations)
        n = locations.shape[0]
        return cls(
            weights=jnp.full((n,), 1.0 / n, dtype=jnp.float32),
            locations=locations,
            key=key,
            resample_count=jnp.asarray(0, dtype=jnp.int32),
            just_resampled=jnp.asarray(False),
            log_total_likelihood=jnp.asarray(0.0, dtype=jnp.float32),
            min_n_ess=jnp.asarray(float(n), dtype=jnp.float32),
            zero_weight_count=jnp.asarray(0, dtype=jnp.int32),
            resampler_fallback_count=jnp.asarray(0, dtype=jnp.int32),
        )


# ---------------------------------------------------------------------------
# Pure jitted engine functions
# ---------------------------------------------------------------------------

def _single_likelihood(model, locations, outcome, eps, key=None):
    """Likelihood of ONE outcome under ONE experiment: (n_particles,).

    Models that declare ``wants_likelihood_key = True`` (e.g.
    :class:`~qinfer_tpu.ale.ALEApproximateModel`, whose likelihood is a
    Monte-Carlo estimate) receive a per-step PRNG key so their noise is
    fresh on every scanned step instead of frozen at trace time.
    """
    outcome = _lift_outcome(model, outcome)
    if getattr(model, "wants_likelihood_key", False) and key is not None:
        L = model.likelihood(outcome, locations, eps, key=key)
    else:
        L = model.likelihood(outcome, locations, eps)
    return L[0, :, 0]


def _lift_outcome(model, outcome):
    """Shape one observed outcome for the likelihood contract: ``(1,)`` for
    scalar outcomes, ``(1, k)`` for vector-valued outcomes (models declare
    ``outcome_ndim = 1``, e.g. MultinomialModel count vectors)."""
    outcome = jnp.asarray(outcome)
    nd = int(getattr(model, "outcome_ndim", 0))
    if nd == 0:
        return outcome.reshape(-1)[:1]
    return outcome.reshape((-1,) + outcome.shape[-nd:])[:1]


def _is_time_dep(model):
    """Trace-time check whether the model is genuinely time-dependent.

    Delegating wrappers (``DerivedModel``) define ``update_timestep`` but
    merely forward it; consulting ``model.is_time_dependent`` walks the
    wrapper chain so static models (e.g. ``BinomialModel(SimplePrecession
    Model())`` — the simple_est hot path) do not pay an identity
    ``update_timestep`` pass per step."""
    return bool(model.is_time_dependent)


def _has_log_likelihood(model):
    """Trace-time check whether the model provides an analytically stable
    ``log_likelihood`` override (engine then uses the max-shifted weight
    update, immune to float32 likelihood underflow). Delegates to the
    model's ``has_log_likelihood`` hook so wrapper chains
    (``RandomWalkModel(BinomialModel(...))``) answer for the model that
    actually computes the likelihood."""
    return bool(getattr(model, "has_log_likelihood", False))


def _single_log_likelihood(model, locations, outcome, eps, key=None):
    """log-likelihood of ONE outcome under ONE experiment: (n_particles,)."""
    outcome = _lift_outcome(model, outcome)
    if getattr(model, "wants_likelihood_key", False) and key is not None:
        L = model.log_likelihood(outcome, locations, eps, key=key)
    else:
        L = model.log_likelihood(outcome, locations, eps)
    return L[0, :, 0]


def _reweight(model, weights, locations, outcome, eps, k_like):
    """One reweighting: returns (new_unnormalized_linear_hyp, norm) with
    norm = sum(hyp). Uses the max-shifted log path when the model provides
    a stable log_likelihood: hyp_i = w_i exp(logL_i - M); the returned
    ``norm`` is then exp(M)·sum(hyp) reconstructed in log space so the
    evidence record stays correct even when linear likelihoods underflow.
    """
    if _has_log_likelihood(model):
        log_ell = _single_log_likelihood(
            model, locations, outcome, eps, k_like)
        # Shift by the max of the POSTERIOR log-summand log w + logL, not
        # max logL alone: if the best-fitting particle carries negligible
        # weight, every w·exp(logL − max logL) can underflow even at
        # healthy ESS (observed: BinomialModel at 50 shots with
        # resample_interval=5 — the weights span ~40 f32 decades between
        # resamples). With this shift the largest summand is exactly 1,
        # so the shifted norm lives in [1, n] and cannot underflow, and
        # M = −inf means precisely "the outcome is impossible for every
        # particle that carries weight" — the zero-weight event.
        log_post = jnp.log(jnp.maximum(weights, 0.0)) + log_ell
        M = jnp.max(log_post)
        safe_M = jnp.where(jnp.isfinite(M), M, 0.0)
        hyp = jnp.exp(log_post - safe_M)
        shifted_norm = jnp.sum(hyp)
        log_norm = jnp.log(jnp.maximum(shifted_norm, EPS)) + safe_M
        # Zero-weight detection: M = -inf iff the outcome is EXACTLY
        # impossible (logL = -inf, e.g. log_binomial_pdf endpoint cases)
        # for every particle carrying weight — reference parity with the
        # f64 linear engine's exact-zero underflow. Merely-terrible fits
        # (finite logL however negative) survive, which is the point of
        # the log-space path.
        effective_norm = jnp.where(jnp.isfinite(M), shifted_norm, 0.0)
        return hyp, effective_norm, log_norm
    ell = _single_likelihood(model, locations, outcome, eps, k_like)
    norm = jnp.sum(weights * ell)
    return weights * ell, norm, jnp.log(jnp.maximum(norm, EPS))


def resample_interval_gate(idx, resample_interval):
    """Traced 'this step is resample-ELIGIBLE' predicate for interval-
    gated scanned loops (``perf_test_scan_batch``, the benches): fires on
    every K-th step; ``resample_interval <= 0`` returns ``None`` (gate
    EVERY step). NOTE the deliberate convention difference vs
    ``SMCUpdater.batch_update(resample_interval)``, where 0 means NEVER
    check (its ``check_now`` collapses to False) — runners treat 0 as
    "ungated" because they have no other way to say "check every step".
    Centralized here so the modulo convention lives in one place."""
    if resample_interval > 0:
        return (idx % resample_interval) == (resample_interval - 1)
    return None


def _gated_resample(resampler, model, sub, do_resample, w, x):
    """Run ONE resample iff ``do_resample`` (a traced bool), as a 0/1-trip
    ``lax.while_loop``.

    Why not ``lax.cond``: XLA aliases while-loop carries in place (body
    input/output share buffers), so the NOT-taken case costs one scalar
    predicate eval instead of the cond's entry/exit copies of the whole
    (weights, locations) state. Forward semantics are identical: the
    body runs exactly once iff ``do_resample`` (regression-pinned against
    the cond form on both the taken and untaken branch in
    tests/test_round4_fixes.py). Trade-off:
    ``while_loop`` has no transpose rule, so the update step is NOT
    reverse-mode differentiable — nothing in the engine grads through an
    update (score/Fisher paths differentiate the LIKELIHOOD, not the
    update), and that is not a supported contract.

    Returns ``(weights, locations, n_fallback)``.
    """
    def _resample_once(carry):
        w0, x0, _, _ = carry
        w2, x2, nf = resampler.call_with_diagnostics(model, sub, w0, x0)
        return (w2, x2, jnp.asarray(True), nf)

    w, x, _, n_fallback = jax.lax.while_loop(
        lambda c: do_resample & ~c[2],
        _resample_once,
        (w, x, jnp.asarray(False), jnp.asarray(0, jnp.int32)),
    )
    return w, x, n_fallback


def _update_step_impl(model, resampler, state, outcome, eps,
                      resample_thresh, zero_weight_thresh,
                      check_resample=True, resample_gate=None):
    """One fused SMC update: reweight → (timestep) → ESS check → resample.

    Reference parity: ``smc.py::SMCUpdater.update`` +
    ``SMCUpdater._maybe_resample``, as a single compiled step.
    ``resample_gate`` (optional traced bool) additionally gates the
    resample — ``batch_update`` passes its every-``resample_interval``-steps
    predicate through it so the scan body reuses this single
    implementation. Returns ``(new_state, log_normalization, was_zero)``.
    """
    n = state.weights.shape[0]
    key = state.key
    if getattr(model, "wants_likelihood_key", False):
        key, k_like = jax.random.split(key)
    else:
        k_like = None
    hyp, norm, log_norm = _reweight(
        model, state.weights, state.locations, outcome, eps, k_like)
    was_zero = norm <= zero_weight_thresh
    uniform = jnp.full_like(state.weights, 1.0 / n)
    new_w = jnp.where(was_zero, uniform, hyp / jnp.maximum(norm, EPS))
    log_total = state.log_total_likelihood + log_norm

    locs = state.locations
    if _is_time_dep(model):
        key, sub = jax.random.split(key)
        locs = model.update_timestep(sub, locs, eps)[:, :, 0]

    ess = 1.0 / jnp.sum(new_w * new_w)
    min_ess = jnp.minimum(state.min_n_ess, ess)

    if check_resample:
        do_resample = ess <= resample_thresh * n
        if resample_gate is not None:
            do_resample = do_resample & resample_gate
        key, sub = jax.random.split(key)
        new_w, locs, n_fallback = _gated_resample(
            resampler, model, sub, do_resample, new_w, locs)
    else:
        do_resample = jnp.asarray(False)
        n_fallback = jnp.asarray(0, jnp.int32)

    new_state = SMCState(
        weights=new_w,
        locations=locs,
        key=key,
        resample_count=state.resample_count + do_resample.astype(jnp.int32),
        just_resampled=do_resample,
        log_total_likelihood=log_total,
        min_n_ess=min_ess,
        zero_weight_count=state.zero_weight_count + was_zero.astype(jnp.int32),
        resampler_fallback_count=(state.resampler_fallback_count
                                  + n_fallback),
    )
    return new_state, log_norm, was_zero


#: Jit-compiled update step (the default path).
_update_step = partial(jax.jit, static_argnames=("check_resample",))(
    _update_step_impl)


def _update_step_eager(model, resampler, state, outcome, eps,
                       resample_thresh, zero_weight_thresh,
                       check_resample=True):
    """Eager (untraced) twin of :func:`_update_step_impl` for host-side
    models whose ``likelihood`` runs outside XLA (e.g.
    ``DirectViewParallelizedModel`` dispatching to an engine pool). Control
    flow uses concrete Python branches instead of ``lax.cond``."""
    n = state.weights.shape[0]
    key0 = state.key
    if getattr(model, "wants_likelihood_key", False):
        key0, k_like = jax.random.split(key0)
        state = state._replace(key=key0)
    else:
        k_like = None
    hyp, norm, log_norm = _reweight(
        model, state.weights, state.locations, outcome, eps, k_like)
    was_zero = bool(norm <= zero_weight_thresh)
    if was_zero:
        new_w = jnp.full_like(state.weights, 1.0 / n)
    else:
        new_w = hyp / jnp.maximum(norm, EPS)
    log_total = state.log_total_likelihood + log_norm

    key = state.key
    locs = state.locations
    if _is_time_dep(model):
        key, sub = jax.random.split(key)
        locs = model.update_timestep(sub, locs, eps)[:, :, 0]

    ess = 1.0 / jnp.sum(new_w * new_w)
    do_resample = bool(check_resample) and bool(ess <= resample_thresh * n)
    n_fallback = jnp.asarray(0, jnp.int32)
    if do_resample:
        key, sub = jax.random.split(key)
        new_w, locs, n_fallback = resampler.call_with_diagnostics(
            model, sub, new_w, locs)

    new_state = SMCState(
        weights=new_w,
        locations=locs,
        key=key,
        resample_count=state.resample_count + int(do_resample),
        just_resampled=jnp.asarray(do_resample),
        log_total_likelihood=log_total,
        min_n_ess=jnp.minimum(state.min_n_ess, ess),
        zero_weight_count=state.zero_weight_count + int(was_zero),
        resampler_fallback_count=(state.resampler_fallback_count
                                  + n_fallback),
    )
    return new_state, log_norm, jnp.asarray(was_zero)


@partial(jax.jit, static_argnames=("resample_interval", "check_resample",
                                   "n_mcmc_moves", "sufficient",
                                   "mcmc_canonicalize",
                                   "waste_free_stages", "use_adaptive",
                                   "mcmc_method", "mcmc_adapt",
                                   "waste_free_kernel",
                                   "waste_free_lw_seed"))
def _batch_update(model, resampler, state, outcomes, eps_batch,
                  resample_thresh, zero_weight_thresh,
                  resample_interval=5, check_resample=True,
                  prior=None, rec_outcomes=None, rec_eps=None, n_past=0,
                  n_mcmc_moves=0, proposal_scale=2.38,
                  sufficient=False, pool_eps=None, pool_idx=None,
                  succ0=None, trials0=None, succ_inc=None, trials_inc=None,
                  mcmc_canonicalize=True, waste_free_stages=0,
                  use_adaptive=False, mcmc_method="rwm", mcmc_adapt=False,
                  target_accept=0.234, log_scale0=0.0, adapt_t0=0,
                  waste_free_kernel="rwm", waste_free_lw_seed=None,
                  waste_free_beta=0.3):
    """``lax.scan`` over a whole experiment record.

    Reference parity: ``smc.py::SMCUpdater.batch_update(resample_interval)``
    — resampling is only *checked* every ``resample_interval`` steps, exactly
    like the reference; here the check collapses into the scanned step as a
    traced predicate so the scan body stays a single compiled program.

    With ``n_mcmc_moves > 0``, every resample is followed by that many
    Metropolis rejuvenation moves targeting prior × record likelihood
    (:mod:`qinfer_tpu.rejuvenation`); ``rec_outcomes`` / ``rec_eps`` is the
    FULL record — ``n_past`` pre-batch experiments then this batch, padded
    to a power of two by the caller so successive calls retrace only
    O(log T) times — and the step mask (``n_past`` is TRACED, never a
    compile key) exposes exactly the experiments observed so far.

    With ``sufficient=True`` (``SMCUpdater(compress_mcmc_record=True)``),
    the record rides as per-candidate sufficient statistics instead:
    ``pool_eps`` is the deduplicated candidate pool (leading axis E, the
    wrapped two-outcome expparams), ``pool_idx`` (T,) maps each scan step
    to its candidate, ``succ0``/``trials0`` carry the pre-batch totals and
    ``succ_inc``/``trials_inc`` (T,) this batch's per-step increments —
    each MH evaluation is one (n, E) pool pass, so the rejuvenation cost
    is independent of the record length (VERDICT r3 #5).
    """
    check_now = check_resample and resample_interval > 0
    rejuvenating = n_mcmc_moves > 0 or waste_free_stages > 0

    def step(carry, inp):
        ls = t = None
        if sufficient and rejuvenating:
            if use_adaptive:
                st, succ, trials, ls, t = carry
            else:
                st, succ, trials = carry
            outcome, eps, idx, c_idx, s_inc, t_inc = inp
        elif use_adaptive:
            st, ls, t = carry
            outcome, eps, idx = inp
        else:
            st = carry
            outcome, eps, idx = inp
        gate = (resample_interval_gate(idx, resample_interval)
                if check_now else None)
        new_st, log_norm, _ = _update_step_impl(
            model, resampler, st, outcome, eps,
            resample_thresh, zero_weight_thresh,
            # waste-free REPLACES the resample: the step only reweights
            # and the kernel below fires on the ESS gate directly
            check_resample=check_now and waste_free_stages == 0,
            resample_gate=gate)
        if sufficient and waste_free_stages > 0:
            from .rejuvenation import waste_free_rejuvenate_binomial

            succ = succ.at[c_idx].add(s_inc)
            trials = trials.at[c_idx].add(t_inc)
            if not check_now:
                # resample_interval=0 means NEVER check (batch_update
                # convention, resample_interval_gate docstring): the
                # waste-free kernel replaces the resample, so it obeys
                # the same gate and never fires here
                return (new_st._replace(
                    just_resampled=jnp.asarray(False)), succ, trials), \
                    log_norm
            ess = 1.0 / jnp.sum(new_st.weights * new_st.weights)
            do_wf = (ess <= resample_thresh * new_st.weights.shape[0]) \
                & gate

            def wf(s):
                key, sub = jax.random.split(s.key)
                w, x, _ = waste_free_rejuvenate_binomial(
                    model, prior, sub, s.weights, s.locations, succ,
                    trials, pool_eps, waste_free_stages, proposal_scale,
                    canonicalize=mcmc_canonicalize,
                    kernel=waste_free_kernel,
                    lw_seed_a=waste_free_lw_seed, beta=waste_free_beta)
                return s._replace(
                    weights=w, locations=x, key=key,
                    just_resampled=jnp.asarray(True),
                    resample_count=s.resample_count + 1)

            new_st = jax.lax.cond(
                do_wf, wf,
                lambda s: s._replace(just_resampled=jnp.asarray(False)),
                new_st)
            return (new_st, succ, trials), log_norm
        if sufficient and n_mcmc_moves > 0:
            succ = succ.at[c_idx].add(s_inc)
            trials = trials.at[c_idx].add(t_inc)
            if use_adaptive:
                from .rejuvenation import mcmc_rejuvenate_binomial_adaptive

                def move(op):
                    s, ls_, t_ = op
                    key, sub = jax.random.split(s.key)
                    x, _, ls_, t_ = mcmc_rejuvenate_binomial_adaptive(
                        model, prior, sub, s.locations, succ, trials,
                        pool_eps, n_mcmc_moves, ls_, t_,
                        method=mcmc_method, target_accept=target_accept,
                        canonicalize=mcmc_canonicalize, adapt=mcmc_adapt)
                    return s._replace(locations=x, key=key), ls_, t_

                new_st, ls, t = jax.lax.cond(
                    new_st.just_resampled, move, lambda op: op,
                    (new_st, ls, t))
                return (new_st, succ, trials, ls, t), log_norm
            from .rejuvenation import mcmc_rejuvenate_binomial

            def move(s):
                key, sub = jax.random.split(s.key)
                x, _ = mcmc_rejuvenate_binomial(
                    model, prior, sub, s.locations, succ, trials,
                    pool_eps, n_mcmc_moves, proposal_scale,
                    canonicalize=mcmc_canonicalize)
                return s._replace(locations=x, key=key)

            new_st = jax.lax.cond(new_st.just_resampled, move,
                                  lambda s: s, new_st)
            return (new_st, succ, trials), log_norm
        if n_mcmc_moves > 0:
            if use_adaptive:
                from .rejuvenation import mcmc_rejuvenate_adaptive

                def move(op):
                    s, ls_, t_ = op
                    key, sub = jax.random.split(s.key)
                    mask = (jnp.arange(rec_outcomes.shape[0])
                            < (n_past + idx + 1))
                    x, _, ls_, t_ = mcmc_rejuvenate_adaptive(
                        model, prior, sub, s.locations, rec_outcomes,
                        rec_eps, mask, n_mcmc_moves, ls_, t_,
                        method=mcmc_method, target_accept=target_accept,
                        canonicalize=mcmc_canonicalize, adapt=mcmc_adapt)
                    return s._replace(locations=x, key=key), ls_, t_

                new_st, ls, t = jax.lax.cond(
                    new_st.just_resampled, move, lambda op: op,
                    (new_st, ls, t))
                return (new_st, ls, t), log_norm
            from .rejuvenation import mcmc_rejuvenate

            def move(s):
                key, sub = jax.random.split(s.key)
                mask = (jnp.arange(rec_outcomes.shape[0])
                        < (n_past + idx + 1))
                x, _ = mcmc_rejuvenate(
                    model, prior, sub, s.locations, rec_outcomes, rec_eps,
                    mask, n_mcmc_moves, proposal_scale,
                    canonicalize=mcmc_canonicalize)
                return s._replace(locations=x, key=key)

            new_st = jax.lax.cond(new_st.just_resampled, move,
                                  lambda s: s, new_st)
        return new_st, log_norm

    n_steps = outcomes.shape[0]
    idxs = jnp.arange(n_steps)
    ls0 = jnp.asarray(log_scale0, state.locations.dtype)
    t0 = jnp.asarray(adapt_t0, jnp.int32)
    if sufficient and rejuvenating:
        if use_adaptive:
            (final, _, _, ls, t), norms = jax.lax.scan(
                step, (state, succ0, trials0, ls0, t0),
                (outcomes, eps_batch, idxs, pool_idx, succ_inc,
                 trials_inc))
            return final, norms, ls, t
        (final, _, _), norms = jax.lax.scan(
            step, (state, succ0, trials0),
            (outcomes, eps_batch, idxs, pool_idx, succ_inc, trials_inc))
        return final, norms
    if use_adaptive:
        (final, ls, t), norms = jax.lax.scan(
            step, (state, ls0, t0), (outcomes, eps_batch, idxs))
        return final, norms, ls, t
    final, norms = jax.lax.scan(step, state, (outcomes, eps_batch, idxs))
    return final, norms


@jax.jit
def _entropy(w):
    """−Σ wᵢ log wᵢ as one compiled program (rule #9: one dispatch)."""
    return -jnp.sum(jnp.where(w > 0, w * jnp.log(jnp.clip(w, EPS, None)),
                              0.0))


@jax.jit
def _sorted_by_weight(w, x):
    """Particles sorted by weight descending, as ONE compiled program
    (one device dispatch for region queries; see est_credible_region)."""
    order = jnp.argsort(-w)
    return w[order], x[order]


def _likelihood_grid(model, outcomes, locations, eps, key):
    """Likelihood table for a scorer; threads a PRNG key into Monte-Carlo
    likelihoods (``wants_likelihood_key``) so repeated design calls see
    FRESH noise instead of one realization frozen into the compiled
    executable (the model pytree loses its host-side seed counter inside
    jit, so the key must come in as a traced argument)."""
    if getattr(model, "wants_likelihood_key", False) and key is not None:
        return model.likelihood(outcomes, locations, eps, key=key)
    return model.likelihood(outcomes, locations, eps)


@jax.jit
def _hypothetical_update(model, weights, locations, outcomes, eps,
                         key=None):
    """Posterior weights for every (outcome, experiment) hypothesis.

    Reference parity: ``smc.py::SMCUpdater.hypothetical_update`` — returns
    ``(norm_weights (n_out, n_eps, n), L (n_out, n, n_eps),
    norms (n_out, n_eps))``.
    """
    L = _likelihood_grid(model, outcomes, locations, eps, key)
    hyp = L * weights[None, :, None]
    norms = jnp.sum(hyp, axis=1)  # (n_out, n_eps)
    norm_w = jnp.moveaxis(hyp, 1, 2) / jnp.maximum(norms, EPS)[..., None]
    return norm_w, L, norms


@jax.jit
def _bayes_risk(model, weights, locations, outcomes, mask, eps, Q,
                key=None):
    """Expected posterior Q-weighted variance, marginalized over outcomes.

    Reference parity: ``smc.py::SMCUpdater.bayes_risk`` — risk(e) =
    Σ_o Pr(o|e) · Σ_j Q_j Var_posterior[θ_j | o, e]. Masked fixed-shape
    reduction so padded outcome slots (variable-n binomial) contribute 0.

    Matmul formulation: the contraction is TWO matmuls of the likelihood
    table against weighted raw-moment matrices — ``N = L·w`` and
    ``M = L·(w ⊙ [x, x²])`` — with the posterior normalization applied at
    the small ``(n_out, n_cand, 2d)`` output, NOT per particle. The
    previous form materialized two extra ``(n_out, n, n_cand)``
    temporaries (``hyp`` and the normalized ``w_prime``), which at 10M
    particles × 256 candidates is ~20 GB of memory traffic per scoring
    call.
    """
    L = _likelihood_grid(model, outcomes, locations, eps, key)
    L = L * mask[:, None, :]
    d = locations.shape[1]
    xaug = jnp.concatenate([locations, locations * locations], axis=1)
    N = jnp.einsum("onE,n->oE", L, weights)  # Pr(outcome | e)
    M = jnp.einsum("onE,nk->oEk", L, weights[:, None] * xaug)
    inv_n = 1.0 / jnp.maximum(N, EPS)[..., None]
    mu = M[..., :d] * inv_n
    x2 = M[..., d:] * inv_n
    var = jnp.clip(x2 - mu * mu, 0.0, None)
    risk_per_outcome = var @ Q  # (n_out, n_e)
    return jnp.sum(N * risk_per_outcome, axis=0)


@jax.jit
def _expected_information_gain(model, weights, locations, outcomes, mask,
                               eps, key=None):
    """Mutual information between outcome and parameters for each candidate
    experiment.

    Reference parity: ``smc.py::SMCUpdater.expected_information_gain`` —
    IG(e) = H[Pr(o|e)] − E_θ H[Pr(o|θ,e)] (entropies in nats).
    """
    L = _likelihood_grid(model, outcomes, locations, eps, key)
    L = L * mask[:, None, :]
    marg = jnp.einsum("onE,n->oE", L, weights)  # Pr(o | e)
    h_marg = -jnp.sum(marg * jnp.log(jnp.clip(marg, EPS, None)), axis=0)
    h_cond_per_theta = -jnp.sum(
        L * jnp.log(jnp.clip(L, EPS, None)), axis=0
    )  # (n, n_e)
    h_cond = jnp.einsum("nE,n->E", h_cond_per_theta, weights)
    return h_marg - h_cond


@jax.jit
def _weighted_mean(weights, locations):
    return weights @ locations


# ---------------------------------------------------------------------------
# SMCUpdater
# ---------------------------------------------------------------------------

class SMCUpdater:
    """Sequential Monte Carlo Bayesian updater over a particle ensemble.

    Reference parity: ``src/qinfer/smc.py::SMCUpdater`` — constructor
    signature and estimator surface match (modulo explicit PRNG seeding and
    pytree expparams); see the module docstring for the architectural
    differences.

    :param model: a :class:`~qinfer_tpu.abstract_model.Model`.
    :param int n_particles: ensemble size.
    :param prior: a :class:`~qinfer_tpu.distributions.Distribution`.
    :param float resample_thresh: resample when ``n_ess <= thresh * n``.
    :param resampler: a :class:`~qinfer_tpu.resamplers.Resampler`
        (default ``LiuWestResampler(a=0.98)``).
    :param str zero_weight_policy: ``'error'``, ``'warn'`` or ``'reset'`` —
        what to do when an outcome annihilates all weights
        (reference ``zero_weight_policy`` kwarg).
    :param float zero_weight_thresh: numeric threshold for "all zero".
    :param bool canonicalize: apply ``model.canonicalize`` to prior samples.
    :param seed: int seed or PRNG key for all stochastic engine operations.
    :param sharding: optional ``jax.sharding.NamedSharding`` for the particle
        axis (see :mod:`qinfer_tpu.parallel`).
    :param int n_mcmc_moves: Metropolis rejuvenation moves after each
        resample, targeting prior × record likelihood
        (:mod:`qinfer_tpu.rejuvenation`).
    :param bool compress_mcmc_record: keep the rejuvenation record as
        per-candidate binomial sufficient statistics (exact for two-outcome
        models and ``BinomialModel`` counts) so each MH evaluation costs
        O(E·n) in the number of DISTINCT experiments instead of O(T·n) in
        the record length.
    :param bool mcmc_canonicalize: re-apply ``model.canonicalize`` after
        each rejuvenation call (default). ``False`` skips the strict
        projection — accepted proposals already satisfy
        ``model.are_models_valid``, and at high embedded dimension the
        projection can dominate the move call.
    :param int waste_free_stages: P > 0 replaces the resample + moves
        with Dau-Chopin waste-free resample-move when the ESS gate
        fires: n/P ancestors, every state of a (P−1)-step chain kept.
        Requires ``compress_mcmc_record=True`` and P | n_particles.
        The chain must decorrelate P-fold-copied ancestors, so prefer
        this when the model dimension is at most the chain length and
        keep Liu-West + ``n_mcmc_moves`` above that.
    :param str waste_free_kernel: chain proposal family for the
        waste-free kernel — ``'rwm'`` (random walk, the round-4 default)
        or ``'pcn'`` (preconditioned Crank-Nicolson: dimension-robust
        acceptance against the ensemble's Gaussian approximation).
    :param waste_free_lw_seed: optional Liu-West shrinkage parameter
        ``a``: perturb the waste-free ancestors with one LW step before
        chaining, restoring ensemble spread immediately at high
        dimension (round 5, VERDICT r4 #6).
    :param float waste_free_beta: pCN step size (``'pcn'`` kernel only).
    :param str mcmc_method: rejuvenation proposal family — ``'rwm'``
        (random walk, the default) or ``'mala'`` (Langevin: proposals
        drift along ∇ log posterior; two extra matvecs on compressed
        binomial records, optimal acceptance 0.574 vs 0.234). MALA
        requires a deterministic likelihood.
    :param bool mcmc_adapt: Robbins-Monro adaptation of the proposal
        step size toward ``mcmc_target_accept`` after every Metropolis
        sweep (:mod:`qinfer_tpu.rejuvenation`). With adaptation on,
        ``mcmc_proposal_scale`` only seeds the initial scale (left at
        its 2.38 default, the method's optimal-scaling constant is used
        instead) and the adapted state persists across updates and
        checkpoints.
    :param float mcmc_target_accept: acceptance target for adaptation
        (default: 0.234 for 'rwm', 0.574 for 'mala').
    """

    def __init__(self, model, n_particles, prior,
                 resample_thresh=0.5, resampler=None,
                 debug_resampling=False,
                 track_resampling_divergence=False,
                 zero_weight_policy="error", zero_weight_thresh=None,
                 canonicalize=True, seed=0, sharding=None,
                 n_mcmc_moves=0, mcmc_proposal_scale=2.38,
                 compress_mcmc_record=False, mcmc_canonicalize=True,
                 waste_free_stages=0, mcmc_method="rwm",
                 mcmc_adapt=False, mcmc_target_accept=None,
                 waste_free_kernel="rwm", waste_free_lw_seed=None,
                 waste_free_beta=0.3):
        self.model = model
        self.prior = prior
        self._n_particles = int(n_particles)
        self.resample_thresh = float(resample_thresh)
        if resampler is not None:
            self.resampler = resampler
        else:
            # Resample-move configs get the validity-tolerant Liu-West
            # contract — but ONLY when the move
            # block itself re-applies the strict model projection
            # (mcmc_canonicalize=True, the default): one strict
            # projection per resample-move event instead of two. The
            # invariant "at least one strict projection per event" is
            # LOAD-BEARING at high dimension: with BOTH projections off,
            # the 255-dim flagship's fidelity collapses 0.98 → 0.48-0.65
            # (posterior mass leaks into the psd_tol shell where clipped
            # likelihoods saturate),
            # while 63 dims survives. So strictness is hygiene per
            # PROJECTION but correctness per EVENT.
            self.resampler = LiuWestResampler(
                a=0.98, canonicalize=not (int(n_mcmc_moves) > 0
                                          and int(waste_free_stages) == 0
                                          and bool(mcmc_canonicalize)))
        self.debug_resampling = bool(debug_resampling)
        self.track_resampling_divergence = bool(track_resampling_divergence)
        self.zero_weight_policy = zero_weight_policy
        self.zero_weight_thresh = (float(zero_weight_thresh)
                                   if zero_weight_thresh is not None else 1e-10)
        self._canonicalize = bool(canonicalize)
        self.sharding = sharding
        self.n_mcmc_moves = int(n_mcmc_moves)
        self.mcmc_proposal_scale = float(mcmc_proposal_scale)
        self.mcmc_canonicalize = bool(mcmc_canonicalize)
        self.mcmc_method = str(mcmc_method)
        self.mcmc_adapt = bool(mcmc_adapt)
        self._rejuvenating = (int(n_mcmc_moves) > 0
                              or int(waste_free_stages) > 0)
        # adaptive kernel: whenever the method is not the legacy fixed
        # random walk, or adaptation is requested (the adaptive core with
        # adapt=False is fixed-scale MALA)
        self._use_adaptive_kernel = (int(n_mcmc_moves) > 0
                                     and (self.mcmc_adapt
                                          or self.mcmc_method != "rwm"))
        self.mcmc_target_accept = None
        self._mcmc_log_scale0 = 0.0
        if self.mcmc_adapt or self.mcmc_method != "rwm":
            from .rejuvenation import (default_target_accept,
                                       initial_log_scale)

            # validates the method string too
            self.mcmc_target_accept = (
                default_target_accept(self.mcmc_method)
                if mcmc_target_accept is None else float(mcmc_target_accept))
            if (self.mcmc_method == "mala"
                    and getattr(model, "wants_likelihood_key", False)):
                raise ValueError(
                    "mcmc_method='mala' requires a deterministic "
                    "likelihood (Monte-Carlo likelihoods have no usable "
                    "gradient; use mcmc_method='rwm')")
            if int(waste_free_stages) > 0:
                raise ValueError(
                    "mcmc_adapt / mcmc_method='mala' apply to the "
                    "post-resample move kernel (n_mcmc_moves), not the "
                    "waste-free kernel")
            # a proposal_scale left at the 2.38 default means "use the
            # method's optimal-scaling constant" (2.38 IS the RWM one)
            ps = (None if float(mcmc_proposal_scale) == 2.38
                  else float(mcmc_proposal_scale))
            self._mcmc_log_scale0 = initial_log_scale(
                int(model.n_modelparams), self.mcmc_method, ps)
        if self._rejuvenating:
            # resample-move targets prior × Π likelihood over the record —
            # only meaningful for STATIC parameters and tractable priors;
            # fail fast on both (qinfer_tpu.rejuvenation module docstring)
            if bool(model.is_time_dependent):
                raise ValueError(
                    "n_mcmc_moves > 0 is incompatible with time-dependent "
                    "models: past-data likelihood is not the posterior of "
                    "parameters that moved between experiments")
            from .rejuvenation import resolve_prior_log_pdf

            resolve_prior_log_pdf(prior)  # raises for intractable priors
        self.compress_mcmc_record = bool(compress_mcmc_record)
        self.waste_free_stages = int(waste_free_stages)
        self.waste_free_kernel = str(waste_free_kernel)
        self.waste_free_lw_seed = (None if waste_free_lw_seed is None
                                   else float(waste_free_lw_seed))
        self.waste_free_beta = float(waste_free_beta)
        if self.waste_free_kernel not in ("rwm", "pcn"):
            raise ValueError(
                f"unknown waste_free_kernel {self.waste_free_kernel!r} "
                "(rwm | pcn)")
        if self.waste_free_stages > 0:
            if not compress_mcmc_record:
                raise ValueError(
                    "waste_free_stages > 0 requires "
                    "compress_mcmc_record=True (the chain targets the "
                    "sufficient-statistic record)")
            if self._n_particles % self.waste_free_stages:
                raise ValueError(
                    f"waste_free_stages={self.waste_free_stages} must "
                    f"divide n_particles={self._n_particles}")
            if zero_weight_policy == "error":
                raise ValueError(
                    "waste_free_stages > 0 is incompatible with "
                    "zero_weight_policy='error' (the key-faithful batch "
                    "replay does not model the waste-free kernel's key "
                    "consumption)")
        self._two_outcome_model = None
        self._record_is_binomial = False
        if self.compress_mcmc_record:
            # Sufficient-statistic record (VERDICT r3 #5): the record
            # collapses exactly to per-candidate success/trial totals for
            # Bernoulli two-outcome models and BinomialModel counts —
            # rejuvenation cost becomes O(E·n) per MH evaluation (E =
            # distinct experiments seen) instead of O(T·n).
            from .derived_models import BinomialModel

            if not self._rejuvenating:
                raise ValueError("compress_mcmc_record=True requires "
                                 "n_mcmc_moves > 0 or waste_free_stages "
                                 "> 0 (it only affects the rejuvenation "
                                 "record)")
            if isinstance(model, BinomialModel):
                self._two_outcome_model = model.underlying_model
                self._record_is_binomial = True
            elif (getattr(model, "is_n_outcomes_constant", True)
                    and model.n_outcomes(None) == 2):
                self._two_outcome_model = model
            else:
                raise ValueError(
                    "compress_mcmc_record=True requires a two-outcome "
                    "model or a BinomialModel over one (the record "
                    "factorizes through per-candidate binomial "
                    "sufficient statistics)")
            if getattr(self._two_outcome_model, "wants_likelihood_key",
                       False):
                raise ValueError(
                    "compress_mcmc_record=True requires a deterministic "
                    "two-outcome likelihood (Monte-Carlo likelihoods "
                    "cannot reproduce per-record-step noise from "
                    "compressed statistics)")
        if isinstance(seed, int):
            self._base_key = jax.random.key(seed)
        else:
            self._base_key = seed
        self.reset()

    # -- state management --------------------------------------------------

    def reset(self, n_particles=None):
        """Draw a fresh ensemble from the prior.

        Reference parity: ``smc.py::SMCUpdater.reset``.
        """
        if n_particles is not None:
            self._n_particles = int(n_particles)
        n = self._n_particles
        key, k_prior = jax.random.split(self._base_key)
        locations = self.prior.sample(k_prior, n)
        if self._canonicalize:
            locations = self.model.canonicalize(locations)
        state = SMCState.initial(locations, key)
        if self.sharding is not None:
            state = self._shard_state(state)
        self._state = state
        self.data_record = []
        self.normalization_record = []
        self._eps_record = []  # per-experiment expparams (rejuvenation)
        self._n_record = 0     # rejuvenation record length (compress
                               # mode stores no per-experiment dicts)
        # compressed rejuvenation record: host-side dedupe of experiments
        # into a candidate pool with per-candidate success/trial totals
        self._pool_index = {}   # eps bytes -> pool row
        self._pool_eps = []     # single-experiment two-outcome expparams
        self._pool_succ = []
        self._pool_trials = []
        # adaptive-kernel state: Robbins-Monro-adapted log step size and
        # sweep counter (persist across updates; checkpointed)
        self._mcmc_log_scale = float(self._mcmc_log_scale0)
        self._mcmc_adapt_t = 0
        self.mcmc_acceptance_record = []
        self.resampling_divergences = [] if self.track_resampling_divergence else None

    def _shard_state(self, state):
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = self.sharding.mesh
        axis = self.sharding.spec[0]
        repl = NamedSharding(mesh, P())
        return SMCState(
            weights=jax.device_put(state.weights, self.sharding),
            locations=jax.device_put(
                state.locations, NamedSharding(mesh, P(axis, None))),
            key=jax.device_put(state.key, repl),
            resample_count=jax.device_put(state.resample_count, repl),
            just_resampled=jax.device_put(state.just_resampled, repl),
            log_total_likelihood=jax.device_put(
                state.log_total_likelihood, repl),
            min_n_ess=jax.device_put(state.min_n_ess, repl),
            zero_weight_count=jax.device_put(state.zero_weight_count, repl),
            resampler_fallback_count=jax.device_put(
                state.resampler_fallback_count, repl),
        )

    @property
    def state(self):
        """The current :class:`SMCState` pytree (checkpointable)."""
        return self._state

    @state.setter
    def state(self, new_state):
        self._state = new_state

    @property
    def particle_weights(self):
        return self._state.weights

    @property
    def particle_locations(self):
        return self._state.locations

    @property
    def n_particles(self):
        return self._n_particles

    @property
    def n_ess(self):
        """Effective sample size 1/Σw². Reference parity: ``SMCUpdater.n_ess``."""
        w = self._state.weights
        return float(1.0 / jnp.sum(w * w))

    @property
    def min_n_ess(self):
        return float(self._state.min_n_ess)

    @property
    def resample_count(self):
        return int(self._state.resample_count)

    @property
    def just_resampled(self):
        return bool(self._state.just_resampled)

    @property
    def resampler_fallback_count(self):
        """Total number of particle slots (over the whole run) where the
        bounded validity-redraw loop exhausted its budget and the slot fell
        back to its ancestor's location. Host-readable diagnostic for the
        reference's ``ResamplerWarning`` path (``src/qinfer/resamplers.py::
        ResamplerWarning``); nonzero deltas also emit the warning."""
        return int(self._state.resampler_fallback_count)

    @property
    def log_total_likelihood(self):
        """Log model evidence Σ log Pr(d_k | d_<k) — the model-selection
        statistic. Reference parity: ``smc.py::SMCUpdater.log_total_likelihood``."""
        return float(self._state.log_total_likelihood)

    @property
    def total_likelihood(self):
        return float(jnp.exp(self._state.log_total_likelihood))

    # -- core updates ------------------------------------------------------

    def _design_key(self):
        """Fresh PRNG key for Monte-Carlo likelihoods inside the jitted
        design scorers (``wants_likelihood_key`` models, e.g. ALE).
        Derived from — but not consuming — the engine key via a host-side
        call counter, so every bayes_risk / information-gain / hypothetical
        call sees new simulation noise instead of one realization frozen
        into the compiled executable. None for analytic likelihoods."""
        if not getattr(self.model, "wants_likelihood_key", False):
            return None
        self._design_calls = getattr(self, "_design_calls", 0) + 1
        return jax.random.fold_in(self._state.key, self._design_calls)

    def hypothetical_update(self, outcomes, expparams,
                            return_likelihood=False,
                            return_normalization=False):
        """Posterior weights that *would* result from each (outcome,
        experiment) pair, without committing.

        Reference parity: ``smc.py::SMCUpdater.hypothetical_update`` —
        returns weights of shape ``(n_outcomes, n_expparams, n_particles)``,
        optionally with the likelihood array and normalizations.
        """
        eps = self.model.canonicalize_expparams(expparams)
        outcomes = jnp.atleast_1d(outcomes)
        self.model._bump("_call_count", int(outcomes.shape[0])
                         * self.n_particles * n_expparams(eps))
        norm_w, L, norms = _hypothetical_update(
            self.model, self._state.weights, self._state.locations,
            outcomes, eps, key=self._design_key())
        out = (norm_w,)
        if return_likelihood:
            out = out + (L,)
        if return_normalization:
            out = out + (norms,)
        return out[0] if len(out) == 1 else out

    def update(self, outcome, expparams, check_for_resample=True):
        """Condition the posterior on one observed outcome.

        Reference parity: ``smc.py::SMCUpdater.update`` (including the
        zero-weight policy and the ESS-triggered resample check).
        """
        eps = self.model.canonicalize_expparams(expparams)
        if n_expparams(eps) != 1:
            eps = expparams_at(eps, 0)
        outcome_arr = _lift_outcome(self.model, jnp.asarray(outcome))
        # Host-side models (e.g. DirectViewParallelizedModel dispatching to
        # an engine pool) cannot be traced; run the step eagerly for them.
        step_fn = (_update_step_eager
                   if getattr(self.model, "host_only", False)
                   else _update_step)
        # reference-parity call counter: one likelihood evaluation per
        # (outcome=1, particle, experiment=1) — counted host-side, since
        # device code cannot mutate Python state
        self.model._bump("_call_count", self.n_particles)
        prev_state = self._state
        new_state, log_norm, was_zero = step_fn(
            self.model, self.resampler, self._state, outcome_arr, eps,
            self.resample_thresh, self.zero_weight_thresh,
            check_resample=(bool(check_for_resample)
                            and self.waste_free_stages == 0))
        if bool(was_zero):
            self._handle_zero_weight()
        self._commit_step(outcome, eps, prev_state, new_state, log_norm,
                          check_for_resample=bool(check_for_resample))

    def _commit_step(self, outcome, eps, prev_state, new_state, log_norm,
                     check_for_resample=True):
        """Shared host-side tail of a committed sequential update: warnings,
        diagnostics, records (the step evidence is reported in log space —
        stable for models with underflowing likelihoods — and recorded
        linear in float64), and post-resample MCMC rejuvenation.

        ``check_for_resample`` gates the waste-free trigger exactly like
        the step's own resample check: a caller suppressing resampling
        (``update(..., check_for_resample=False)``) must not receive a
        waste-free resample-move either — reference parity with
        ``SMCUpdater.update``'s semantics (the non-waste-free path gets
        this for free because ``just_resampled`` can only be set by the
        step's gated resample)."""
        self._warn_resampler_fallback(
            int(new_state.resampler_fallback_count)
            - int(prev_state.resampler_fallback_count))
        self._state = new_state
        if bool(new_state.just_resampled):
            self._on_resample_diagnostics(prev_state, new_state)
        self.data_record.append(np.asarray(outcome))
        self.normalization_record.append(
            float(np.exp(np.float64(log_norm))))
        if self._rejuvenating:
            self._n_record += 1
            if self.compress_mcmc_record:
                # compressed mode keeps only the sufficient statistics —
                # storing every expparams dict would defeat the memory
                # side of record compression at long horizons
                self._accumulate_record(outcome, eps)
            else:
                self._eps_record.append(eps)
            if self.waste_free_stages > 0:
                if check_for_resample:
                    ess = float(1.0 / jnp.sum(new_state.weights ** 2))
                    if ess <= self.resample_thresh * self._n_particles:
                        self._waste_free_now()
            elif bool(new_state.just_resampled):
                self._rejuvenate_now()

    def _replay_update(self, outcome, eps, check_resample, resample_gate):
        """One sequential update that consumes PRNG keys exactly like a
        ``batch_update`` scan step: the resample key split always happens
        when the scan's does (``check_resample=True``), with the interval
        predicate passed as the traced gate. Used by the zero-weight
        ``'error'`` replay so the scanned batch and the eager replay walk
        the SAME key stream and the detected event reproduces
        deterministically. Raises (via ``_handle_zero_weight``) BEFORE
        committing the failing step, leaving the good prefix committed."""
        outcome_arr = _lift_outcome(self.model, jnp.asarray(outcome))
        self.model._bump("_call_count", self.n_particles)
        prev_state = self._state
        new_state, log_norm, was_zero = _update_step(
            self.model, self.resampler, self._state, outcome_arr, eps,
            self.resample_thresh, self.zero_weight_thresh,
            check_resample=bool(check_resample),
            resample_gate=(jnp.asarray(bool(resample_gate))
                           if check_resample else None))
        if bool(was_zero):
            self._handle_zero_weight()
        self._commit_step(outcome, eps, prev_state, new_state, log_norm)

    def batch_update(self, outcomes, expparams, resample_interval=5):
        """Condition on a whole record of (outcome, experiment) pairs in one
        on-device ``lax.scan``.

        Reference parity: ``smc.py::SMCUpdater.batch_update``.
        """
        eps = self.model.canonicalize_expparams(expparams)
        outcomes = jnp.atleast_1d(jnp.asarray(outcomes))
        if getattr(self.model, "host_only", False):
            # eager per-step loop for untraceable host-side models
            norms = []
            for i in range(outcomes.shape[0]):
                self.update(outcomes[i], expparams_at(eps, i),
                            check_for_resample=(i % max(resample_interval, 1)
                                                == resample_interval - 1))
            return jnp.asarray(self.normalization_record[-outcomes.shape[0]:])
        self.model._bump("_call_count",
                         int(outcomes.shape[0]) * self.n_particles)
        move_kwargs = {}
        if self._rejuvenating and self.compress_mcmc_record:
            # Dedupe this batch's experiments into the candidate pool
            # host-side (they are concrete here), then let the scan carry
            # the success/trial totals: per-step pool indices + increments
            # ride as scan inputs, so the in-scan rejuvenation sees exactly
            # the statistics of everything observed so far.
            n_batch = int(outcomes.shape[0])
            # snapshot the pool so a zero-weight 'error' replay can roll
            # back rows registered for never-committed experiments
            # (phantom zero-total rows are harmless to the likelihood but
            # would permanently inflate E and every later pool pass)
            pool_snapshot = len(self._pool_eps)
            # hoist ALL device→host transfers out of the dedupe loop:
            # one sync per array instead of O(n_batch × n_fields)
            outs_host = np.asarray(outcomes).reshape(n_batch, -1)[:, 0]
            eps_host = {k: np.asarray(v) for k, v in eps.items()}
            idx_rows, s_inc, t_inc = [], [], []
            for i in range(n_batch):
                eps_i = {k: v[i:i + 1] for k, v in eps_host.items()}
                row, si, ti = self._pool_row_and_increment(
                    outs_host[i], eps_i)
                idx_rows.append(row)
                s_inc.append(si)
                t_inc.append(ti)
            pool_eps, succ0, trials0 = self._pool_arrays()
            move_kwargs = dict(
                prior=self.prior, sufficient=True, pool_eps=pool_eps,
                pool_idx=jnp.asarray(idx_rows, jnp.int32),
                succ0=succ0, trials0=trials0,
                succ_inc=jnp.asarray(np.asarray(s_inc, np.int64)
                                     .astype(np.int32)),
                trials_inc=jnp.asarray(np.asarray(t_inc, np.int64)
                                       .astype(np.int32)),
                n_mcmc_moves=self.n_mcmc_moves,
                proposal_scale=self.mcmc_proposal_scale,
                mcmc_canonicalize=self.mcmc_canonicalize,
                waste_free_stages=self.waste_free_stages,
                waste_free_kernel=self.waste_free_kernel,
                waste_free_lw_seed=self.waste_free_lw_seed,
                waste_free_beta=jnp.float32(self.waste_free_beta),
                **self._adaptive_kwargs())
        elif self.n_mcmc_moves > 0:
            n_past = len(self._eps_record)
            if n_past:
                p_outs, p_eps = self._record_arrays()
                rec_outcomes = jnp.concatenate(
                    [p_outs.astype(outcomes.dtype), outcomes])
                rec_eps = {k: jnp.concatenate([p_eps[k], eps[k]])
                           for k in eps}
            else:
                rec_outcomes, rec_eps = outcomes, eps
            # pad the record buffer to a power of two (masked rows are
            # never exposed) so repeated batch_update calls key the jit
            # cache on O(log T) distinct shapes, not every record length
            total = int(rec_outcomes.shape[0])
            cap = max(8, 1 << (total - 1).bit_length())
            if cap != total:
                rec_outcomes = jnp.concatenate(
                    [rec_outcomes,
                     jnp.zeros((cap - total,), rec_outcomes.dtype)])
                rec_eps = {k: jnp.concatenate(
                    [v, jnp.zeros((cap - total,) + v.shape[1:], v.dtype)])
                    for k, v in rec_eps.items()}
            move_kwargs = dict(
                prior=self.prior, rec_outcomes=rec_outcomes,
                rec_eps=rec_eps, n_past=jnp.asarray(n_past, jnp.int32),
                n_mcmc_moves=self.n_mcmc_moves,
                proposal_scale=self.mcmc_proposal_scale,
                mcmc_canonicalize=self.mcmc_canonicalize,
                **self._adaptive_kwargs())
        ret = _batch_update(
            self.model, self.resampler, self._state, outcomes, eps,
            self.resample_thresh, self.zero_weight_thresh,
            resample_interval=int(resample_interval), **move_kwargs)
        if move_kwargs.get("use_adaptive", False):
            # the adapted Robbins-Monro state commits only with the batch:
            # the zero-weight 'error' replay below re-runs the sequential
            # path from the PRE-batch state and re-adapts step by step
            new_state, log_norms, adapted_ls, adapted_t = ret
        else:
            new_state, log_norms = ret
            adapted_ls = adapted_t = None
        zero_events = int(new_state.zero_weight_count) - int(
            self._state.zero_weight_count)
        if zero_events > 0 and self.zero_weight_policy == "error":
            # Sequential-API semantics: commit every update BEFORE the
            # failing one and leave the updater at the failure point
            # (discarding the whole batch would lose the good prefix and
            # hand a caller who catches ZeroWeightError the prior).
            # The replay consumes PRNG keys IDENTICALLY to the scanned
            # batch — check_resample=True with the interval predicate as
            # the traced gate, exactly like the scan body — so the zero
            # event deterministically reproduces at the same step and
            # raises there (a plain update(check_for_resample=False)
            # would skip the scan's per-step resample key split and
            # silently diverge). The batch call-count bump above is
            # rewound first; the per-step replay re-counts it.
            self.model._bump("_call_count",
                             -int(outcomes.shape[0]) * self.n_particles)
            if self._rejuvenating and self.compress_mcmc_record:
                # roll the candidate pool back to its pre-batch state:
                # the replay re-registers (and commits) rows only for the
                # experiments that actually commit before the raise
                self._pool_eps = self._pool_eps[:pool_snapshot]
                self._pool_succ = self._pool_succ[:pool_snapshot]
                self._pool_trials = self._pool_trials[:pool_snapshot]
                self._pool_index = {
                    kb: i for kb, i in self._pool_index.items()
                    if i < pool_snapshot}
            n_batch = int(outcomes.shape[0])
            check_now = resample_interval > 0
            interval = max(int(resample_interval), 1)
            for i in range(n_batch):
                self._replay_update(
                    outcomes[i], expparams_at(eps, i),
                    check_resample=check_now,
                    resample_gate=(i % interval == interval - 1))
            # The scan detected a zero event but the key-faithful replay —
            # a DIFFERENT XLA program whose reductions can differ by ulps —
            # did not reproduce it at any step (possible when a norm or
            # resample decision sits exactly on a float boundary). The
            # detection stands: honor the 'error' contract, with the whole
            # replayed batch committed and a note that the failing step
            # could not be localized.
            warnings.warn(
                "batch_update detected a zero-weight event but the "
                "key-faithful replay did not reproduce it at any single "
                "step (float-boundary divergence between the scanned and "
                "eager programs); the full batch was committed",
                ZeroWeightWarning)
            self._handle_zero_weight()
        if zero_events > 0:
            self._handle_zero_weight()
        if adapted_ls is not None:
            self._mcmc_log_scale = float(adapted_ls)
            self._mcmc_adapt_t = int(adapted_t)
        self._warn_resampler_fallback(
            int(new_state.resampler_fallback_count)
            - int(self._state.resampler_fallback_count))
        self._state = new_state
        norms = np.exp(np.asarray(log_norms, dtype=np.float64))
        self.data_record.extend(np.asarray(outcomes).tolist())
        self.normalization_record.extend(norms.tolist())
        if self._rejuvenating:
            self._n_record += int(outcomes.shape[0])
            if not self.compress_mcmc_record:
                for i in range(int(outcomes.shape[0])):
                    self._eps_record.append(expparams_at(eps, i))
            if self.compress_mcmc_record:
                # commit this batch's sufficient-statistic increments
                # (pool rows were created before the scan; totals only
                # commit with the batch, so a raised replay never
                # double-counts)
                idx_rows = np.asarray(move_kwargs["pool_idx"])
                s_inc = np.asarray(move_kwargs["succ_inc"])
                t_inc = np.asarray(move_kwargs["trials_inc"])
                for row, si, ti in zip(idx_rows, s_inc, t_inc):
                    self._pool_succ[int(row)] += float(si)
                    self._pool_trials[int(row)] += float(ti)
        return jnp.asarray(norms)

    def _on_resample_diagnostics(self, prev_state, new_state):
        """Opt-in resampling diagnostics.

        Reference parity: ``SMCUpdater(debug_resampling=...)`` logging and
        ``track_resampling_divergence`` (the reference records the KL
        divergence introduced by each resample). Host-side and opt-in:
        the jitted step is unaffected when both flags are off.
        """
        if self.track_resampling_divergence:
            post = SMCUpdater.__new__(SMCUpdater)
            post._state = new_state
            post._n_particles = self._n_particles
            pre = SMCUpdater.__new__(SMCUpdater)
            pre._state = prev_state
            pre._n_particles = self._n_particles
            div = float(SMCUpdater.est_kl_divergence(pre, post))
            self.resampling_divergences.append(div)
        if self.debug_resampling:
            import logging

            logging.getLogger(__name__).debug(
                "resample #%d: n_ess %.1f -> %.1f",
                int(new_state.resample_count),
                float(1.0 / jnp.sum(prev_state.weights ** 2)),
                float(1.0 / jnp.sum(new_state.weights ** 2)))

    def _warn_resampler_fallback(self, n_slots):
        """Reference parity: ``resamplers.py::ResamplerWarning`` — the
        reference warns when its rejection loop exhausts ``maxiter``; here
        the equivalent event is bounded-redraw slots falling back to their
        ancestors, counted on-device and surfaced once per update call."""
        if n_slots > 0:
            from ._exceptions import ResamplerWarning

            warnings.warn(
                f"resampler validity redraw exhausted its budget for "
                f"{n_slots} particle slot(s); those slots kept their "
                f"ancestors' (valid) locations", ResamplerWarning)

    def _handle_zero_weight(self):
        msg = ("all particle weights are numerically zero; the observed "
               "outcome is inconsistent with every particle")
        if self.zero_weight_policy == "error":
            raise ZeroWeightError(msg)
        elif self.zero_weight_policy == "warn":
            warnings.warn(msg + " — weights were reset", ZeroWeightWarning)
        # 'reset' policy: the jitted step already substituted uniform weights.

    def resample(self):
        """Force an immediate resample.

        Reference parity: ``smc.py::SMCUpdater.resample``.
        """
        st = self._state
        key, sub = jax.random.split(st.key)
        new_w, new_x, n_fallback = self.resampler.call_with_diagnostics(
            self.model, sub, st.weights, st.locations)
        # projection invariant (round 5): a validity-tolerant resampler
        # relies on the move block's strict projection — when no move
        # will actually run (no moves configured, empty record, or the
        # move projection disabled), this manual resample must project
        # itself or the ensemble is left in the psd_tol shell
        moves_will_project = (
            self.n_mcmc_moves > 0 and self.mcmc_canonicalize
            and (self._n_record if self.compress_mcmc_record
                 else len(self._eps_record)) > 0)
        if (not getattr(self.resampler, "canonicalize", True)
                and not moves_will_project):
            new_x = self.model.canonicalize(new_x)
        self._warn_resampler_fallback(int(n_fallback))
        self._state = st._replace(
            weights=new_w, locations=new_x, key=key,
            resample_count=st.resample_count + 1,
            just_resampled=jnp.asarray(True),
            resampler_fallback_count=(st.resampler_fallback_count
                                      + n_fallback))
        if self.n_mcmc_moves > 0:
            self._rejuvenate_now()

    # -- resample-move rejuvenation (qinfer_tpu.rejuvenation) ---------------

    def _adaptive_kwargs(self):
        """Adaptive-kernel kwargs for ``_batch_update``: empty when the
        legacy fixed-scale path is active (so existing jit cache keys are
        untouched); otherwise the method/adapt statics plus the current
        Robbins-Monro state to thread through the scan carry."""
        if not self._use_adaptive_kernel:
            return {}
        return dict(use_adaptive=True, mcmc_method=self.mcmc_method,
                    mcmc_adapt=self.mcmc_adapt,
                    target_accept=jnp.float32(self.mcmc_target_accept),
                    log_scale0=jnp.float32(self._mcmc_log_scale),
                    adapt_t0=jnp.int32(self._mcmc_adapt_t))

    def _record_arrays(self):
        """The experiment record as stacked device buffers:
        ``(outcomes (T, ...), eps pytree with leading axis T)``."""
        nd = int(getattr(self.model, "outcome_ndim", 0))
        if nd == 0:
            outs = jnp.asarray(
                [np.asarray(o).ravel()[0] for o in self.data_record])
        else:
            outs = jnp.stack([
                jnp.asarray(o).reshape(np.asarray(o).shape[-nd:])
                for o in self.data_record])
        eps_rec = {
            k: jnp.concatenate([e[k] for e in self._eps_record], axis=0)
            for k in self._eps_record[0]
        }
        return outs, eps_rec

    def _pool_row_and_increment(self, outcome_val, eps_np):
        """The ONE place the sufficient-statistic conventions live
        (success := underlying outcome 0, the ``BinomialModel``
        convention; Bernoulli bits are n=1 binomials; ``n_meas`` rides in
        the trial totals, not the pool identity). Takes HOST numpy values
        — callers hoist any device→host conversion — creates the pool row
        if new, and returns ``(row, success_inc, trial_inc)`` WITHOUT
        touching the totals (batch callers commit increments only when
        the whole batch commits)."""
        eps_np = dict(eps_np)
        n_meas = 1
        if self._record_is_binomial:
            n_meas = int(eps_np.pop("n_meas").ravel()[0])
        key_bytes = b"\x00".join(
            k.encode() + b"=" + np.ascontiguousarray(eps_np[k]).tobytes()
            for k in sorted(eps_np))
        row = self._pool_index.get(key_bytes)
        if row is None:
            row = len(self._pool_eps)
            self._pool_index[key_bytes] = row
            self._pool_eps.append(eps_np)
            self._pool_succ.append(0.0)
            self._pool_trials.append(0.0)
        o = float(outcome_val)
        s_inc = o if self._record_is_binomial else (1.0 if o == 0 else 0.0)
        return row, s_inc, float(n_meas)

    def _accumulate_record(self, outcome, eps):
        """Fold one committed (outcome, experiment) into the per-candidate
        sufficient statistics."""
        eps_np = {k: np.asarray(v) for k, v in eps.items()}
        row, s_inc, t_inc = self._pool_row_and_increment(
            np.asarray(outcome).ravel()[0], eps_np)
        self._pool_succ[row] += s_inc
        self._pool_trials[row] += t_inc

    def _pool_arrays(self):
        """The compressed record as device buffers, padded to a power of
        two over candidates (padding rows repeat row 0 with zero trials —
        they contribute exactly 0 to the record log-likelihood).

        Totals ride as int32, not float32: f32 stops accumulating at 2^24
        (~1.7e7 trials per candidate, reachable with large ``n_meas`` over
        long horizons on a small pool) while int32 is exact to 2^31; the
        likelihood contraction casts at use
        (:func:`~qinfer_tpu.rejuvenation.binomial_record_log_likelihood`).
        Host-side totals are Python floats (exact to 2^53) — the guard
        below fires long before EITHER representation could saturate."""
        E = len(self._pool_eps)
        Ep = max(8, 1 << (E - 1).bit_length()) if E > 1 else 8
        pad = Ep - E
        pool_eps = {
            k: jnp.asarray(np.concatenate(
                [np.concatenate([np.atleast_1d(e[k]) for e in
                                 self._pool_eps], axis=0)]
                + ([np.repeat(np.atleast_1d(self._pool_eps[0][k]), pad,
                              axis=0)] if pad else []), axis=0))
            for k in self._pool_eps[0]
        }
        trials_host = np.asarray(self._pool_trials, np.float64)
        if trials_host.size and float(trials_host.max()) > 2.0 ** 30:
            raise OverflowError(
                "per-candidate trial totals exceed 2^30; the int32 "
                "device representation of the compressed rejuvenation "
                "record would overflow (split the record across "
                "candidates or disable compress_mcmc_record)")
        succ = jnp.asarray(np.pad(np.asarray(self._pool_succ,
                                             np.int64), (0, pad))
                           .astype(np.int32))
        trials = jnp.asarray(np.pad(trials_host.astype(np.int64),
                                    (0, pad)).astype(np.int32))
        return pool_eps, succ, trials

    def _waste_free_now(self):
        """Waste-free resample-move (sequential-API path): REPLACES the
        Liu-West resample — n/P ancestors, every state of a (P−1)-step
        chain kept (:func:`qinfer_tpu.rejuvenation.
        waste_free_rejuvenate_binomial`)."""
        if self._n_record == 0:
            return
        from .rejuvenation import waste_free_rejuvenate_binomial_jit

        pool_eps, succ, trials = self._pool_arrays()
        st = self._state
        key, sub = jax.random.split(st.key)
        w, x, _ = waste_free_rejuvenate_binomial_jit(
            self.model, self.prior, sub, st.weights, st.locations,
            succ, trials, pool_eps, n_stages=self.waste_free_stages,
            proposal_scale=self.mcmc_proposal_scale,
            canonicalize=self.mcmc_canonicalize,
            kernel=self.waste_free_kernel,
            lw_seed_a=self.waste_free_lw_seed,
            beta=self.waste_free_beta)
        self._state = st._replace(
            weights=w, locations=x, key=key,
            just_resampled=jnp.asarray(True),
            resample_count=st.resample_count + 1)
        # a waste-free kernel IS the engine's resample event: feed the
        # same opt-in diagnostics (KL tracking / debug logging) the
        # Liu-West path gets from _commit_step
        self._on_resample_diagnostics(st, self._state)

    def _rejuvenate_now(self):
        """Apply ``n_mcmc_moves`` Metropolis moves targeting
        prior × record-likelihood (sequential-API path; the scanned paths
        inline the same kernel). The record is padded to the next power of
        two so the jitted kernel retraces O(log T) times, not per step."""
        T = (self._n_record if self.compress_mcmc_record
             else len(self._eps_record))
        if T == 0:
            return
        if self.compress_mcmc_record:
            pool_eps, succ, trials = self._pool_arrays()
            st = self._state
            key, sub = jax.random.split(st.key)
            if self._use_adaptive_kernel:
                from .rejuvenation import \
                    mcmc_rejuvenate_binomial_adaptive_jit

                x, acc, ls, t = mcmc_rejuvenate_binomial_adaptive_jit(
                    self.model, self.prior, sub, st.locations, succ,
                    trials, pool_eps, n_moves=self.n_mcmc_moves,
                    log_scale=self._mcmc_log_scale,
                    adapt_t=self._mcmc_adapt_t,
                    method=self.mcmc_method,
                    target_accept=self.mcmc_target_accept,
                    canonicalize=self.mcmc_canonicalize,
                    adapt=self.mcmc_adapt)
                self._mcmc_log_scale = float(ls)
                self._mcmc_adapt_t = int(t)
                self.mcmc_acceptance_record.append(float(acc))
            else:
                from .rejuvenation import mcmc_rejuvenate_binomial_jit

                x, acc = mcmc_rejuvenate_binomial_jit(
                    self.model, self.prior, sub, st.locations, succ,
                    trials, pool_eps, n_moves=self.n_mcmc_moves,
                    proposal_scale=self.mcmc_proposal_scale,
                    canonicalize=self.mcmc_canonicalize)
                self.mcmc_acceptance_record.append(float(acc))
            self._state = st._replace(locations=x, key=key)
            return
        from .rejuvenation import mcmc_rejuvenate_jit

        outs, eps_rec = self._record_arrays()
        Tp = 1 << (T - 1).bit_length() if T > 1 else 1
        if Tp != T:
            pad = Tp - T
            outs = jnp.concatenate(
                [outs, jnp.repeat(outs[-1:], pad, axis=0)])
            eps_rec = {k: jnp.concatenate(
                [v, jnp.repeat(v[-1:], pad, axis=0)])
                for k, v in eps_rec.items()}
        mask = jnp.arange(Tp) < T
        st = self._state
        key, sub = jax.random.split(st.key)
        if self._use_adaptive_kernel:
            from .rejuvenation import mcmc_rejuvenate_adaptive_jit

            x, acc, ls, t = mcmc_rejuvenate_adaptive_jit(
                self.model, self.prior, sub, st.locations, outs, eps_rec,
                mask, n_moves=self.n_mcmc_moves,
                log_scale=self._mcmc_log_scale,
                adapt_t=self._mcmc_adapt_t, method=self.mcmc_method,
                target_accept=self.mcmc_target_accept,
                canonicalize=self.mcmc_canonicalize,
                adapt=self.mcmc_adapt)
            self._mcmc_log_scale = float(ls)
            self._mcmc_adapt_t = int(t)
            self.mcmc_acceptance_record.append(float(acc))
        else:
            x, acc = mcmc_rejuvenate_jit(
                self.model, self.prior, sub, st.locations, outs, eps_rec,
                mask, n_moves=self.n_mcmc_moves,
                proposal_scale=self.mcmc_proposal_scale,
                canonicalize=self.mcmc_canonicalize)
            self.mcmc_acceptance_record.append(float(acc))
        self._state = st._replace(locations=x, key=key)

    # -- estimators --------------------------------------------------------

    def est_mean(self):
        """Posterior mean. Reference parity: ``SMCUpdater.est_mean``
        (one jitted dispatch)."""
        return _weighted_mean(self._state.weights, self._state.locations)

    def est_meanfn(self, fn):
        """Posterior mean of an arbitrary function of the parameters.

        Reference parity: ``SMCUpdater.est_meanfn`` (vmapped on-device).
        """
        from .utils import particle_meanfn

        return particle_meanfn(
            self._state.weights, self._state.locations, fn)

    def est_covariance_mtx(self, corr=False):
        """Posterior covariance (or correlation) matrix.

        Reference parity: ``SMCUpdater.est_covariance_mtx(corr=...)``.
        """
        cov = particle_covariance_mtx(
            self._state.weights, self._state.locations)
        if corr:
            std = jnp.sqrt(jnp.clip(jnp.diag(cov), EPS, None))
            cov = cov / std[:, None] / std[None, :]
        return cov

    def est_entropy(self):
        """Entropy −Σ wᵢ log wᵢ of the particle weights.

        Reference parity: ``SMCUpdater.est_entropy``.
        """
        return _entropy(self._state.weights)

    def est_kl_divergence(self, other, kernel_bandwidth=None):
        """KL divergence D(self ‖ other) between two particle posteriors,
        via Gaussian kernel density smoothing of the *other* cloud.

        Reference parity: ``smc.py::SMCUpdater.est_kl_divergence`` (the
        reference's KDE-based estimator; same role, vectorized on device).
        """
        w_p = self._state.weights
        x_p = self._state.locations
        w_q = other._state.weights
        x_q = other._state.locations
        d = x_p.shape[1]
        if kernel_bandwidth is None:
            # Silverman-style bandwidth from the other cloud's covariance
            cov_q = particle_covariance_mtx(w_q, x_q)
            h2 = jnp.clip(jnp.trace(cov_q) / d, EPS, None) * (
                other.n_particles ** (-2.0 / (d + 4)))
        else:
            h2 = kernel_bandwidth ** 2

        def log_kde(pts, w_ref, x_ref):
            # log Σ_j w_j N(pts; x_j, h² I), evaluated blockwise over the
            # points axis: the full (n_p × n_ref) distance matrix is O(n²)
            # memory (~17 TB at 2²¹-particle ensembles); blocks keep the
            # working set bounded while the reduction stays exact.
            log_w = jnp.log(jnp.clip(w_ref, EPS, None))
            log_const = -0.5 * d * jnp.log(2 * jnp.pi * h2)

            def block_lse(block):
                d2 = jnp.sum(
                    (block[:, None, :] - x_ref[None, :, :]) ** 2, axis=-1)
                return jax.scipy.special.logsumexp(
                    -0.5 * d2 / h2 + log_w[None, :], axis=1) + log_const

            n_pts = pts.shape[0]
            n_ref = x_ref.shape[0]
            # the broadcast difference materializes (block, n_ref, d)
            # before the axis=-1 sum, so the element budget must include d
            block = max(1, min(
                n_pts, (1 << 22) // max(n_ref * pts.shape[1], 1)))
            if n_pts % block:  # pad; padded rows are discarded below
                pad = block - n_pts % block
                pts = jnp.concatenate([pts, pts[:1].repeat(pad, axis=0)])
            out = jax.lax.map(
                block_lse, pts.reshape(-1, block, pts.shape[1]))
            return out.reshape(-1)[:n_pts]

        log_p = log_kde(x_p, w_p, x_p)
        log_q = log_kde(x_p, w_q, x_q)
        return jnp.sum(w_p * (log_p - log_q))

    def sample(self, n=1, key=None):
        """Draw ``n`` particles from the posterior (∝ weights).

        Reference parity: ``SMCUpdater.sample``.
        """
        st = self._state
        if key is None:
            key, sub = jax.random.split(st.key)
            self._state = st._replace(key=key)
        else:
            sub = key
        idx = jax.random.categorical(
            sub, jnp.log(jnp.clip(st.weights, EPS, None)), shape=(n,))
        return st.locations[idx]

    def posterior_distribution(self):
        """The current posterior as a
        :class:`~qinfer_tpu.distributions.ParticleDistribution` — the
        warm-start / checkpoint-resume hook (SURVEY.md §5)."""
        from .distributions import ParticleDistribution

        return ParticleDistribution(
            self._state.locations, self._state.weights)

    # -- cluster estimators (host-side sklearn, like the reference) --------

    def est_cluster_moments(self, cluster_opts=None):
        """Weighted (mean, cov) per DBSCAN cluster of the particle cloud.

        Reference parity: ``smc.py::SMCUpdater.est_cluster_moments`` (uses
        ``clustering.py::particle_clusters``). Yields
        ``(label, weight_mass, mean, cov)``.
        """
        from .clustering import particle_clusters

        w = np.asarray(self._state.weights)
        x = np.asarray(self._state.locations)
        cluster_opts = cluster_opts or {}
        for label, mask in particle_clusters(x, w, **cluster_opts):
            cw = w[mask]
            mass = cw.sum()
            if mass <= 0:
                continue
            cw = cw / mass
            mu, cov = weighted_moments(jnp.asarray(cw), jnp.asarray(x[mask]))
            yield label, float(mass), np.asarray(mu), np.asarray(cov)

    def est_cluster_covs(self, cluster_opts=None):
        """Per-cluster covariances. Reference parity:
        ``SMCUpdater.est_cluster_covs``."""
        for label, mass, mu, cov in self.est_cluster_moments(cluster_opts):
            yield label, mass, cov

    def est_cluster_metrics(self, cluster_opts=None):
        """Summary metrics over the clustering: ``n_noise`` is the NUMBER
        of noise-labeled particles (not a 0/1 indicator), and zero-mass
        clusters still count. Reference parity:
        ``SMCUpdater.est_cluster_metrics``."""
        from .clustering import NO_CLUSTER, particle_clusters

        w = np.asarray(self._state.weights)
        x = np.asarray(self._state.locations)
        n_clusters = 0
        n_noise = 0
        weight_in = 0.0
        for label, mask in particle_clusters(x, w, **(cluster_opts or {})):
            if label == NO_CLUSTER:
                n_noise += int(mask.sum())
            else:
                n_clusters += 1
                weight_in += float(w[mask].sum())
        return {
            "n_clusters": n_clusters,
            "n_noise": n_noise,
            "weight_in_clusters": weight_in,
        }

    # -- adaptivity scores -------------------------------------------------

    def _outcome_grid(self, eps):
        outcomes = self.model.outcomes(eps)
        mask = self.model.outcome_mask(eps).astype(self._state.weights.dtype)
        return outcomes, mask

    def _score_candidates(self, score_fn, expparams, extra_args,
                          candidate_chunk):
        """Shared driver of the batched design scorers, optionally chunked
        over the candidate axis: the likelihood table is
        ``(n_out, n_particles, n_cand)``, so at production scale (10M
        particles × 1024 candidates) an unchunked call would materialize
        tens of GB — ``candidate_chunk`` bounds peak memory at
        ``n_out · n · chunk`` while every chunk stays one fused
        contraction."""
        eps = self.model.canonicalize_expparams(expparams)
        outcomes, mask = self._outcome_grid(eps)
        n_e = n_expparams(eps)
        self.model._bump("_call_count", int(outcomes.shape[0])
                         * self.n_particles * n_e)
        key = self._design_key()
        w, x = self._state.weights, self._state.locations
        if candidate_chunk is None or n_e <= candidate_chunk:
            return score_fn(self.model, w, x, outcomes, mask, eps,
                            *extra_args, key=key)
        c = int(candidate_chunk)
        n_pad = (-n_e) % c
        eps_p = jax.tree_util.tree_map(
            lambda a: jnp.concatenate(
                [a, jnp.repeat(a[-1:], n_pad, axis=0)]) if n_pad else a,
            eps)
        eps_chunks = jax.tree_util.tree_map(
            lambda a: a.reshape((-1, c) + a.shape[1:]), eps_p)
        # the outcome grid/mask may be candidate-dependent (padded
        # binomial counts) — the grid's shape is chunk-invariant (take
        # chunk 0's), but the MASK is rebuilt per chunk inside the map
        out_c, _ = self._outcome_grid(
            jax.tree_util.tree_map(lambda a: a[0], eps_chunks))
        scores = jax.lax.map(
            lambda ec: score_fn(self.model, w, x, out_c,
                                self.model.outcome_mask(ec).astype(w.dtype),
                                ec, *extra_args, key=key),
            eps_chunks)
        return scores.reshape(-1)[:n_e]

    def bayes_risk(self, expparams, candidate_chunk=None):
        """Expected posterior Q-loss for each candidate experiment.

        Reference parity: ``smc.py::SMCUpdater.bayes_risk`` (vectorized over
        the candidate batch instead of being called per-candidate inside a
        scipy optimizer). ``candidate_chunk`` bounds peak memory for large
        candidate grids (see :meth:`_score_candidates`).
        """
        return self._score_candidates(
            _bayes_risk, expparams, (self.model.Q,), candidate_chunk)

    def expected_information_gain(self, expparams, candidate_chunk=None):
        """Expected information gain (mutual information, nats) for each
        candidate experiment.

        Reference parity: ``smc.py::SMCUpdater.expected_information_gain``.
        """
        return self._score_candidates(
            _expected_information_gain, expparams, (), candidate_chunk)

    # -- region estimation -------------------------------------------------

    def est_credible_region(self, level=0.95, return_outside=False,
                            modelparam_slice=None):
        """Smallest set of particles containing ``level`` posterior mass.

        Reference parity: ``smc.py::SMCUpdater.est_credible_region`` — sort
        particles by weight descending, take the minimal prefix whose mass
        ≥ level. Sorting happens on-device; the (typically much smaller)
        region is returned as a NumPy array.
        """
        w = self._state.weights
        x = self._state.locations
        if modelparam_slice is not None:
            x = x[:, modelparam_slice]
        # ONE device dispatch (argsort + gathers + cumsum fused in a
        # single jitted program), then slice host-side, instead of ~6
        # op-by-op dispatches
        sorted_w, x_sorted = _sorted_by_weight(w, x)
        cmass = np.cumsum(np.asarray(sorted_w, dtype=np.float64))
        k = int(np.searchsorted(cmass, level)) + 1
        k = min(k, w.shape[0])
        x_sorted = np.asarray(x_sorted)
        inside = x_sorted[:k]
        if return_outside:
            return inside, x_sorted[k:]
        return inside

    def region_est_hull(self, level=0.95, modelparam_slice=None):
        """Convex hull of the credible particle set.

        Reference parity: ``smc.py::SMCUpdater.region_est_hull`` — returns
        ``(vertices, hull)`` with hull a ``scipy.spatial.ConvexHull``.
        Host-side scipy by design (SURVEY.md §7 escape hatches).
        """
        from scipy.spatial import ConvexHull

        pts = self.est_credible_region(level, modelparam_slice=modelparam_slice)
        if pts.shape[1] == 1:
            lo, hi = pts.min(), pts.max()
            return np.array([[lo], [hi]]), None
        hull = ConvexHull(pts)
        return pts[hull.vertices], hull

    def region_est_ellipsoid(self, level=0.95, tol=1e-4,
                             modelparam_slice=None):
        """Minimum-volume enclosing ellipsoid of the credible hull.

        Reference parity: ``smc.py::SMCUpdater.region_est_ellipsoid`` —
        returns ``(A, c)`` with the ellipsoid {x : (x−c)ᵀA(x−c) ≤ 1}.
        """
        vertices, _ = self.region_est_hull(
            level, modelparam_slice=modelparam_slice)
        return mvee(vertices, tol=tol)

    def in_credible_region(self, points, level=0.95, modelparam_slice=None,
                           method="hpd_hull", tol=1e-4):
        """Membership test of arbitrary points in the credible region.

        Reference parity: ``smc.py::SMCUpdater.in_credible_region`` with
        methods ``'hpd_hull'`` (Delaunay membership in the credible hull),
        ``'hpd_mvee'`` (inside the MVEE of the hull) and ``'est_cov'``
        (inside the posterior-covariance ellipsoid scaled to the level by
        the chi-square quantile).
        """
        points = np.atleast_2d(np.asarray(points))
        if method == "est_cov":
            from scipy.stats import chi2

            w = self._state.weights
            x = self._state.locations
            if modelparam_slice is not None:
                x = x[:, modelparam_slice]
            mu, cov = weighted_moments(w, x)
            d = x.shape[1]
            scale = chi2.ppf(level, df=d)
            return in_ellipsoid(points, scale * np.asarray(cov),
                                np.asarray(mu))
        if method == "hpd_hull":
            from scipy.spatial import Delaunay

            pts = self.est_credible_region(
                level, modelparam_slice=modelparam_slice)
            if pts.shape[1] == 1:
                lo, hi = pts.min(), pts.max()
                return (points[:, 0] >= lo) & (points[:, 0] <= hi)
            tri = Delaunay(pts)
            return tri.find_simplex(points) >= 0
        elif method == "hpd_mvee":
            A, c = self.region_est_ellipsoid(
                level, tol=tol, modelparam_slice=modelparam_slice)
            # mvee returns A with (x-c)^T A (x-c) <= 1; in_ellipsoid expects
            # the inverse-shape convention.
            return in_ellipsoid(points, np.linalg.inv(A), c)
        else:
            raise ValueError(f"unknown method {method!r}")

    # -- marginals & plotting ----------------------------------------------

    def posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                           range_min=None, range_max=None):
        """Weighted histogram estimate of a 1-D posterior marginal.

        Reference parity: ``smc.py::SMCUpdater.posterior_marginal`` —
        returns ``(grid_centers, density)``.
        """
        w = np.asarray(self._state.weights)
        x = np.asarray(self._state.locations[:, idx_param])
        lo = range_min if range_min is not None else x.min()
        hi = range_max if range_max is not None else x.max()
        if hi <= lo:
            hi = lo + 1e-6
        hist, edges = np.histogram(
            x, bins=res, range=(lo, hi), weights=w, density=True)
        centers = 0.5 * (edges[1:] + edges[:-1])
        if smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            hist = gaussian_filter1d(hist, smoothing)
        return centers, hist

    def plot_posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                                range_min=None, range_max=None,
                                label_xaxis=True, other_plot_args=None):
        """Plot a 1-D marginal. Reference parity:
        ``SMCUpdater.plot_posterior_marginal`` (matplotlib host-side)."""
        import matplotlib.pyplot as plt

        xs, ys = self.posterior_marginal(
            idx_param, res, smoothing, range_min, range_max)
        line, = plt.plot(xs, ys, **(other_plot_args or {}))
        if label_xaxis:
            plt.xlabel(self.model.modelparam_names[idx_param])
        plt.ylabel("posterior density")
        return line

    def plot_covariance(self, corr=False, param_slice=None, tick_labels=None,
                        tick_params=None):
        """Heatmap of the posterior covariance matrix. Reference parity:
        ``SMCUpdater.plot_covariance``."""
        import matplotlib.pyplot as plt

        cov = np.asarray(self.est_covariance_mtx(corr=corr))
        names = (list(tick_labels) if tick_labels is not None
                 else list(self.model.modelparam_names))
        if param_slice is not None:
            idx = np.arange(len(names))[param_slice]  # slice OR index list
            cov = cov[np.ix_(idx, idx)]
            names = [names[i] for i in idx]
        im = plt.imshow(cov, interpolation="nearest", cmap="RdBu_r")
        plt.colorbar(im)
        plt.xticks(range(len(names)), names, **(tick_params or {}))
        plt.yticks(range(len(names)), names, **(tick_params or {}))
        return im

    # -- misc --------------------------------------------------------------

    def __repr__(self):
        return (f"<SMCUpdater n_particles={self.n_particles} "
                f"n_ess={self.n_ess:.1f} "
                f"resample_count={self.resample_count}>")

    def _repr_html_(self):
        """Notebook display. Reference parity: the ipython pretty display
        of ``smc.py::SMCUpdater``."""
        from .utils import format_uncertainty

        mean = np.asarray(self.est_mean())
        std = np.sqrt(np.clip(np.diag(np.asarray(
            self.est_covariance_mtx())), 0, None))
        rows = "".join(
            f"<tr><td>{name}</td><td>{format_uncertainty(m, s)}</td></tr>"
            for name, m, s in zip(self.model.modelparam_names, mean, std))
        return (
            "<strong>SMCUpdater</strong> "
            f"({self.n_particles} particles, "
            f"ESS {self.n_ess:.1f}, {self.resample_count} resamples, "
            f"{len(self.data_record)} experiments)"
            f"<table><tr><th>parameter</th><th>posterior</th></tr>"
            f"{rows}</table>")


# ---------------------------------------------------------------------------
# SMCUpdaterBCRB
# ---------------------------------------------------------------------------

class SMCUpdaterBCRB(SMCUpdater):
    """SMC updater that additionally tracks the Bayesian information matrix
    and hence the Bayesian Cramér-Rao bound.

    Reference parity: ``src/qinfer/smc.py::SMCUpdaterBCRB`` — requires a
    :class:`~qinfer_tpu.abstract_model.DifferentiableModel`; after each
    update the posterior-averaged Fisher information of the performed
    experiment is accumulated into ``current_bim``; ``current_bcrb`` is its
    inverse. With ``adaptive=True`` the expectation uses the current
    posterior (adaptive BCRB); otherwise the initial prior ensemble.
    """

    def __init__(self, model, n_particles, prior, adaptive=False,
                 initial_bim=None, **kwargs):
        from .abstract_model import DifferentiableModel

        if not isinstance(model, DifferentiableModel):
            raise ValueError(
                "SMCUpdaterBCRB requires a DifferentiableModel")
        super().__init__(model, n_particles, prior, **kwargs)
        self.adaptive = bool(adaptive)
        # Non-adaptive BCRB averages Fisher information over the PRIOR
        # ensemble for every experiment (reference semantics); snapshot it.
        self._initial_weights = self._state.weights
        self._initial_locations = self._state.locations
        if initial_bim is None:
            self._current_bim = np.asarray(self._prior_bim(), dtype=np.float64)
        else:
            self._current_bim = np.asarray(initial_bim, dtype=np.float64)

    def _prior_bim(self):
        """Monte-Carlo estimate of the prior's information matrix
        E[∇logπ ∇logπᵀ] when the prior exposes ``grad_log_pdf``; zero
        otherwise (flat-prior convention, matching the reference's use of
        uniform priors)."""
        d = self.model.n_modelparams
        glp = getattr(self.prior, "grad_log_pdf", None)
        if glp is None:
            return jnp.zeros((d, d))
        g = glp(self._state.locations)  # (n, d)
        g = jnp.atleast_2d(g)
        if g.shape[-1] != d:
            g = jnp.broadcast_to(g, (g.shape[0], d))
        w = self._state.weights
        return jnp.einsum("n,ni,nj->ij", w, g, g)

    @property
    def current_bim(self):
        """The accumulated Bayesian information matrix."""
        return self._current_bim

    @property
    def current_bcrb(self):
        """pinv(BIM) — the Bayesian Cramér-Rao lower bound on the posterior
        covariance.

        Uses the pseudo-inverse: with a flat prior (no ``grad_log_pdf``)
        the prior term of the BIM is zero, so before enough experiments
        accumulate the matrix is singular and a strict ``inv`` raises
        (reference anchor: ``smc.py::SMCUpdaterBCRB``); the pinv returns
        the bound on the identified subspace and 0 elsewhere."""
        return np.linalg.pinv(self._current_bim)

    def update(self, outcome, expparams, check_for_resample=True):
        eps = self.model.canonicalize_expparams(expparams)
        if n_expparams(eps) != 1:
            # like the base updater, only the FIRST experiment of a batch
            # is consumed — slice BEFORE the Fisher evaluation so no
            # autodiff work is done for discarded columns
            eps = expparams_at(eps, 0)
        if self.adaptive:
            w = self._state.weights
            locs = self._state.locations
        else:
            w = self._initial_weights
            locs = self._initial_locations
        fi = self.model.fisher_information(locs, eps)  # (d, d, n, 1)
        expected_fi = np.asarray(jnp.einsum("ijnE,n->ij", fi, w))
        self._current_bim = self._current_bim + expected_fi
        super().update(outcome, eps,
                       check_for_resample=check_for_resample)
