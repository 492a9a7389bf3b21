"""Optimized adaptive experiment design.

Reference parity: ``src/qinfer/expdesign.py`` (SURVEY.md §2 #13) —
``ExperimentDesigner(updater, opt_algo)`` /
``design_expparams_field(guess, field, ...)`` minimizing
``updater.bayes_risk`` over one field of the expparams via Nelder-Mead or
CG with finite-difference gradients, keeping the best of stored guesses.

Design: the default optimizer is a **vectorized grid+refine
search** (``opt_algo=OptimizationAlgorithms.GRID``): the risk of hundreds of
candidates is scored in ONE batched ``bayes_risk`` call (a single fused XLA
reduction over particles × outcomes × candidates) and the grid zooms around
the incumbent — far better use of the device than the reference's sequential
scipy simplex, which evaluates one candidate per step. ``NM`` and ``CG``
remain available for parity and call scipy on the host with device-side
objective evaluations.
"""

from __future__ import annotations

import enum

import numpy as np
import jax
import jax.numpy as jnp

from .finite_difference import FiniteDifference

__all__ = ["ExperimentDesigner", "OptimizationAlgorithms",
           "select_candidate", "design_from_candidates", "PoolDesigner"]


def _egreedy_pick(key, scores, epsilon):
    k_u, k_pick = jax.random.split(key)
    n_cand = scores.shape[0]
    rand_idx = jax.random.randint(k_pick, (), 0, n_cand)
    greedy_idx = jnp.argmax(scores)
    explore = jax.random.uniform(k_u, ()) < epsilon
    return jnp.where(explore, rand_idx, greedy_idx).astype(jnp.int32)


def _softmax_pick(key, scores, temperature):
    if temperature is None:
        t = jnp.maximum(jnp.std(scores), 1e-12)
    else:
        t = jnp.asarray(temperature, scores.dtype)
    # center by the max BEFORE dividing: raw scores/t at tiny t is
    # ~1e12 and float-absorbs the O(1) Gumbel noise (degenerate flat
    # scores would collapse to argmax-of-ties = index 0 instead of
    # uniform); centered logits live in [-spread/t, 0]
    z = (scores - jnp.max(scores)) / t
    g = jax.random.gumbel(key, (scores.shape[0],), scores.dtype)
    return jnp.argmax(z + g).astype(jnp.int32)


def select_candidate(key, scores, policy="greedy", epsilon=0.1,
                     temperature=None, auto_threshold=0.15):
    """Pick a candidate index from utility ``scores`` (n_candidates,).

    Greedy argmax over one-step expected information gain is MYOPIC: on
    informationally-complete candidate grids it re-selects the currently
    most informative direction and under-explores the rest, measurably
    LOSING to uniform-random selection at long horizons (2-qubit state
    tomography, an earlier negative result kept in git history; reference
    anchor ``src/qinfer/expdesign.py::ExperimentDesigner.
    design_expparams_field``, which shares the one-step-lookahead target).
    The stochastic policies here mix exploration back in while keeping the
    early-step greedy gains — all jit-safe (no data-dependent shapes):

    - ``'greedy'``: argmax (the reference behavior).
    - ``'egreedy'``: with probability ``epsilon`` a uniform-random
      candidate, else argmax — the ε bounds every candidate's selection
      rate away from zero, so no direction starves.
    - ``'softmax'``: one sample from softmax(scores / T) via the Gumbel
      trick (``argmax(scores/T + g)``). ``temperature=None`` self-scales
      to the score spread (T = std(scores)).
    - ``'auto'`` (round 5): horizon-aware default encoding the 10-seed
      EXPDESIGN grid — egreedy (early-horizon winner) while the RELATIVE
      score spread ``std/|mean|`` is below ``auto_threshold``, softmax
      (long-horizon winner) above it. Measured on 2-qubit state
      tomography (3 seeds, benchmarks round 5): the relative EIG spread
      GROWS monotonically with data — ~0.015 at step 0 (symmetric prior:
      every direction equally informative), ~0.1 by step 60 (greedy's
      measured +0.05 regime), 0.2-0.36 by step 400 (softmax's best
      regime) — so the spread is a per-posterior proxy for the horizon
      with no step counter needed. Designed for nonnegative
      information-gain utilities (``std/|mean|`` is scale-free there).

    :return: scalar int32 candidate index (traced).
    """
    scores = jnp.asarray(scores)
    if policy == "greedy":
        return jnp.argmax(scores).astype(jnp.int32)
    if policy == "egreedy":
        return _egreedy_pick(key, scores, epsilon)
    if policy == "softmax":
        return _softmax_pick(key, scores, temperature)
    if policy == "auto":
        rel = jnp.std(scores) / jnp.maximum(
            jnp.abs(jnp.mean(scores)), 1e-12)
        k_e, k_s = jax.random.split(key)
        return jnp.where(rel < auto_threshold,
                         _egreedy_pick(k_e, scores, epsilon),
                         _softmax_pick(k_s, scores, temperature))
    raise ValueError(f"unknown candidate-selection policy {policy!r} "
                     "(greedy | egreedy | softmax | auto)")


def design_from_candidates(updater, candidate_eps, key=None,
                           policy="greedy", epsilon=0.1, temperature=None,
                           utility="information_gain"):
    """Score a FINITE pool of candidate experiments against the updater's
    posterior and select ONE (the discrete-pool sibling of
    :meth:`ExperimentDesigner.design_expparams_field`, which optimizes a
    continuous field). This is the design loop the round-4 tomography
    flagship runs per step — scoring the whole pool is one batched
    contraction, and the stochastic policies avoid greedy's axis
    starvation on informationally-complete pools.

    :param updater: an :class:`~qinfer_tpu.smc.SMCUpdater`.
    :param candidate_eps: expparams pytree with leading axis = pool size.
    :param key: PRNG key for the stochastic policies (required for
        ``egreedy``/``softmax``; ignored by ``greedy``).
    :param str utility: ``'information_gain'`` (maximized) or ``'risk'``
        (``bayes_risk``, minimized — scores are negated before
        selection).
    :return: ``(eps_one, index)`` — the selected single-experiment dict
        and its pool index.
    """
    if utility == "information_gain":
        scores = updater.expected_information_gain(candidate_eps)
    elif utility == "risk":
        scores = -updater.bayes_risk(candidate_eps)
    else:
        raise ValueError(f"unknown utility {utility!r} "
                         "(information_gain | risk)")
    if key is None:
        if policy != "greedy":
            raise ValueError(f"policy {policy!r} is stochastic: pass key=")
        key = jax.random.key(0)
    idx = int(select_candidate(key, scores, policy=policy,
                               epsilon=epsilon, temperature=temperature))
    eps = updater.model.canonicalize_expparams(candidate_eps)
    return {k: v[idx:idx + 1] for k, v in eps.items()}, idx


class PoolDesigner:
    """Stateful amortized pool designer (round 5, VERDICT r4 #5): score
    the candidate pool like :func:`design_from_candidates` but only
    RESCORE every ``rescore_interval`` calls and immediately after the
    updater resamples — between resamples the posterior (and hence the
    utility landscape over a fixed pool) drifts slowly, so cached scores
    select nearly as well at a fraction of the cost. Measured on the
    round-4 grid config, per-step scoring cost ~30% of engine throughput
    at 15 candidates; ``rescore_interval=4`` cuts it below the ≤10%
    target while the resample-triggered refresh keeps the cache honest
    exactly where the posterior jumps.

    :param updater: an :class:`~qinfer_tpu.smc.SMCUpdater`.
    :param candidate_eps: expparams pytree, leading axis = pool size.
    :param str policy: selection policy (see :func:`select_candidate`);
        default ``'auto'``, the horizon-aware schedule.
    :param int rescore_interval: rescore every k-th call (1 = every call,
        the unamortized behavior).
    :param bool rescore_on_resample: also rescore whenever the updater's
        ``resample_count`` advanced since the cached scores were computed.
    """

    def __init__(self, updater, candidate_eps, policy="auto", epsilon=0.1,
                 temperature=None, auto_threshold=0.15,
                 utility="information_gain", rescore_interval=1,
                 rescore_on_resample=True, seed=0):
        if utility not in ("information_gain", "risk"):
            raise ValueError(f"unknown utility {utility!r} "
                             "(information_gain | risk)")
        self.updater = updater
        self.candidate_eps = updater.model.canonicalize_expparams(
            candidate_eps)
        self.policy = policy
        self.epsilon = float(epsilon)
        self.temperature = temperature
        self.auto_threshold = float(auto_threshold)
        self.utility = utility
        self.rescore_interval = max(int(rescore_interval), 1)
        self.rescore_on_resample = bool(rescore_on_resample)
        self._key = (jax.random.key(seed) if isinstance(seed, int)
                     else seed)
        self._scores = None
        # calls since the last rescore (NOT total calls): a
        # resample-triggered refresh resets the interval phase, so the
        # next scheduled rescore is a full interval later rather than
        # potentially the very next call
        self._since_rescore = 0
        self._scored_at_resample = -1
        self.n_rescores = 0  # observability: how often the pool rescored

    def _fresh_scores(self):
        if self.utility == "information_gain":
            return self.updater.expected_information_gain(
                self.candidate_eps)
        return -self.updater.bayes_risk(self.candidate_eps)

    def __call__(self):
        """Select one experiment; returns ``(eps_one, index)`` like
        :func:`design_from_candidates`."""
        rc = int(self.updater.state.resample_count)
        stale = (self._scores is None
                 or self._since_rescore >= self.rescore_interval
                 or (self.rescore_on_resample
                     and rc != self._scored_at_resample))
        if stale:
            self._scores = self._fresh_scores()
            self._scored_at_resample = rc
            self._since_rescore = 0
            self.n_rescores += 1
        self._since_rescore += 1
        self._key, sub = jax.random.split(self._key)
        idx = int(select_candidate(
            sub, self._scores, policy=self.policy, epsilon=self.epsilon,
            temperature=self.temperature,
            auto_threshold=self.auto_threshold))
        return ({k: v[idx:idx + 1]
                 for k, v in self.candidate_eps.items()}, idx)


class OptimizationAlgorithms(enum.Enum):
    """Reference parity: ``expdesign.py::OptimizationAlgorithms`` (CG, NM)
    plus the batched GRID search."""

    NM = 0
    CG = 1
    GRID = 2


class ExperimentDesigner:
    """Design locally-optimal experiments against an updater's Bayes risk.

    Reference parity: ``src/qinfer/expdesign.py::ExperimentDesigner``.
    """

    def __init__(self, updater, opt_algo=OptimizationAlgorithms.GRID):
        self.updater = updater
        if isinstance(opt_algo, str):
            try:
                opt_algo = OptimizationAlgorithms[opt_algo.upper()]
            except KeyError:
                raise ValueError(
                    f"unknown opt_algo {opt_algo!r}; expected one of "
                    f"{[a.name for a in OptimizationAlgorithms]}")
        if not isinstance(opt_algo, OptimizationAlgorithms):
            raise ValueError("opt_algo must be an OptimizationAlgorithms")
        self.opt_algo = opt_algo
        self._best_guess = None
        self._best_risk = np.inf

    def new_exp(self):
        """Forget stored guesses (call between experiments).

        Reference parity: ``ExperimentDesigner.new_exp``.
        """
        self._best_guess = None
        self._best_risk = np.inf

    # -- objective ---------------------------------------------------------

    def _risk_of(self, base_eps, field, values, cost_scale_k=0.0,
                 cost_mult=False):
        """Risk for a batch of candidate values of one scalar field.

        Cost weighting applies whenever ``cost_scale_k != 0`` (additive) or
        ``cost_mult`` is set (multiplicative) — gating on a magic default
        value would make ``cost_scale_k=1.0`` silently mean "no cost".
        """
        values = jnp.atleast_1d(jnp.asarray(values))
        n_cand = values.shape[0]
        eps = {
            k: jnp.broadcast_to(v[:1], (n_cand,) + v.shape[1:])
            for k, v in base_eps.items()
        }
        tgt = eps[field].dtype if field in eps else jnp.float32
        if jnp.issubdtype(tgt, jnp.integer):
            # round, don't floor: astype truncation made grid candidates
            # collapse onto duplicate integers and recorded a best_x that
            # was never the value actually evaluated
            values = jnp.round(values)
        eps[field] = values.astype(tgt)
        risk = self.updater.bayes_risk(eps)
        if cost_scale_k != 0.0 or cost_mult:
            cost = self.updater.model.experiment_cost(eps)
            if cost_mult:
                risk = risk * (1.0 + cost_scale_k * cost)
            else:
                risk = risk + cost_scale_k * cost
        return np.asarray(risk), eps

    # -- main entry --------------------------------------------------------

    def design_expparams_field(self, guess, field,
                               cost_scale_k=0.0, disp=False,
                               maxiter=24, maxfun=None, store_guess=False,
                               grad_h=1e-6, cost_mult=False,
                               n_grid=64, n_zoom=3, zoom_factor=0.25,
                               bounds=None):
        """Optimize one scalar field of the expparams.

        Reference parity: ``expdesign.py::ExperimentDesigner.
        design_expparams_field(guess, field, cost_scale_k, disp, maxiter,
        maxfun, store_guess, grad_h, cost_mult)``. ``guess`` is either an
        expparams record (dict / structured array) or a ``Heuristic``
        instance to call for one. ``cost_scale_k=0`` (default) optimizes
        pure risk; any nonzero value adds ``k * experiment_cost``;
        ``cost_mult`` multiplies instead.

        :param bounds: optional ``(lo, hi)`` (either side may be None)
            restricting the search to the physically meaningful range —
            unconstrained optimizers (and the zooming grid) can otherwise
            wander into unphysical values, e.g. negative RB sequence
            lengths, where a likelihood evaluates but means nothing (the
            reference shares this hazard: its scipy optimizers are also
            unconstrained and its uint fields silently wrap).

        :return: the optimized expparams dict (one experiment).
        """
        from .heuristics import Heuristic

        if isinstance(guess, Heuristic):
            base_eps = guess()
        elif isinstance(guess, type) and issubclass(guess, Heuristic):
            base_eps = guess(self.updater)()
        else:
            base_eps = self.updater.model.canonicalize_expparams(guess)
        base_eps = {k: jnp.atleast_1d(jnp.asarray(v))
                    for k, v in base_eps.items()}

        x0 = float(np.asarray(base_eps[field]).ravel()[0])
        lo_b = -np.inf if bounds is None or bounds[0] is None else float(
            bounds[0])
        hi_b = np.inf if bounds is None or bounds[1] is None else float(
            bounds[1])

        def clamp(x):
            return float(np.clip(np.asarray(x).ravel()[0], lo_b, hi_b))

        if self.opt_algo is OptimizationAlgorithms.GRID:
            best_x, best_risk = self._grid_search(
                base_eps, field, clamp(x0), cost_scale_k, cost_mult,
                n_grid=n_grid, n_zoom=n_zoom, zoom_factor=zoom_factor,
                lo_b=lo_b, hi_b=hi_b)
        else:
            objective = lambda x: float(self._risk_of(
                base_eps, field, np.atleast_1d(clamp(x))[:1], cost_scale_k,
                cost_mult)[0][0])
            import scipy.optimize as opt

            if self.opt_algo is OptimizationAlgorithms.NM:
                res = opt.fmin(objective, x0, disp=bool(disp),
                               maxiter=maxiter, maxfun=maxfun,
                               full_output=True)
                best_x, best_risk = clamp(
                    np.atleast_1d(res[0])[0]), float(res[1])
            else:  # CG
                grad = FiniteDifference(objective, 1, h=grad_h)
                res = opt.fmin_cg(objective, np.atleast_1d(x0),
                                  fprime=lambda x: grad(x),
                                  disp=bool(disp), maxiter=maxiter,
                                  full_output=True)
                best_x, best_risk = clamp(
                    np.atleast_1d(res[0])[0]), float(res[1])

        if store_guess:
            if best_risk < self._best_risk or self._best_guess is None:
                # (the None guard covers a first call whose risks were all
                # NaN — keep the computed candidate rather than unpacking
                # an empty store)
                self._best_risk = best_risk
                self._best_guess = (best_x, dict(base_eps))
            else:
                best_x, stored = self._best_guess
                base_eps = dict(stored)
                best_risk = self._best_risk  # keep disp/diagnostics
                # consistent with the restored guess

        # ONE designed experiment: slice every field to the first row —
        # _risk_of scored candidates against experiment 0's other fields,
        # so returning full-length companions would pair the designed
        # value with experiments that were never evaluated (and hand
        # callers a dict with mismatched leading axes)
        out = {k: v[:1] for k, v in base_eps.items()}
        field_dtype = np.asarray(base_eps[field]).dtype
        if np.issubdtype(field_dtype, np.integer):
            # round (and re-clamp) BEFORE the dtype cast: _risk_of scored
            # round(best_x), so a raw truncating astype (7.6 -> 7) would
            # return an experiment different from the one whose risk was
            # evaluated and reported — on all of GRID/NM/CG paths
            best_x = clamp(np.rint(best_x))
        out[field] = jnp.atleast_1d(jnp.asarray(best_x, dtype=field_dtype))
        if disp:
            print(f"design_expparams_field: {field}={best_x:.6g} "
                  f"risk={best_risk:.6g}")
        return out

    def _grid_search(self, base_eps, field, x0, cost_scale_k, cost_mult,
                     n_grid, n_zoom, zoom_factor,
                     lo_b=-np.inf, hi_b=np.inf):
        """Batched zooming grid search — each round is ONE vectorized
        bayes_risk evaluation of ``n_grid`` candidates. Every zoom window
        is clipped to the caller's ``bounds``."""
        lo = x0 / 10.0 if x0 > 0 else x0 - 1.0
        hi = x0 * 10.0 if x0 > 0 else x0 + 1.0
        # explicit finite bounds DEFINE the initial search domain: the
        # x0-heuristic window only ever shrinks under zooming, so without
        # this it could never reach an optimum past 10·x0 even when the
        # caller's bounds allow it
        if np.isfinite(lo_b):
            lo = lo_b
        if np.isfinite(hi_b):
            hi = hi_b
        best_x, best_risk = x0, np.inf
        for _ in range(max(1, int(n_zoom))):
            lo, hi = max(lo, lo_b), min(hi, hi_b)
            grid = np.linspace(lo, hi, n_grid)
            risks, _ = self._risk_of(
                base_eps, field, grid, cost_scale_k, cost_mult)
            i = int(np.argmin(risks))
            if risks[i] < best_risk:
                best_risk = float(risks[i])
                best_x = float(grid[i])
            span = (hi - lo) * zoom_factor
            lo, hi = best_x - span / 2, best_x + span / 2
        return best_x, best_risk
