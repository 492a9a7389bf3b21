"""Performance-testing harness (adaptive-inference trial loops).

Reference parity: ``src/qinfer/perf_testing.py`` (SURVEY.md §2 #15) —
``perf_test`` (one full run: heuristic → simulate → update, recording loss /
timing / resampling per step) and ``perf_test_multiple`` (fan-out over
trials with an injectable ``apply``).

Two execution paths.

* :func:`perf_test` — host-loop parity path: works with any heuristic,
  returns the reference's structured per-step record array (with true
  per-step wall times).
* :func:`perf_test_scan` — the device path: the ENTIRE adaptive loop
  (heuristic proposal, outcome simulation at the true parameters, fused SMC
  update with conditional resampling) is one ``lax.scan`` compiled into a
  single XLA program; trials vmap/shard over the mesh. This is the loop the
  benchmark (bench.py) runs, and the engine the reference's ipyparallel trial fan-out
  (``perf_testing.py::perf_test_multiple(apply=view.apply)``) maps onto.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from .smc import SMCUpdater, _update_step
from .heuristics import PGH

__all__ = ["perf_test", "perf_test_multiple", "perf_test_scan",
           "perf_test_scan_batch", "PERF_DTYPE"]

#: Per-step record dtype. Reference parity: the structured array returned by
#: ``perf_testing.py::perf_test`` (elapsed_time, loss, resample_count,
#: outcome, plus estimate columns).
PERF_DTYPE = [
    ("elapsed_time", np.float64),
    ("loss", np.float64),
    ("resample_count", np.int64),
    ("outcome", np.float64),
]


def perf_test(model, n_particles, prior, n_exp, heuristic_class=PGH,
              true_model=None, true_prior=None, true_mps=None,
              extra_updater_args=None, seed=0):
    """Run one full adaptive inference experiment and record per-step
    performance.

    Reference parity: ``src/qinfer/perf_testing.py::perf_test`` — same
    protocol: draw true parameters from ``true_prior`` (default: the
    inference prior), loop ``heuristic → true_model.simulate_experiment →
    updater.update``, record Q-weighted quadratic loss, timing and
    resample counts.

    :return: ``(performance, extra)`` where ``performance`` is a structured
        array of length ``n_exp`` with fields ``PERF_DTYPE`` plus
        ``est_<name>`` / ``true_<name>`` columns in ``extra``.
    """
    true_model = true_model if true_model is not None else model
    true_prior = true_prior if true_prior is not None else prior
    key = jax.random.key(seed)

    if true_mps is None:
        key, k_true = jax.random.split(key)
        true_mps = true_prior.sample(k_true, 1)
    true_mps = jnp.atleast_2d(jnp.asarray(true_mps))

    updater = SMCUpdater(model, n_particles, prior, seed=seed + 1,
                         **(extra_updater_args or {}))
    heuristic = heuristic_class(updater)

    performance = np.zeros((n_exp,), dtype=PERF_DTYPE)
    ests = np.zeros((n_exp, model.n_modelparams))
    Q = np.asarray(model.Q)

    current_true = true_mps
    for idx in range(n_exp):
        t0 = time.perf_counter()
        eps = heuristic(idx)
        key, k_sim, k_ts = jax.random.split(key, 3)
        outcome = true_model.simulate_experiment(k_sim, current_true, eps)
        # gate on the engine's trace-time hook: every Simulatable defines
        # a default update_timestep, so a hasattr check is always true
        # and would pay a per-step identity dispatch for static models
        if bool(true_model.is_time_dependent):
            current_true = true_model.update_timestep(
                k_ts, current_true, eps)[:, :, 0]
        updater.update(outcome, eps)
        est = np.asarray(updater.est_mean())
        delta = est - np.asarray(current_true[0])
        performance[idx]["elapsed_time"] = time.perf_counter() - t0
        performance[idx]["loss"] = float(np.sum(Q * delta * delta))
        performance[idx]["resample_count"] = updater.resample_count
        performance[idx]["outcome"] = float(np.asarray(outcome).ravel()[0])
        ests[idx] = est

    extra = {
        "updater": updater,
        "true_mps": np.asarray(current_true),
        "est": ests,
    }
    return performance, extra


def perf_test_multiple(n_trials, model, n_particles, prior, n_exp,
                       heuristic_class=PGH, true_model=None, true_prior=None,
                       apply=None, progressbar=None, seed=0,
                       **kwargs):
    """Fan out :func:`perf_test` over independent trials.

    Reference parity: ``perf_testing.py::perf_test_multiple`` — ``apply`` is
    injectable exactly like the reference's ipyparallel ``view.apply``
    (tests inject a serial stand-in; clusters inject a remote executor).

    :return: structured array of shape ``(n_trials, n_exp)``.
    """
    results = np.zeros((n_trials, n_exp), dtype=PERF_DTYPE)
    prog = None
    if progressbar is not None:
        prog = progressbar()
        if hasattr(prog, "start"):
            prog.start(max=n_trials)

    def one_trial(i):
        perf, _ = perf_test(
            model, n_particles, prior, n_exp, heuristic_class,
            true_model=true_model, true_prior=true_prior,
            seed=seed + 1000 * i, **kwargs)
        return perf

    for i in range(n_trials):
        if apply is not None:
            r = apply(one_trial, i)
            # ipyparallel-style executors return AsyncResult handles
            results[i] = r.get() if hasattr(r, "get") else r
        else:
            results[i] = one_trial(i)
        if prog is not None and hasattr(prog, "update"):
            prog.update(i + 1)
    if prog is not None and hasattr(prog, "finished"):
        prog.finished()
    return results


def perf_test_scan(model, n_particles, prior, n_exp, heuristic_factory=None,
                   true_mps=None, resample_thresh=0.5, resampler=None,
                   seed=0, sharding=None):
    """Fully-compiled adaptive inference: one ``lax.scan`` over experiments.

    The compiled superset of :func:`perf_test` for jittable heuristics
    (PGH, ExpSparse, Identity): zero host round-trips inside the loop. Use
    ``jax.vmap`` / mesh sharding over trials for the reference's
    trial-parallel mode.

    :param heuristic_factory: ``f(updater) -> Heuristic`` (default PGH).
    :param true_mps: (1, d) true parameters (default: drawn from prior).
    :return: ``(updater, record)`` — the final updater (posterior state
        committed) and a dict of per-step arrays
        ``{loss, ess, norm, est}`` (device arrays).
    """
    key = jax.random.key(seed)
    if true_mps is None:
        key, k_true = jax.random.split(key)
        true_mps = prior.sample(k_true, 1)
    true_mps = jnp.atleast_2d(jnp.asarray(true_mps))

    updater = SMCUpdater(model, n_particles, prior, seed=seed + 1,
                         resample_thresh=resample_thresh,
                         resampler=resampler, sharding=sharding,
                         zero_weight_policy="reset")
    heuristic = (heuristic_factory(updater) if heuristic_factory is not None
                 else PGH(updater))
    Q = model.Q

    def step(carry, idx):
        st, true, key = carry
        key, k_h, k_sim = jax.random.split(key, 3)
        eps = heuristic.propose(k_h, st.weights, st.locations, idx)
        outcome = model.simulate_experiment(k_sim, true, eps)
        outcome = jnp.asarray(outcome).reshape(-1)[0]
        if bool(model.is_time_dependent):
            # the TRUE parameters evolve alongside the particles
            # (reference parity: perf_test's true_model.update_timestep)
            key, k_ts = jax.random.split(key)
            true = model.update_timestep(k_ts, true, eps)[:, :, 0]
        new_st, log_norm, _ = _update_step(
            model, updater.resampler, st, outcome, eps,
            updater.resample_thresh, updater.zero_weight_thresh,
            check_resample=True)
        est = new_st.weights @ new_st.locations
        delta = est - true[0]
        loss = jnp.sum(Q * delta * delta)
        ess = 1.0 / jnp.sum(new_st.weights ** 2)
        return (new_st, true, key), dict(loss=loss, ess=ess,
                                         norm=jnp.exp(log_norm), est=est)

    @jax.jit
    def run(state, true, key):
        return jax.lax.scan(step, (state, true, key), jnp.arange(n_exp))

    (final_state, final_true, _), record = run(updater.state, true_mps, key)
    updater.state = final_state
    record["true_mps"] = final_true
    return updater, record


def perf_test_scan_batch(model, n_particles, prior, n_exp, n_trials,
                         resample_thresh=0.5, resampler=None, seed=0,
                         mesh=None, axis_name="trials",
                         zero_weight_thresh=1e-10,
                         heuristic_factory=None,
                         n_mcmc_moves=0, mcmc_proposal_scale=2.38,
                         resample_interval=0,
                         return_runner=False):
    """Trial-parallel fully-compiled adaptive inference.

    The single-program replacement for the reference's ipyparallel trial
    fan-out (``perf_testing.py::perf_test_multiple(apply=view.apply)``):
    every trial runs the same compiled PGH→simulate→update ``lax.scan``,
    and trials are distributed over devices.

    Two execution modes:

    * ``mesh=None`` — ``jax.vmap`` over trials on one device. NOTE: under
      vmap, ``lax.cond`` lowers to ``select`` (both branches execute), so
      every step pays the resample cost; fine for small ensembles.
    * ``mesh`` given — ``jax.shard_map`` over a 1-D trial mesh: each device
      runs its own trials with REAL conditional resampling (the branch is a
      per-device runtime decision), so per-trial cost matches the
      single-trial path. ``n_trials`` must divide by the mesh size.

    :param int resample_interval: check the ESS resample condition only
        every K-th step (reference parity:
        ``SMCUpdater.batch_update(resample_interval)``); 0 = every step.
        This is ALSO the vmap-mode performance lever (VERDICT r3 #8): the
        per-trial resample gate vmaps to a select-masked while-loop body
        that executes whenever ANY trial's predicate fires — with many
        independent trials that is nearly every step, so vmap mode paid a
        full-batch resample per step. An interval gate synchronizes every
        trial's eligible steps, bounding the body to ``n_exp / K``
        executions regardless of trial count.
    :param return_runner: return ``(runner, trial_keys)`` instead of
        executing — ``runner(trial_keys)`` is the jitted callable, so
        benchmarks can compile once and time warm re-runs without the
        retrace a fresh ``perf_test_scan_batch`` call would pay.
    :return: dict of stacked per-trial records
        ``{loss (T, n_exp), ess (T, n_exp), est (T, n_exp, d),
        true_mps (T, d), final_weights, final_locations}``.
    """
    from .resamplers import LiuWestResampler
    from .smc import SMCState, _update_step_impl

    resampler = resampler if resampler is not None else LiuWestResampler()
    zero_thresh = float(zero_weight_thresh)
    Q = model.Q
    d = model.n_modelparams

    # a PGH heuristic bound to no updater: propose() only reads the model's
    # expparams_dtype, which we patch through a stub
    class _Stub:
        pass

    stub = _Stub()
    stub.model = model
    heuristic = (heuristic_factory(stub) if heuristic_factory is not None
                 else PGH(stub))

    def make_trial(trial_key):
        k_prior, k_true, k_run = jax.random.split(trial_key, 3)
        # match SMCUpdater.reset: prior samples are canonicalized
        locations = model.canonicalize(prior.sample(k_prior, n_particles))
        state = SMCState.initial(locations, k_run)
        true_mps = prior.sample(k_true, 1)
        return state, true_mps

    if n_mcmc_moves > 0 and bool(model.is_time_dependent):
        raise ValueError("n_mcmc_moves > 0 is incompatible with "
                         "time-dependent models (see SMCUpdater)")

    def run_trial(trial_key):
        state, true_mps = make_trial(trial_key)

        if n_mcmc_moves > 0:
            # record buffers for rejuvenation, sized/typed at trace time
            eps_aval = jax.eval_shape(
                lambda k: heuristic.propose(
                    k, state.weights, state.locations, 0), trial_key)
            out_aval = jax.eval_shape(
                lambda k, e: jnp.asarray(model.simulate_experiment(
                    k, true_mps, e)).reshape(-1)[0], trial_key, eps_aval)
            out_buf0 = jnp.zeros((n_exp,), out_aval.dtype)
            eps_buf0 = jax.tree_util.tree_map(
                lambda a: jnp.zeros((n_exp,) + a.shape[1:], a.dtype),
                eps_aval)
        else:
            out_buf0, eps_buf0 = jnp.zeros((0,)), {}

        def step(carry, idx):
            st, key, true, out_buf, eps_buf = carry
            key, k_h, k_sim = jax.random.split(key, 3)
            eps = heuristic.propose(k_h, st.weights, st.locations, idx)
            outcome = model.simulate_experiment(k_sim, true, eps)
            outcome = jnp.asarray(outcome).reshape(-1)[0]
            if bool(model.is_time_dependent):
                # the TRUE parameters evolve alongside the particles
                key, k_ts = jax.random.split(key)
                true = model.update_timestep(k_ts, true, eps)[:, :, 0]
            from .smc import resample_interval_gate

            gate = resample_interval_gate(idx, resample_interval)
            new_st, _, _ = _update_step_impl(
                model, resampler, st, outcome, eps,
                resample_thresh, zero_thresh, check_resample=True,
                resample_gate=gate)
            if n_mcmc_moves > 0:
                from .rejuvenation import mcmc_rejuvenate

                out_buf = out_buf.at[idx].set(outcome)
                eps_buf = jax.tree_util.tree_map(
                    lambda b, leaf: b.at[idx].set(leaf[0]), eps_buf, eps)

                def move(s):
                    k2, sub = jax.random.split(s.key)
                    x, _ = mcmc_rejuvenate(
                        model, prior, sub, s.locations, out_buf, eps_buf,
                        jnp.arange(n_exp) <= idx, n_mcmc_moves,
                        mcmc_proposal_scale)
                    return s._replace(locations=x, key=k2)

                new_st = jax.lax.cond(new_st.just_resampled, move,
                                      lambda s: s, new_st)
            est = new_st.weights @ new_st.locations
            delta = est - true[0]
            loss = jnp.sum(Q * delta * delta)
            ess = 1.0 / jnp.sum(new_st.weights ** 2)
            return (new_st, key, true, out_buf, eps_buf), dict(
                loss=loss, ess=ess, est=est)

        (final, _, final_true, _, _), rec = jax.lax.scan(
            step, (state, jax.random.fold_in(trial_key, 1), true_mps,
                   out_buf0, eps_buf0),
            jnp.arange(n_exp))
        rec["true_mps"] = final_true[0]
        rec["final_weights"] = final.weights
        rec["final_locations"] = final.locations
        return rec

    trial_keys = jax.random.split(jax.random.key(seed), n_trials)

    if mesh is None:
        if n_mcmc_moves > 0:
            import warnings

            warnings.warn(
                "perf_test_scan_batch(n_mcmc_moves>0) without a mesh "
                "vmaps the trials, which lowers the rejuvenation "
                "lax.cond to a select: the full MCMC record pass runs "
                "on EVERY step of every trial, resampled or not "
                "(~n_exp-fold extra work). Pass a mesh to shard trials "
                "and keep the cond a real branch.")
        runner = jax.jit(jax.vmap(run_trial))
        if return_runner:
            return runner, trial_keys
        return runner(trial_keys)

    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis_name]
    if n_trials % n_dev:
        raise ValueError(
            f"mesh size {n_dev} must divide n_trials={n_trials} "
            "(equal trial blocks per device)")

    def shard_fn(keys_block):
        # sequential trials within the shard keep real cond branching
        return jax.lax.map(run_trial, keys_block)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False)
    runner = jax.jit(mapped)
    if return_runner:
        return runner, trial_keys
    return runner(trial_keys)
