"""Headline benchmark: particle-updates/s on the precession model, one GPU.

Runs the fully-compiled adaptive SMC loop (production PGH proposal →
outcome simulation → reweight/resample step, all inside one ``lax.scan``)
on one GPU and reports throughput as particle-updates per second.

This drives the code paths the library advertises: the production
:meth:`qinfer_tpu.heuristics.PGH.propose` (exclusion sampling of the second
particle, Q-weighted distance) and the engine's update step with the
backend-selected Liu-West resample.

Baseline: the reference (QInfer) publishes no numbers (BASELINE.md); the
north star is ≥ 1e7 particle-updates/s, so ``vs_baseline = value / 1e7``.

Fails without a GPU. Prints the card's name and power limit, then ONE JSON
line.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp

N_PARTICLES = 1 << 22      # 4,194,304 particles
N_STEPS = 256              # adaptive experiments per run
N_REPEATS = 3              # timed repetitions (best taken)
BASELINE = 1e7             # north star: particle-updates/s


def build_run(n_particles=N_PARTICLES, interval=0):
    import qinfer_tpu as q
    from qinfer_tpu.smc import (SMCState, _update_step_impl,
                                resample_interval_gate)
    from qinfer_tpu.resamplers import LiuWestResampler
    from qinfer_tpu.heuristics import PGH

    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    resampler = LiuWestResampler(a=0.98)
    resample_thresh = 0.5
    zero_thresh = 1e-10

    # production PGH proposal (pure keyed form); propose() only reads the
    # model off the "updater", so bind it through a stub (the same pattern
    # perf_testing uses) instead of allocating a throwaway ensemble
    class _Stub:
        pass

    stub = _Stub()
    stub.model = model
    pgh = PGH(stub)

    true_omega = jnp.array([[0.7]], dtype=jnp.float32)

    def step(carry, idx):
        st, key = carry
        key, k_pgh, k_sim = jax.random.split(key, 3)
        eps = pgh.propose(k_pgh, st.weights, st.locations, idx)
        outcome = model.simulate_experiment(k_sim, true_omega, eps)
        outcome = jnp.asarray(outcome).reshape(-1)[0]
        gate = resample_interval_gate(idx, interval)
        new_st, _, _ = _update_step_impl(
            model, resampler, st, outcome, eps,
            resample_thresh, zero_thresh, check_resample=True,
            resample_gate=gate)
        return (new_st, key), ()

    @jax.jit
    def run(state, key):
        (final, _), _ = jax.lax.scan(step, (state, key),
                                     jnp.arange(N_STEPS))
        return final

    def make_state(seed):
        key = jax.random.key(seed)
        k_prior, k_run = jax.random.split(key)
        locations = prior.sample(k_prior, n_particles)
        return SMCState.initial(locations, k_run), jax.random.key(seed + 1)

    return run, make_state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--particles", type=int, default=N_PARTICLES)
    parser.add_argument("--interval", type=int, default=0,
                        help="check the ESS resample condition only every "
                        "K-th step (reference batch_update default is 5; "
                        "0 = every step, the headline protocol)")
    args = parser.parse_args(argv)

    from chip_smoke import card_line, device_info, require_gpu
    from qinfer_tpu._cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    print(card_line(), flush=True)

    run, make_state = build_run(args.particles, args.interval)

    # warmup / compile
    state, key = make_state(0)
    jax.block_until_ready(run(state, key).weights)

    walls = []
    for rep in range(N_REPEATS):
        state, key = make_state(rep + 1)
        jax.block_until_ready(state.weights)
        t0 = time.perf_counter()
        final = run(state, key)
        jax.block_until_ready(final.weights)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    updates_per_sec = args.particles * N_STEPS / best

    # sanity: the run must actually have inferred something
    est = float(final.weights @ final.locations[:, 0])
    print(json.dumps({
        "metric": "particle_updates_per_s",
        "value": updates_per_sec,
        "unit": "particle-updates/s",
        "vs_baseline": updates_per_sec / BASELINE,
        "repeat_walls_s": walls,
        "posterior_mean": est,
        "ok": abs(est - 0.7) < 0.05,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
