"""BASELINE config 5: adaptive experiment design at 10M sharded particles.

PGH proposal + expected-information-gain scoring over a candidate batch,
fully compiled, with the particle ensemble sharded over every available
device (`P('particles')` mesh). All reductions in the EIG score and the
SMC update cross the particle sharding, so XLA inserts psum/all-gather
collectives — on real hardware these ride ICI.

Per step (inside one ``lax.scan``):
  1. production PGH proposes a base time t*;
  2. a geometric candidate grid around t* is scored with
     ``expected_information_gain`` (the (n_out, n_particles, n_cand)
     likelihood contraction — the config-5 hot loop);
  3. the argmax-EIG candidate is run at the true parameters and the
     posterior updated (fused reweight + ESS-gated Liu-West resample).

Usage:
    python benchmarks/expdesign_bench.py                 # real device(s)
    python benchmarks/expdesign_bench.py --virtual 8     # 8-dev CPU mesh
    python benchmarks/expdesign_bench.py --particles 8388608 --steps 32

Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--virtual", type=int, default=0,
                        help="force N virtual CPU devices")
    parser.add_argument("--particles", type=int, default=10_000_000)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--candidates", type=int, default=16)
    parser.add_argument("--chunk", type=int, default=0,
                        help="score candidates in chunks of this size "
                             "(0 = one fused contraction; needed when "
                             "n_out*particles*candidates exceeds device memory)")
    args = parser.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}")
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from qinfer_tpu._cache import enable_compile_cache

        enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import qinfer_tpu as q
    from qinfer_tpu.smc import (
        SMCState, _update_step_impl, _expected_information_gain)
    from qinfer_tpu.resamplers import LiuWestResampler
    from qinfer_tpu.heuristics import PGH

    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    resampler = LiuWestResampler(a=0.98)

    devices = jax.devices()
    n_dev = len(devices)
    # round the ensemble down to a multiple of the device count
    n = (args.particles // n_dev) * n_dev
    n_cand = args.candidates

    mesh = Mesh(np.asarray(devices), ("particles",))
    shard = NamedSharding(mesh, P("particles"))
    shard2d = NamedSharding(mesh, P("particles", None))
    repl = NamedSharding(mesh, P())

    key = jax.random.key(0)
    kp, kr = jax.random.split(key)
    base = SMCState.initial(prior.sample(kp, n), kr)
    state = SMCState(
        weights=jax.device_put(base.weights, shard),
        locations=jax.device_put(base.locations, shard2d),
        key=jax.device_put(base.key, repl),
        resample_count=jax.device_put(base.resample_count, repl),
        just_resampled=jax.device_put(base.just_resampled, repl),
        log_total_likelihood=jax.device_put(base.log_total_likelihood, repl),
        min_n_ess=jax.device_put(base.min_n_ess, repl),
        zero_weight_count=jax.device_put(base.zero_weight_count, repl),
        resampler_fallback_count=jax.device_put(
            base.resampler_fallback_count, repl),
    )
    true = jax.device_put(jnp.array([[0.7]], dtype=jnp.float32), repl)

    pgh = PGH(q.SMCUpdater(model, 16, prior, seed=99))
    # geometric spread of candidate times around the PGH proposal
    spread = jnp.geomspace(0.25, 4.0, n_cand).astype(jnp.float32)
    outcome_grid = jnp.arange(2, dtype=jnp.int32)
    outcome_mask = jnp.ones((2, n_cand), jnp.float32)

    chunk = args.chunk if 0 < args.chunk < n_cand else 0
    if chunk and n_cand % chunk:
        raise SystemExit("--candidates must be a multiple of --chunk")
    mask_c = jnp.ones((2, chunk or n_cand), jnp.float32)

    def score(st, cand_t):
        if not chunk:
            return _expected_information_gain(
                model, st.weights, st.locations, outcome_grid,
                outcome_mask, {"t": cand_t})
        # bounded-memory scoring: lax.map over candidate chunks (the
        # engine's SMCUpdater.expected_information_gain(candidate_chunk=)
        # path, inlined here because the bench drives the pure functions)
        chunks = cand_t.reshape(-1, chunk)
        return jax.lax.map(
            lambda ct: _expected_information_gain(
                model, st.weights, st.locations, outcome_grid,
                mask_c, {"t": ct}),
            chunks).reshape(-1)

    def step(carry, idx):
        st, key = carry
        key, k_pgh, k_sim = jax.random.split(key, 3)
        base_eps = pgh.propose(k_pgh, st.weights, st.locations, idx)
        cand = {"t": base_eps["t"][0] * spread}              # (n_cand,)
        eig = score(st, cand["t"])                            # (n_cand,)
        best = jnp.argmax(eig)
        eps = {"t": cand["t"][best][None]}
        outcome = model.simulate_experiment(k_sim, true, eps)
        outcome = jnp.asarray(outcome).reshape(-1)[0]
        new_st, _, _ = _update_step_impl(
            model, resampler, st, outcome, eps, 0.5, 1e-10,
            check_resample=True)
        return (new_st, key), eig[best]

    @jax.jit
    def run(st, key):
        (f, _), eigs = jax.lax.scan(step, (st, key),
                                    jnp.arange(args.steps))
        return f, eigs

    k_run = jax.random.key(1)
    final, _ = run(state, k_run)
    jax.block_until_ready(final.weights)  # compile + warm

    t0 = time.perf_counter()
    final, eigs = run(state, k_run)
    jax.block_until_ready(final.weights)
    dt = time.perf_counter() - t0

    est = float(final.weights @ final.locations[:, 0])
    # each step evaluates the likelihood grid over n_cand candidates AND
    # performs one posterior update: count the design-scoring work
    scored = n * args.steps * n_cand / dt
    updates = n * args.steps / dt

    print(json.dumps({
        "metric": "expdesign_eig_throughput",
        "n_devices": n_dev,
        "virtual_cpu_mesh": bool(args.virtual),
        "particles": n,
        "steps": args.steps,
        "candidates": n_cand,
        "particle_updates_per_s": round(updates, 1),
        "candidate_scores_per_s": round(scored, 1),
        "posterior_mean": round(est, 5),
        "true": 0.7,
        "wall_s": round(dt, 3),
    }))


if __name__ == "__main__":
    main()
