"""BASELINE configs 2 and 3: Ramsey+T2 and randomized benchmarking.

Config 2 — "MultiCosineModel / Ramsey estimation with T2 decoherence
nuisance parameter, 50k particles": binomial Ramsey fringes on a fixed
exponential time ladder, conditioned in ONE fully-compiled
``batch_update`` scan.

Config 3 — "RandomizedBenchmarkingModel (0th-order AGF decay), posterior
over (p, A, B) with region estimation": binomial survival counts over a
sequence-length ladder, one scan, then the reference's region
estimators (credible region, MVEE ellipsoid, covariance ellipsoid) on
the committed posterior.

Usage:
    python benchmarks/models_bench.py            # both configs, default backend
    python benchmarks/models_bench.py --cpu
Prints one JSON line per config.
"""

import argparse
import json
import os
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--particles", type=int, default=50_000)
    parser.add_argument("--repeats", type=int, default=8,
                        help="ladder repetitions (total record length = "
                             "repeats x ladder)")
    args = parser.parse_args()

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax

    from qinfer_tpu._cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import qinfer_tpu as q

    n = args.particles
    rng = np.random.default_rng(0)

    def run_config(tag, model, prior, eps_batch, counts, true, names):
        u = q.SMCUpdater(model, n, prior, seed=7)
        outs = jnp.asarray(counts)
        u.batch_update(outs, eps_batch)          # compile + warm
        u.reset()
        t0 = time.perf_counter()
        u.batch_update(outs, eps_batch)
        jax.block_until_ready(u.particle_weights)
        dt = time.perf_counter() - t0
        n_exp = int(outs.shape[0])
        est = np.asarray(u.est_mean())
        sd = np.sqrt(np.diag(np.asarray(u.est_covariance_mtx())))
        z = np.abs(est - true) / np.maximum(sd, 1e-12)
        rec = {
            "metric": f"{tag}_particle_updates_per_s",
            "n_particles": n,
            "n_experiments": n_exp,
            "value": round(n * n_exp / dt, 1),
            "wall_s": round(dt, 4),
            "resamples": int(u.resample_count),
            "max_z_vs_true": round(float(z.max()), 2),
            "est": {k: round(float(v), 4) for k, v in zip(names, est)},
        }
        return u, rec

    # ---- config 2: Ramsey + T2 ----------------------------------------
    n_shots = 20
    ladder = np.minimum(np.asarray([1.2 ** k for k in range(32)]), 30.0)
    ts = np.tile(ladder, args.repeats).astype(np.float32)
    true2 = np.array([0.71, 0.08])
    vis = np.exp(-true2[1] * ts)
    pr0 = vis * np.cos(true2[0] * ts / 2) ** 2 + (1 - vis) / 2
    counts2 = rng.binomial(n_shots, pr0)
    _, rec2 = run_config(
        "ramsey_t2", q.BinomialModel(q.RamseyModel(), n_meas_max=n_shots),
        q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
        {"t": jnp.asarray(ts),
         "n_meas": jnp.full((len(ts),), n_shots, jnp.int32)},
        counts2, true2, ["omega", "Gamma"])
    print(json.dumps(rec2), flush=True)

    # ---- config 3: randomized benchmarking + region estimation --------
    n_shots = 25
    ms = np.tile(np.unique(np.round(1.6 ** np.arange(1, 17))),
                 args.repeats).astype(np.float32)
    true3 = np.array([0.95, 0.5, 0.5])  # (p, A, B)
    p_surv = np.clip(true3[1] * true3[0] ** ms + true3[2], 0.0, 1.0)
    counts3 = rng.binomial(n_shots, p_surv)
    u3, rec3 = run_config(
        "rb", q.BinomialModel(q.RandomizedBenchmarkingModel(),
                              n_meas_max=n_shots),
        q.UniformDistribution([[0.8, 1.0], [0.3, 0.7], [0.3, 0.7]]),
        {"m": jnp.asarray(ms),
         "n_meas": jnp.full((len(ms),), n_shots, jnp.int32)},
        counts3, true3, ["p", "A", "B"])
    # region estimation on the committed posterior (config-3 call-out);
    # warm the jitted weight-sort first so the wall measures the query,
    # not the one-time remote compile
    u3.est_credible_region(0.95)
    t0 = time.perf_counter()
    pts = np.asarray(u3.est_credible_region(0.95))
    A_mvee, c_mvee = u3.region_est_ellipsoid(0.95)
    rec3["region_est"] = {
        "credible_points": int(pts.shape[0]),
        "mvee_center": [round(float(v), 4) for v in np.asarray(c_mvee)],
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    print(json.dumps(rec3), flush=True)


if __name__ == "__main__":
    main()
