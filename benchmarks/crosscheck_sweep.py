"""Randomized posterior cross-check sweep vs the independent f64 NumPy SMC.

Extends `tests/test_crosscheck_numpy.py`'s fixed matched-config checks to
RANDOM configurations (shots, particle counts, record lengths, true
parameters, time scales) of the precession+binomial family: both engines
condition on the same fixed data record, so their posterior means must
agree within combined Monte-Carlo error (z < 4) and posterior sds to
~50%.

    python benchmarks/crosscheck_sweep.py [--trials 20]

Prints one line per trial and a final JSON summary.
"""

import argparse
import json
import os
import sys


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--ref-seeds", type=int, default=6)
    parser.add_argument("--cpu", action="store_true",
                        help="run the qinfer_tpu side on the CPU "
                        "(default: JAX's default backend)")
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from scipy.stats import binom

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tests"))
    import qinfer_tpu as q
    from test_crosscheck_numpy import numpy_smc, _moments

    rng_master = np.random.default_rng(2024)
    results = []
    for trial in range(args.trials):
        r = rng_master
        n_particles = int(r.integers(2000, 6000))
        n_shots = int(r.integers(1, 30))
        n_exp = int(r.integers(10, 40))
        true_omega = float(r.uniform(0.1, 0.9))
        scale = float(r.uniform(0.2, 3.0))
        ts = np.minimum(
            np.asarray([scale * 1.15 ** k for k in range(n_exp)]), 60.0)
        counts = r.binomial(n_shots, np.cos(true_omega * ts / 2) ** 2)

        def np_lik(outcome, x, t, n_shots=n_shots):
            return binom.pmf(outcome, n_shots,
                             np.cos(x[:, 0] * t / 2) ** 2)

        model = q.BinomialModel(q.SimplePrecessionModel(),
                                n_meas_max=n_shots)
        u = q.SMCUpdater(model, n_particles,
                         q.UniformDistribution([[0.0, 1.0]]), seed=trial)
        eps = {"t": jnp.asarray(ts, jnp.float32),
               "n_meas": jnp.full((n_exp,), n_shots, jnp.int32)}
        u.batch_update(jnp.asarray(counts), eps)
        mu_t = float(u.est_mean()[0])
        sd_t = float(np.sqrt(u.est_covariance_mtx()[0, 0]))

        mus, sds = [], []
        for s in range(args.ref_seeds):
            w, x = numpy_smc(
                np_lik, lambda rg, n: rg.uniform(0, 1, (n, 1)),
                lambda x: (x[:, 0] >= 0) & (x[:, 0] <= 1),
                counts, list(ts), n_particles,
                seed=500 + 31 * trial + s)
            mu, cov = _moments(w, x)
            mus.append(mu[0])
            sds.append(np.sqrt(cov[0, 0]))
        mu_ref = float(np.mean(mus))
        se = max(float(np.std(mus, ddof=1)), 0.1 * float(np.mean(sds)))
        z = abs(mu_t - mu_ref) / (np.sqrt(2) * se)
        sd_rel = abs(sd_t - float(np.mean(sds))) / float(np.mean(sds))
        ok = bool(z < 4 and sd_rel < 0.5)
        results.append({"trial": trial, "ok": ok, "z": round(z, 2),
                        "sd_rel": round(sd_rel, 3)})
        print(f"{'OK ' if ok else 'FAIL'} trial {trial}: shots={n_shots} "
              f"n={n_particles} exps={n_exp} z={z:.2f} "
              f"sd_rel={sd_rel:.2f}", flush=True)

    n_ok = sum(rr["ok"] for rr in results)
    print(json.dumps({
        "metric": "crosscheck_sweep",
        "trials": args.trials,
        "passed": n_ok,
        "max_z": max(rr["z"] for rr in results),
        "max_sd_rel": max(rr["sd_rel"] for rr in results),
    }))


if __name__ == "__main__":
    main()
