"""Adaptive frequency estimation with the particle guess heuristic.

The canonical QInfer workflow (reference: the precession examples of the
companion qinfer-examples repo): estimate a qubit's precession frequency ω
from single-shot measurements, choosing each evolution time adaptively with
PGH. Runs in a few seconds on CPU.

    python examples/frequency_estimation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp
import numpy as np

import qinfer_tpu as q


def main(n_particles=4000, n_experiments=75, true_omega=0.703, seed=0):
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    updater = q.SMCUpdater(model, n_particles, prior, seed=seed)
    heuristic = q.PGH(updater)

    key = jax.random.key(seed + 1)
    true_mps = jnp.array([[true_omega]])
    for idx in range(n_experiments):
        eps = heuristic(idx)
        key, k_sim = jax.random.split(key)
        outcome = model.simulate_experiment(k_sim, true_mps, eps)
        updater.update(outcome, eps)
        if (idx + 1) % 15 == 0:
            mean = float(updater.est_mean()[0])
            std = float(jnp.sqrt(updater.est_covariance_mtx()[0, 0]))
            print(f"  after {idx+1:3d} experiments: "
                  f"{q.format_uncertainty(mean, std)}")

    mean = float(updater.est_mean()[0])
    std = float(jnp.sqrt(updater.est_covariance_mtx()[0, 0]))
    region = updater.est_credible_region(0.95).ravel()
    lo, hi = region.min(), region.max()
    print(f"\ntrue omega      : {true_omega}")
    print(f"posterior       : {q.format_uncertainty(mean, std)}")
    print(f"95% credible    : [{lo:.4f}, {hi:.4f}]")
    print(f"resamples       : {updater.resample_count}, "
          f"ESS {updater.n_ess:.0f}/{n_particles}")
    assert abs(mean - true_omega) < 6 * std + 1e-3
    return updater


if __name__ == "__main__":
    main()
