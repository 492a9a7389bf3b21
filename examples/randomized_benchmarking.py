"""Randomized benchmarking: estimate average gate fidelity from survival
counts.

Reference workflow: ``simple_est_rb`` over (counts, sequence length, shots)
data; posterior over (p, A, B) with region estimation (BASELINE config 3).

    python examples/randomized_benchmarking.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp
import numpy as np

import qinfer_tpu as q


def main(true_p=0.97, true_A=0.49, true_B=0.5, n_shots=100, seed=0):
    # simulate an RB dataset
    rb = q.RandomizedBenchmarkingModel()
    bmodel = q.BinomialModel(rb, n_meas_max=n_shots)
    ms = np.unique(np.logspace(0, 2.5, 25).astype(int))
    eps = {"m": jnp.asarray(ms, dtype=jnp.int32),
           "n_meas": jnp.full((len(ms),), n_shots, dtype=jnp.int32)}
    counts = bmodel.simulate_experiment(
        jax.random.key(seed), jnp.array([[true_p, true_A, true_B]]), eps)[0]
    data = np.stack([np.asarray(counts, dtype=float), ms,
                     np.full(len(ms), n_shots)], axis=1)

    # one-line estimation
    mean, cov, extra = q.simple_est_rb(data, n_particles=8000,
                                       return_all=True, seed=seed)
    updater = extra["updater"]
    std = np.sqrt(np.diag(cov))
    print("posterior over (p, A, B):")
    for name, m_, s_ in zip(["p", "A", "B"], mean, std):
        print(f"  {name} = {q.format_uncertainty(m_, s_)}")
    F = q.p_to_F(mean[0])
    F_err = (1 - 1 / 2) * std[0]
    print(f"avg gate fidelity F = {q.format_uncertainty(float(F), float(F_err))} "
          f"(true {q.p_to_F(true_p):.4f})")

    # credible region over (p, A)
    A_mtx, c = updater.region_est_ellipsoid(0.95, modelparam_slice=slice(0, 2))
    print(f"95% credible ellipsoid center (p, A): {np.round(c, 4)}")
    assert abs(mean[0] - true_p) < 6 * std[0] + 0.01
    return updater


if __name__ == "__main__":
    main()
