"""Bayesian model selection via the log-evidence record.

The reference workflow (``src/qinfer/smc.py::SMCUpdater.log_total_likelihood``
/ ``normalization_record``; highlighted in the QInfer paper's model-selection
section): run one updater per candidate model on the SAME data record and
compare total evidence. Here the data come from a decohering (T2-damped)
Ramsey experiment; the candidates are the pure precession model (wrong) and
the damped model (right). The log Bayes factor should favor the damped model.

    python examples/model_selection.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp
import numpy as np

import qinfer_tpu as q


def main(n_particles=4000, n_times=40, n_shots=50, true_omega=0.71,
         true_t2inv=0.08, seed=0):
    # counts out of n_shots at each evolution time — the realistic Ramsey
    # record (and the reference's BinomialModel decorator pattern)
    damped = q.BinomialModel(q.RamseyModel(), n_meas_max=n_shots)
    pure = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=n_shots)

    prior_damped = q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]])
    prior_pure = q.UniformDistribution([[0.0, 1.0]])

    u_damped = q.SMCUpdater(damped, n_particles, prior_damped, seed=seed)
    u_pure = q.SMCUpdater(pure, n_particles, prior_pure, seed=seed)

    # shared data record: exponentially sparse times, simulated from the
    # TRUE (damped) dynamics
    key = jax.random.key(seed + 1)
    true_mps = jnp.array([[true_omega, true_t2inv]])
    ts = np.asarray([1.15 ** k for k in range(n_times)], dtype=np.float32)
    ts = np.minimum(ts, 40.0)
    eps_all = {"t": jnp.asarray(ts),
               "n_meas": jnp.full((n_times,), n_shots, dtype=jnp.int32)}
    key, k_sim = jax.random.split(key)
    outcomes = damped.simulate_experiment(k_sim, true_mps, eps_all)
    outcomes = jnp.asarray(outcomes).reshape(-1)

    # one on-device scan per candidate model over the same record
    u_damped.batch_update(outcomes, eps_all, resample_interval=5)
    u_pure.batch_update(outcomes, eps_all, resample_interval=5)

    log_bf = u_damped.log_total_likelihood - u_pure.log_total_likelihood
    est = np.asarray(u_damped.est_mean())
    sig = np.sqrt(np.diag(np.asarray(u_damped.est_covariance_mtx())))
    print(f"damped log evidence: {u_damped.log_total_likelihood:+.2f}")
    print(f"pure   log evidence: {u_pure.log_total_likelihood:+.2f}")
    print(f"log Bayes factor (damped - pure): {log_bf:+.2f}")
    print(f"damped-model estimate: omega={est[0]:.4f}±{sig[0]:.4f} "
          f"(true {true_omega}), Gamma={est[1]:.4f}±{sig[1]:.4f} "
          f"(true {true_t2inv})")
    return log_bf


if __name__ == "__main__":
    main()
