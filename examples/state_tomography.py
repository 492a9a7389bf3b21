"""Bayesian qubit state tomography with adaptive measurement choice.

Reference workflow: ``TomographyModel`` over the Pauli basis with a Ginibre
prior and random-Pauli / best-of-K measurement heuristics (BASELINE
config 4 at laptop scale).

    python examples/state_tomography.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp
import numpy as np

import qinfer_tpu as q
from qinfer_tpu import tomography as tomo


def main(n_particles=5000, n_experiments=120, seed=0):
    basis = tomo.pauli_basis(1)
    model = tomo.TomographyModel(basis)
    prior = tomo.GinibreDistribution(basis)

    # a mildly mixed true state
    true_rho = np.array([[0.85, 0.30], [0.30, 0.15]], dtype=np.complex64)
    true_mps = model.states_to_modelparams(true_rho[None])

    updater = q.SMCUpdater(model, n_particles, prior, seed=seed)
    base = tomo.RandomStabilizerStateHeuristic(updater)
    heuristic = tomo.BestOfKMetaheuristic(updater, base, k=6)

    key = jax.random.key(seed + 1)
    for idx in range(n_experiments):
        eps = heuristic(idx)
        key, k_sim = jax.random.split(key)
        outcome = model.simulate_experiment(k_sim, true_mps, eps)
        updater.update(outcome, eps)
        if (idx + 1) % 30 == 0:
            F = float(model.fidelity_with(
                updater.est_mean()[None], jnp.asarray(true_rho))[0])
            print(f"  after {idx+1:3d} measurements: fidelity {F:.4f}")

    est_rho = np.asarray(model.modelparams_to_states(
        updater.est_mean()[None]))[0]
    F = float(model.fidelity_with(
        updater.est_mean()[None], jnp.asarray(true_rho))[0])
    print("\nestimated state:")
    print(np.round(est_rho, 3))
    print(f"fidelity with truth: {F:.4f}")
    assert F > 0.95
    return updater


if __name__ == "__main__":
    main()
