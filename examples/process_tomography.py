"""Bayesian quantum process tomography of a depolarizing channel.

Reference workflow: ``ProcessTomographyModel`` over the doubled Pauli
basis with a BCSZ random-channel prior — infer a single-qubit channel's
normalized Choi state from prepare-and-measure data, then read off the
depolarizing rate.

    python examples/process_tomography.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp
import numpy as np

import qinfer_tpu as q
from qinfer_tpu import tomography as tomo
from qinfer_tpu.tomography.models import ProcessTomographyModel


def identity_choi():
    """Column-vec Choi matrix of the identity channel (complex, HOST-side
    only — complex arrays never touch the device)."""
    J = np.zeros((4, 4), dtype=np.complex64)
    for m in range(2):
        for n in range(2):
            E_mn = np.zeros((2, 2), dtype=np.complex64)
            E_mn[m, n] = 1
            J += np.kron(E_mn, E_mn)
    return J


def main(n_particles=8000, n_experiments=120, p_dep=0.25, seed=0,
         n_shots=16):
    b1 = tomo.pauli_basis(1)
    b2 = tomo.pauli_basis(2)
    two_outcome = ProcessTomographyModel(b2, b1)
    prior = tomo.BCSZChoiDistribution(b2)

    # true channel: depolarizing with rate p_dep
    J_true = ((1 - p_dep) * identity_choi()
              + p_dep * np.kron(np.eye(2), np.eye(2) / 2))
    true_mps = two_outcome.states_to_modelparams(J_true / 2)

    # The flagship recipe: repeat each
    # fiducial pair `n_shots` times (BinomialModel — the engine updates
    # on the success COUNT at no extra per-step cost) and restore
    # ensemble diversity with exact-posterior Metropolis moves whose
    # record is compressed to per-candidate sufficient statistics
    # (compress_mcmc_record: move cost is O(distinct experiments), not
    # O(record length)). This is what converges 255-parameter two-qubit
    # channels to fidelity 0.98; at dim 4 it reaches ~0.99 in ~120
    # experiments.
    model = q.BinomialModel(two_outcome, n_meas_max=n_shots)
    updater = q.SMCUpdater(model, n_particles, prior, seed=seed,
                           n_mcmc_moves=3, compress_mcmc_record=True)

    # tetrahedral-ish fiducial set: preparations and measurement effects
    kets = np.asarray(
        [[1, 0], [0, 1],
         [1 / np.sqrt(2), 1 / np.sqrt(2)],
         [1 / np.sqrt(2), 1j / np.sqrt(2)]], dtype=np.complex64)
    fid_coords = jnp.asarray(np.stack([
        np.asarray(b1.state_to_modelparams(np.outer(k, k.conj())))
        for k in kets]))  # (4, 4) real coords — device-safe

    # one scanned batch_update over the whole record (a single compiled
    # program; the in-scan rejuvenation rides the same compressed
    # sufficient statistics)
    k1, k2, ks = jax.random.split(jax.random.key(seed + 1), 3)
    eps = {
        "prep": fid_coords[jax.random.randint(k1, (n_experiments,), 0, 4)],
        "meas": fid_coords[jax.random.randint(k2, (n_experiments,), 0, 4)],
        "n_meas": jnp.full((n_experiments,), n_shots, jnp.int32),
    }
    outcomes = model.simulate_experiment(ks, true_mps, eps)[0]
    updater.batch_update(outcomes, eps, resample_interval=5)
    model = two_outcome  # coordinate<->state readout below

    # recovered depolarizing rate from the identity-Choi overlap:
    # Tr[rho_L rho_id] = 1 - 3p/4 for a depolarizing channel. NOTE: with
    # product preparations and two-outcome effects this direction carries
    # little signal per shot (direct entanglement-fidelity estimation
    # needs entangled inputs), so the rate readout converges much more
    # slowly than the Choi fidelity — the BCSZ prior starts at an implied
    # rate ~1.0 and the posterior walks it down.
    est = updater.est_mean()
    F_choi = float(model.fidelity_with(est[None], J_true / 2)[0])
    est_embedded = model.modelparams_to_states(est[None])
    overlap = float(np.real(np.trace(
        np.asarray(est_embedded)[0] @ identity_choi() / 2)))
    p_est = (1.0 - overlap) / 0.75
    print(f"true depolarizing rate : {p_dep:.3f}")
    print(f"estimated rate         : {p_est:.3f}")
    print(f"Choi-state fidelity    : {F_choi:.4f}")
    assert F_choi > 0.93, "Choi state not recovered"
    assert p_est < 0.6, "rate readout did not move off the prior (~1.0)"
    return updater


if __name__ == "__main__":
    main()
