"""Tests that need the card. They skip elsewhere and run on the GPU inside
``python chip_smoke.py`` (phase ``tests``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as q

pytestmark = pytest.mark.gpu


def test_gpu_fill_is_gather_and_exact(gpu):
    from qinfer_tpu.resamplers import (_default_fill_strategy,
                                       counting_locations_from_u,
                                       counting_multiplicities_from_u)

    n, d = 1 << 20, 2
    assert _default_fill_strategy(d) == "gather"
    x = jax.random.normal(jax.random.key(0), (n, d))
    w = jax.nn.softmax(jax.random.normal(jax.random.key(1), (n,)))
    got = np.asarray(counting_locations_from_u(0.3, w, x))
    m, _ = counting_multiplicities_from_u(0.3, w, n)
    np.testing.assert_array_equal(
        got, np.repeat(np.asarray(x), np.asarray(m), axis=0))


def test_gpu_process_likelihood_is_full_float32(gpu):
    """The 256-wide Born-rule dot must not run in TF32."""
    import qinfer_tpu.tomography as tomo

    model = tomo.TomographyModel(tomo.pauli_basis(4))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4096, 255)) * 0.02).astype(np.float32)
    e = (rng.standard_normal((2, 256)) * 0.3).astype(np.float32)
    e[:, 0] = 0.25
    got = np.asarray(model.likelihood(jnp.array([0]), jnp.asarray(x),
                                      {"meas": jnp.asarray(e)}))[0]
    full = np.concatenate([np.full((4096, 1), 0.25), x], 1)
    want = np.clip(full @ e.T.astype(np.float64), 0.0, 1.0)
    assert np.abs(got - want).max() < 1e-5


def test_gpu_canonicalize_two_qubit_channel_is_psd(gpu):
    import qinfer_tpu.tomography as tomo

    basis = tomo.pauli_basis(4)  # embedded d = 32
    model = tomo.TomographyModel(basis)
    mp = tomo.GinibreDistribution(basis).sample(jax.random.key(0), 2048)
    out = model.canonicalize(1.5 * mp)
    rho = np.asarray(model.modelparams_to_states(out), np.complex128)
    assert np.linalg.eigvalsh(rho).min() > -1e-5


def test_gpu_updater_lives_on_the_card(gpu):
    """One card: the updater's ensemble lives on it."""
    u = q.SMCUpdater(q.SimplePrecessionModel(), 4096,
                     q.UniformDistribution([[0.0, 1.0]]), seed=0)
    assert u.particle_weights.devices() == {gpu}
