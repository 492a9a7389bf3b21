"""Tests of :mod:`qinfer_tpu.ops`: resampling primitives and the
reference-parity ``AcceleratedPrecessionModel``.

Reference parity: the correctness check the reference applies to
``gpu_models.py::AcceleratedPrecessionModel`` — its likelihood must equal
the plain model's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qinfer_tpu as q
from qinfer_tpu.ops import (
    systematic_resample_indices,
    AcceleratedPrecessionModel,
)
from qinfer_tpu.ops.resample import ancestor_multiplicities


@pytest.mark.parametrize("n", [4096, 1000])
def test_accelerated_model_matches_plain(key, n):
    """Same likelihood as SimplePrecessionModel at any particle count
    (block-aligned or not), for both outcomes and several times."""
    acc = AcceleratedPrecessionModel()
    plain = q.SimplePrecessionModel()
    mps = jax.random.uniform(key, (n, 1))
    eps = {"t": jnp.array([1.0, 4.0, 9.5])}
    La = np.asarray(acc.likelihood(jnp.array([0, 1]), mps, eps))
    Lp = np.asarray(plain.likelihood(jnp.array([0, 1]), mps, eps))
    assert La.shape == (2, n, 3)
    np.testing.assert_array_equal(La, Lp)


@pytest.mark.parametrize("precision", ["double", "float64"])
def test_accelerated_model_refuses_float64(precision):
    """The reference's float32-only contract."""
    with pytest.raises(ValueError, match="float32"):
        AcceleratedPrecessionModel(precision=precision)
    assert AcceleratedPrecessionModel(precision="single").precision == "float"


def test_accelerated_model_in_smc_loop():
    acc = AcceleratedPrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    u = q.SMCUpdater(acc, 2048, prior, seed=0)
    key = jax.random.key(3)
    for k in range(30):
        t = (9 / 8) ** k / 10
        key, sk = jax.random.split(key)
        o = acc.simulate_experiment(sk, jnp.array([[0.7]]),
                                    {"t": jnp.array([t])})
        u.update(o, {"t": jnp.array([t])})
    std = float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
    assert abs(float(u.est_mean()[0]) - 0.7) < 6 * std + 0.02


def test_ancestor_multiplicities_sum(key):
    w = jax.random.uniform(key, (1000,))
    w = w / w.sum()
    m = ancestor_multiplicities(w, 0.37)
    assert int(m.sum()) == 1000
    assert int(m.min()) >= 0


def test_systematic_resample_indices_unbiased(key):
    w = jnp.array([0.1, 0.2, 0.3, 0.4])
    idx = systematic_resample_indices(key, jnp.tile(w / 4, 4))
    assert idx.shape == (16,)
    # indices sorted and within range
    idx_np = np.asarray(idx)
    assert np.all(np.diff(idx_np) >= 0)
    assert idx_np.min() >= 0 and idx_np.max() < 16

    # unbiasedness: counts proportional to weights over many draws
    w2 = jnp.array([0.05, 0.15, 0.5, 0.3])
    total = np.zeros(4)
    for s in range(200):
        idx = systematic_resample_indices(jax.random.key(s), w2)
        total += np.bincount(np.asarray(idx), minlength=4)
    np.testing.assert_allclose(total / total.sum(), np.asarray(w2),
                               atol=0.01)


def test_systematic_variance_below_multinomial(key):
    """Systematic resampling must have (much) lower multiplicity variance
    than multinomial for the same weights."""
    from qinfer_tpu.resamplers import multinomial_ancestors

    w = jax.random.dirichlet(key, jnp.ones(256))
    sys_counts, mult_counts = [], []
    for s in range(100):
        ks = jax.random.key(1000 + s)
        sys_counts.append(np.bincount(
            np.asarray(systematic_resample_indices(ks, w)), minlength=256))
        mult_counts.append(np.bincount(
            np.asarray(multinomial_ancestors(ks, w)), minlength=256))
    var_sys = np.stack(sys_counts).var(axis=0).mean()
    var_mult = np.stack(mult_counts).var(axis=0).mean()
    assert var_sys < 0.5 * var_mult
