"""Resampler tests. Reference parity: Liu-West behavior checks from
``src/qinfer/tests`` (moment preservation, bootstrap degeneration,
validity postselection)."""

import numpy as np
import jax
import jax.numpy as jnp

import qinfer_tpu as q
from qinfer_tpu.resamplers import (
    LiuWestResampler,
    systematic_ancestors,
    multinomial_ancestors,
)
from qinfer_tpu.utils import weighted_moments


def _cloud(key, n=4000, d=2):
    x = jax.random.normal(key, (n, d)) @ jnp.array([[1.0, 0.3], [0.0, 0.5]])
    x = x + jnp.array([1.0, -2.0])
    logw = -0.5 * jnp.sum(x ** 2, axis=1) * 0.1
    w = jnp.exp(logw)
    return w / w.sum(), x


def test_systematic_ancestors_unbiased(key):
    w = jnp.array([0.1, 0.2, 0.3, 0.4])
    anc = systematic_ancestors(key, w, n_out=100_000)
    counts = np.bincount(np.asarray(anc), minlength=4) / 100_000
    np.testing.assert_allclose(counts, np.asarray(w), atol=0.01)


def test_multinomial_ancestors_unbiased(key):
    w = jnp.array([0.7, 0.1, 0.1, 0.1])
    anc = multinomial_ancestors(key, w, n_out=100_000)
    counts = np.bincount(np.asarray(anc), minlength=4) / 100_000
    np.testing.assert_allclose(counts, np.asarray(w), atol=0.01)


def test_liu_west_preserves_moments(key):
    """Liu-West with shrinkage preserves the weighted mean and covariance in
    expectation (the defining property of the a/h shrinkage choice)."""
    k1, k2 = jax.random.split(key)
    w, x = _cloud(k1)
    model = q.SimplePrecessionModel()  # validity: omega >= 0 (2d: unused col)

    class Free(q.Model):
        def __init__(self):
            super().__init__()

        @property
        def n_modelparams(self):
            return 2

        @property
        def expparams_dtype(self):
            return [("t", "float32")]

        def n_outcomes(self, expparams=None):
            return 2

        def are_models_valid(self, mps):
            return jnp.ones(jnp.atleast_2d(mps).shape[0], dtype=bool)

        def likelihood(self, outcomes, mps, eps):
            raise NotImplementedError

    mu0, cov0 = weighted_moments(w, x)
    rs = LiuWestResampler(a=0.98)
    new_w, new_x = rs(Free(), k2, w, x)
    mu1, cov1 = weighted_moments(new_w, new_x)
    np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu0), atol=0.1)
    np.testing.assert_allclose(np.asarray(cov1), np.asarray(cov0),
                               rtol=0.25, atol=0.05)
    np.testing.assert_allclose(np.asarray(new_w), 1.0 / len(w), atol=1e-8)


def test_liu_west_bootstrap_degenerate(key):
    """a=1 (h=0) must reduce to plain resampling: every output location is
    one of the inputs."""
    k1, k2 = jax.random.split(key)
    w, x = _cloud(k1, n=500)
    model = q.SimplePrecessionModel()

    class Free(q.Model):
        def __init__(self):
            super().__init__()

        @property
        def n_modelparams(self):
            return 2

        @property
        def expparams_dtype(self):
            return [("t", "float32")]

        def n_outcomes(self, expparams=None):
            return 2

        def are_models_valid(self, mps):
            return jnp.ones(jnp.atleast_2d(mps).shape[0], dtype=bool)

        def likelihood(self, outcomes, mps, eps):
            raise NotImplementedError

    rs = LiuWestResampler(a=1.0, postselect=False)
    _, new_x = rs(Free(), k2, w, x)
    x_np = np.asarray(x)
    new_np = np.asarray(new_x)
    # each resampled point equals some original point
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(x_np).query(new_np)
    assert dist.max() < 1e-5


def test_liu_west_respects_validity(key):
    """With a constrained model, all resampled particles must be valid."""
    k1, k2 = jax.random.split(key)
    model = q.SimplePrecessionModel(min_freq=0.0)
    # cloud hugging the boundary omega >= 0
    x = jnp.abs(jax.random.normal(k1, (2000, 1))) * 0.01
    w = jnp.full((2000,), 1 / 2000)
    rs = LiuWestResampler(a=0.9, maxiter=10)
    _, new_x = rs(model, k2, w, x)
    valid = np.asarray(model.are_models_valid(new_x))
    assert valid.all()


def test_liu_west_multinomial_kind(key):
    k1, k2 = jax.random.split(key)
    w, x = _cloud(k1, n=1000)
    model = q.MultiCosineModel(2)
    rs = LiuWestResampler(a=0.98, kind="multinomial")
    new_w, new_x = rs(model, k2, jnp.abs(x[:, :1].ravel()) /
                      jnp.sum(jnp.abs(x[:, :1])), jnp.abs(x))
    assert new_x.shape == x.shape
    assert bool(jnp.all(jnp.isfinite(new_x)))


def test_liu_west_canonicalizes(key):
    """Resampled multi-cos particles come out sorted (canonical form)."""
    k1, k2 = jax.random.split(key)
    model = q.MultiCosineModel(2)
    x = jax.random.uniform(k1, (500, 2))
    w = jnp.full((500,), 1 / 500)
    rs = LiuWestResampler(a=0.95)
    _, new_x = rs(model, k2, w, x)
    new_np = np.asarray(new_x)
    assert np.all(new_np[:, 0] <= new_np[:, 1] + 1e-6)


def test_gather_free_resample_locations_matches_ancestors(key):
    """systematic_resample_locations (payload-through-sort, gather-free)
    must agree exactly with locations[systematic_ancestors(...)]."""
    from qinfer_tpu.resamplers import systematic_resample_locations

    for seed in range(4):
        n = 513
        w = jax.random.dirichlet(jax.random.key(seed), jnp.ones(n))
        x = jax.random.normal(jax.random.key(seed + 50), (n, 3))
        k = jax.random.key(seed + 100)
        ref = x[systematic_ancestors(k, w)]
        got = systematic_resample_locations(k, w, x)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-6)


def test_gather_free_one_hot_weights(key):
    from qinfer_tpu.resamplers import systematic_resample_locations

    w = jnp.zeros(128).at[37].set(1.0)
    x = jnp.arange(128.0)[:, None]
    got = systematic_resample_locations(key, w, x)
    assert bool(jnp.all(got == 37.0))


def test_liu_west_high_dim_uses_gather_path(key):
    """d > 4 exercises the ancestors+gather fallback inside LiuWest."""
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (512, 6))
    w = jax.random.dirichlet(k2, jnp.ones(512))

    class Free6(q.Model):
        def __init__(self):
            super().__init__()

        @property
        def n_modelparams(self):
            return 6

        @property
        def expparams_dtype(self):
            return [("t", "float32")]

        def n_outcomes(self, expparams=None):
            return 2

        def are_models_valid(self, mps):
            return jnp.ones(jnp.atleast_2d(mps).shape[0], dtype=bool)

        def likelihood(self, outcomes, mps, eps):
            raise NotImplementedError

    rs = LiuWestResampler(a=0.98)
    new_w, new_x = rs(Free6(), key, w, x)
    assert new_x.shape == (512, 6)
    assert bool(jnp.all(jnp.isfinite(new_x)))


def test_resampler_constructible_inside_jit(key):
    """Constructing LiuWestResampler under a jit trace must not leak
    tracers into static config (math.sqrt, not jnp.sqrt)."""
    import qinfer_tpu as q

    model = q.SimplePrecessionModel()

    @jax.jit
    def f(k, w, x):
        rs = LiuWestResampler(a=0.95)
        return rs(model, k, w, x)

    w = jnp.full((256,), 1 / 256)
    x = jnp.abs(jax.random.normal(key, (256, 1)))
    new_w, new_x = f(key, w, x)
    assert bool(jnp.all(jnp.isfinite(new_x)))


def test_gather_free_no_zero_injection_at_scale():
    """Float32 regression: at large n, the last stratified position
    (n-1+u)/n rounds to exactly 1.0f for u near 1 and would tie with
    cdf[-1]; without the strict-below-one clamp the final output slot
    received an all-zeros payload (code-review finding, round 1)."""
    from qinfer_tpu.resamplers import systematic_resample_locations

    n = 1 << 21
    w = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
    x = jnp.full((n, 1), 7.0, dtype=jnp.float32)
    # hunt for a key whose uniform draw lands in the dangerous u-range
    found_dangerous = False
    for s in range(64):
        k = jax.random.key(s)
        u = float(jax.random.uniform(k, ()))
        if u >= 0.94:
            found_dangerous = True
            got = systematic_resample_locations(k, w, x)
            assert float(got[-1, 0]) == 7.0, (
                f"zero injected at seed {s} (u={u:.4f})")
    assert found_dangerous, "no seed hit the dangerous u range; widen scan"


def test_counting_matches_merge_rank():
    """Sort-free counting formulation agrees with the merge-rank inversion
    up to float32 boundary ties, and the direct-locations variant equals
    its own ancestors' gather exactly."""
    from qinfer_tpu import resamplers as R

    rng = np.random.default_rng(7)
    for trial in range(8):
        n = 2000
        w = rng.gamma(0.3, size=n).astype(np.float32)
        if trial % 3 == 0:
            w[rng.choice(n, n // 2, replace=False)] = 0.0
        w = w / w.sum()
        k = jax.random.key(trial)
        a_sort = np.asarray(R.systematic_ancestors(k, jnp.asarray(w)))
        a_cnt = np.asarray(
            R.systematic_ancestors_counting(k, jnp.asarray(w)))
        assert np.mean(a_sort != a_cnt) < 2e-3
        locs = rng.normal(size=(n, 3)).astype(np.float32)
        out = np.asarray(R.systematic_resample_locations_counting(
            k, jnp.asarray(w), jnp.asarray(locs)))
        # telescoping-fill reconstruction is exact up to f32 cancellation
        # (ulp-level)
        np.testing.assert_allclose(out, locs[a_cnt], atol=1e-5)


def test_counting_point_mass_and_uniform():
    from qinfer_tpu import resamplers as R

    w = np.zeros(500, np.float32)
    w[123] = 1.0
    a = np.asarray(
        R.systematic_ancestors_counting(jax.random.key(0), jnp.asarray(w)))
    assert (a == 123).all()
    # uniform weights: systematic resampling is a no-op permutation-free
    # identity (each particle gets exactly one copy)
    wu = jnp.full((512,), 1 / 512, jnp.float32)
    au = np.asarray(
        R.systematic_ancestors_counting(jax.random.key(1), wu))
    np.testing.assert_array_equal(au, np.arange(512))


def test_counting_fill_strategies_agree():
    """Both forward-fill strategies (associative_scan, telescoping
    scatter-add + cumsum) must reconstruct the same resample."""
    from qinfer_tpu import resamplers as R

    rng = np.random.default_rng(3)
    for trial in range(6):
        n = 5000
        w = rng.gamma(0.3, size=n).astype(np.float32)
        if trial % 2 == 0:
            w[rng.choice(n, n // 2, replace=False)] = 0.0
        w = w / w.sum()
        locs = (rng.normal(size=(n, 3)) * 0.01 + 7.0).astype(np.float32)
        u = jnp.asarray(float(rng.uniform()))
        a = np.asarray(R.counting_locations_from_u(
            u, jnp.asarray(w), jnp.asarray(locs), strategy="scan"))
        b = np.asarray(R.counting_locations_from_u(
            u, jnp.asarray(w), jnp.asarray(locs), strategy="telescope"))
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_counting_multiplicities_monotone_under_parallel_cumsum():
    """Review/debug regression: XLA's parallel cumsum can make prefix sums
    dip by an ulp; the cummax guard must keep every multiplicity >= 0."""
    from qinfer_tpu import resamplers as R

    rng = np.random.default_rng(0)
    for trial in range(10):
        n = 1 << 17
        w = rng.gamma(0.3, size=n).astype(np.float32)
        w = w / w.sum()
        m, offs = (np.asarray(v) for v in R.counting_multiplicities_from_u(
            jnp.asarray(float(rng.uniform())), jnp.asarray(w), n))
        assert m.min() >= 0
        assert m.sum() == n
        assert (np.diff(offs) >= 0).all()
