"""Numerical utilities.

Reference parity: ``src/qinfer/utils.py`` (``binomial_pdf``, ``multinomial_pdf``,
``sample_multinomial``, ``outer_product``, ``particle_meanfn``,
``particle_covariance_mtx``, ``in_ellipsoid``, ``ellipsoid_volume``, ``mvee``,
``uniquify``, ``assert_sigfigs_equal``, ``format_uncertainty``, ``compactspace``,
``to_simplex`` / ``from_simplex``, ``safe_shape``) and
``src/qinfer/finite_difference.py::FiniteDifference`` lives in
:mod:`qinfer_tpu.finite_difference`.

Design: everything that sits on the SMC hot path (weighted moments,
pmfs, simplex transforms, PSD matrix square roots) is pure ``jax.numpy`` and
jit/vmap/shard_map-compatible, with reductions phrased as matmuls. Small
host-side geometry (MVEE, ellipsoid volume) stays
NumPy/SciPy, exactly as in the reference, because it runs once on a handful of
hull vertices, not per-particle.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .config import EPS

__all__ = [
    # pmfs / sampling
    "binomial_pdf", "log_binomial_pdf", "multinomial_pdf", "sample_multinomial",
    # moments
    "outer_product", "particle_meanfn", "particle_mean",
    "particle_covariance_mtx", "weighted_moments", "n_ess",
    # linear algebra
    "sqrtm_psd",
    # ellipsoids / regions (host-side)
    "in_ellipsoid", "ellipsoid_volume", "mvee",
    # simplex
    "to_simplex", "from_simplex",
    # misc
    "uniquify", "assert_sigfigs_equal", "format_uncertainty", "compactspace",
    "safe_shape", "join_struct_arrays",
]


# ---------------------------------------------------------------------------
# Probability mass functions
# ---------------------------------------------------------------------------

def log_binomial_pdf(N, n, p):
    """log Pr(n | N, p) for a binomial distribution, numerically stable.

    All arguments broadcast. Interior ``p`` is clipped away from {0, 1} so
    gradients stay finite, but EXACTLY impossible outcomes (successes with
    p = 0, failures with p = 1) return ``-inf`` — reference parity with
    the f64 linear pmf, whose exact zero is what trips the engine's
    zero-weight policy (``smc.py::SMCUpdater.update`` zero_weight_policy;
    the log-space engine detects impossibility as a non-finite weighted
    max, not via an arbitrary nat threshold that would misclassify
    legitimately-terrible fits).
    """
    N = jnp.asarray(N)
    n = jnp.asarray(n)
    p = jnp.asarray(p)
    pc = jnp.clip(p, EPS, 1.0 - 1e-7)
    log_comb = gammaln(N + 1.0) - gammaln(n + 1.0) - gammaln(N - n + 1.0)
    logp = log_comb + n * jnp.log(pc) + (N - n) * jnp.log1p(-pc)
    impossible = ((p <= 0.0) & (n > 0)) | ((p >= 1.0) & (n < N))
    return jnp.where(impossible, -jnp.inf, logp)


def binomial_pdf(N, n, p):
    """Pr(n | N, p) for a binomial distribution.

    Reference parity: ``src/qinfer/utils.py::binomial_pdf`` (same argument
    order: number of trials, number of successes, success probability).
    """
    return jnp.exp(log_binomial_pdf(N, n, p))


def multinomial_pdf(n, p):
    """Pr(n | p) for a multinomial with counts ``n`` (..., k) and category
    probabilities ``p`` (..., k). The total count is ``n.sum(-1)``.

    Reference parity: ``src/qinfer/utils.py::multinomial_pdf``.
    """
    n = jnp.asarray(n)
    p = jnp.clip(jnp.asarray(p), EPS, 1.0)
    N = jnp.sum(n, axis=-1)
    log_pmf = (
        gammaln(N + 1.0)
        - jnp.sum(gammaln(n + 1.0), axis=-1)
        + jnp.sum(n * jnp.log(p), axis=-1)
    )
    return jnp.exp(log_pmf)


def sample_multinomial(key, N, p, shape=()):
    """Draw multinomial count vectors.

    Reference parity: ``src/qinfer/utils.py::sample_multinomial`` (the
    reference uses ``np.random.multinomial``; here the draw is a JAX-native
    categorical + one-hot sum so it stays jittable and static-shaped).

    :param key: PRNG key.
    :param int N: total count per draw (static).
    :param p: (k,) category probabilities.
    :param shape: leading batch shape of independent draws.
    :return: integer array of shape ``shape + (k,)`` summing to N along -1.
    """
    p = jnp.asarray(p)
    k = p.shape[-1]
    cats = jax.random.categorical(
        key, jnp.log(jnp.clip(p, EPS, 1.0)), shape=shape + (N,)
    )
    return jnp.sum(jax.nn.one_hot(cats, k, dtype=jnp.int32), axis=-2)


# ---------------------------------------------------------------------------
# Weighted particle moments — the workhorse reductions of the SMC engine.
# Phrased as matmuls (one library GEMM each at large particle counts).
# ---------------------------------------------------------------------------

def outer_product(x):
    """x xᵀ for a vector x. Reference parity: ``utils.py::outer_product``."""
    x = jnp.asarray(x)
    return jnp.outer(x, x)


def particle_mean(weights, locations):
    """Weighted mean  Σᵢ wᵢ xᵢ  of a particle cloud.

    ``weights``: (n,), ``locations``: (n, d) → (d,).
    """
    return weights @ locations


def particle_meanfn(weights, locations, fn=None):
    """Weighted mean of ``fn`` over particles: Σᵢ wᵢ f(xᵢ).

    Reference parity: ``src/qinfer/utils.py::particle_meanfn``. ``fn`` maps a
    single (d,) location to an arbitrary pytree/array; it is vmapped over the
    particle axis.
    """
    if fn is None:
        return particle_mean(weights, locations)
    fx = jax.vmap(fn)(locations)
    return jax.tree_util.tree_map(
        lambda leaf: jnp.tensordot(weights, leaf, axes=1), fx
    )


@jax.jit
def particle_covariance_mtx(weights, locations):
    """Weighted covariance  Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ  of a particle cloud.

    Reference parity: ``src/qinfer/utils.py::particle_covariance_mtx`` (same
    definition: plain weighted second central moment, no Bessel correction).

    Implemented as  Xᵀ diag(w) X − μμᵀ  in centred form — one matmul.
    Jitted: host-facing callers (``est_covariance_mtx``) otherwise pay one
    dispatch per op.
    """
    weights = jnp.asarray(weights)
    locations = jnp.asarray(locations)
    mu = weights @ locations
    xc = locations - mu[None, :]
    return (xc * weights[:, None]).T @ xc


def weighted_moments(weights, locations):
    """(mean, covariance) in one pass; used by the resampler and estimators."""
    mu = weights @ locations
    xc = locations - mu[None, :]
    cov = (xc * weights[:, None]).T @ xc
    return mu, cov


def n_ess(weights):
    """Effective sample size 1 / Σ wᵢ² of normalized weights.

    Reference parity: ``src/qinfer/smc.py::SMCUpdater.n_ess``.
    """
    return 1.0 / jnp.sum(weights * weights)


# ---------------------------------------------------------------------------
# PSD linear algebra
# ---------------------------------------------------------------------------

def sqrtm_psd(A, eps=1e-12):
    """Symmetric PSD matrix square root via eigendecomposition, with
    eigenvalue clipping.

    The reference uses ``scipy.linalg.sqrtm`` with ad-hoc PSD fix-ups
    (``src/qinfer/resamplers.py::LiuWestResampler.__call__``); on device an
    ``eigh`` is the natural primitive and the clip handles the same
    numerically-indefinite covariance cases.
    """
    A = jnp.asarray(A)
    A = 0.5 * (A + A.T)
    evals, evecs = jnp.linalg.eigh(A)
    evals = jnp.clip(evals, eps, None)
    return (evecs * jnp.sqrt(evals)[None, :]) @ evecs.T


# ---------------------------------------------------------------------------
# Ellipsoids & MVEE (host-side geometry, matching reference behavior)
# ---------------------------------------------------------------------------

def in_ellipsoid(x, A, c):
    """True where points ``x`` (..., d) lie inside the ellipsoid
    (x−c)ᵀ A⁻¹ (x−c) ≤ 1.

    Reference parity: ``src/qinfer/utils.py::in_ellipsoid`` (same convention:
    ``A`` is the shape/covariance matrix, so membership inverts it).
    """
    x = np.asarray(x)
    A = np.asarray(A)
    c = np.asarray(c)
    d = x - c
    sol = np.linalg.solve(A, d[..., :, None])[..., 0]
    return np.einsum("...i,...i->...", d, sol) <= 1.0 + 1e-9


def ellipsoid_volume(A=None, invA=None):
    """Volume of the ellipsoid xᵀ A⁻¹ x ≤ 1 (or given its inverse matrix).

    Reference parity: ``src/qinfer/utils.py::ellipsoid_volume``.
    """
    import scipy.special as sp

    if invA is None and A is None:
        raise ValueError("Must specify either A or invA.")
    if invA is None:
        invA = np.linalg.inv(np.asarray(A))
    d = invA.shape[0]
    unit_ball = np.pi ** (d / 2.0) / sp.gamma(d / 2.0 + 1.0)
    return unit_ball / np.sqrt(np.linalg.det(invA))


def mvee(points, tol=1e-3, max_iter=10_000):
    """Khachiyan's algorithm for the Minimum-Volume Enclosing Ellipsoid of a
    point set.

    Reference parity: ``src/qinfer/utils.py::mvee`` — same algorithm, same
    return convention ``(A, c)`` with the ellipsoid
    {x : (x−c)ᵀ A (x−c) ≤ 1}.

    Host-side NumPy by design: this runs on O(hull vertices) points once per
    region query, never per particle (SURVEY.md §7 "host-side escape hatches").
    """
    points = np.asarray(points, dtype=np.float64)
    N, d = points.shape
    Q = np.column_stack((points, np.ones(N))).T  # (d+1, N)

    u = np.full(N, 1.0 / N)
    err = tol + 1.0
    it = 0
    while err > tol and it < max_iter:
        X = Q @ np.diag(u) @ Q.T
        M = np.einsum("ij,ji->i", Q.T, np.linalg.solve(X, Q))
        j = int(np.argmax(M))
        step = (M[j] - d - 1.0) / ((d + 1.0) * (M[j] - 1.0))
        new_u = (1.0 - step) * u
        new_u[j] += step
        err = np.linalg.norm(new_u - u)
        u = new_u
        it += 1

    c = points.T @ u
    A = (
        np.linalg.inv(points.T @ np.diag(u) @ points - np.outer(c, c)) / d
    )
    return A, c


# ---------------------------------------------------------------------------
# Simplex transforms (for multinomial-valued model parameters)
# ---------------------------------------------------------------------------

def to_simplex(y):
    """Map unconstrained (..., k−1) stick-breaking coordinates in (0,1) to the
    probability simplex (..., k).

    Reference parity: ``src/qinfer/utils.py::to_simplex`` (stick-breaking).
    """
    y = jnp.asarray(y)
    # cumulative product of remaining stick lengths
    rem = jnp.cumprod(1.0 - y, axis=-1)
    rem = jnp.concatenate(
        [jnp.ones_like(y[..., :1]), rem], axis=-1
    )  # (..., k)
    sticks = jnp.concatenate([y, jnp.ones_like(y[..., :1])], axis=-1)
    return rem * sticks


def from_simplex(p):
    """Inverse of :func:`to_simplex`: simplex points (..., k) to stick-breaking
    coordinates (..., k−1)."""
    p = jnp.asarray(p)
    rem = 1.0 - jnp.cumsum(p[..., :-1], axis=-1)
    rem = jnp.concatenate(
        [jnp.ones_like(p[..., :1]), rem[..., :-1]], axis=-1
    )
    return jnp.clip(p[..., :-1] / jnp.clip(rem, EPS, None), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Misc small helpers
# ---------------------------------------------------------------------------

def uniquify(seq):
    """Order-preserving de-duplication. Reference parity: ``utils.py::uniquify``."""
    seen = set()
    out = []
    for item in seq:
        if item not in seen:
            seen.add(item)
            out.append(item)
    return out


def assert_sigfigs_equal(x, y, sigfigs=3):
    """Assert two arrays agree to ``sigfigs`` significant figures.

    Reference parity: ``src/qinfer/utils.py::assert_sigfigs_equal`` — used by
    the Monte-Carlo-tolerant test suite.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    mag = np.floor(np.log10(np.maximum(np.abs(x), np.abs(y)) + 1e-300))
    scale = 10.0 ** (mag - sigfigs + 1)
    np.testing.assert_array_almost_equal(x / scale, y / scale, decimal=0)


def format_uncertainty(value, uncertainty, scinotn_break=4):
    """Format ``value ± uncertainty`` keeping digits justified by the
    uncertainty, e.g. ``format_uncertainty(0.12345, 0.002)`` → ``'0.123 ± 0.002'``.

    Reference parity: ``src/qinfer/utils.py::format_uncertainty``.
    """
    value = float(value)
    uncertainty = float(uncertainty)
    if uncertainty <= 0 or not np.isfinite(uncertainty):
        return "{0}".format(value)
    mag_unc = int(np.floor(np.log10(uncertainty)))
    mag_val = int(np.floor(np.log10(abs(value)))) if value != 0 else 0
    if abs(mag_val) < scinotn_break and abs(mag_unc) < scinotn_break:
        digits = max(0, -mag_unc)
        return "{0:.{d}f} ± {1:.{d}f}".format(value, uncertainty, d=digits)
    # scientific notation relative to the value's magnitude
    scaled_val = value / 10.0 ** mag_val
    scaled_unc = uncertainty / 10.0 ** mag_val
    digits = max(0, mag_val - mag_unc)
    return "({0:.{d}f} ± {1:.{d}f}) × 10^{2}".format(
        scaled_val, scaled_unc, mag_val, d=digits
    )


def compactspace(scale, n):
    """n points spanning the whole real line, compactified via arctanh — used
    for plotting marginals over unbounded parameters.

    Reference parity: ``src/qinfer/utils.py::compactspace``.
    """
    interior = np.linspace(-1.0, 1.0, n + 2)[1:-1]
    return scale * np.arctanh(interior)


def safe_shape(arr, idx=0, default=1):
    """``arr.shape[idx]`` if it exists, else ``default``.

    Reference parity: ``src/qinfer/utils.py::safe_shape``.
    """
    shape = np.shape(arr)
    return shape[idx] if len(shape) > idx else default


def join_struct_arrays(arrays):
    """Concatenate NumPy structured arrays field-wise into one structured
    array (host-side interop helper).

    Reference parity: ``src/qinfer/utils.py::join_struct_arrays``.
    """
    dtype = sum((a.dtype.descr for a in arrays), [])
    out = np.empty(len(arrays[0]), dtype=dtype)
    for a in arrays:
        for name in a.dtype.names:
            out[name] = a[name]
    return out
