"""Regression tests for the round-4 items (VERDICT r3):

* while-loop resample gate pinned against the ``lax.cond`` form on both
  the taken and untaken branch (weak #1 — the gate landed in the round-3
  snapshot commit without its own regression test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as q
from qinfer_tpu.smc import _gated_resample


def _setup(n=256, seed=0):
    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    resampler = q.LiuWestResampler(a=0.98)
    x = prior.sample(jax.random.key(seed), n)
    # a deliberately skewed weight vector so the resample output is
    # nontrivial (not a uniform no-op)
    w = jnp.exp(-10.0 * jnp.linspace(0.0, 1.0, n))
    w = w / jnp.sum(w)
    return model, resampler, w, x


def _cond_form(resampler, model, sub, do_resample, w, x):
    """The reference implementation the while-loop gate replaced: plain
    ``lax.cond`` (reference parity: ``smc.py::SMCUpdater._maybe_resample``
    as a traced branch)."""
    return jax.lax.cond(
        do_resample,
        lambda: resampler.call_with_diagnostics(model, sub, w, x),
        lambda: (w, x, jnp.asarray(0, jnp.int32)),
    )


@pytest.mark.parametrize("taken", [True, False])
def test_gated_resample_matches_cond_form(taken):
    """Identical outputs (weights, locations, fallback count) on the taken
    AND untaken branch, under jit, for the same resample key."""
    model, resampler, w, x = _setup()
    sub = jax.random.key(7)
    do = jnp.asarray(taken)

    w_wl, x_wl, nf_wl = jax.jit(_gated_resample, static_argnums=(0, 1))(
        resampler, model, sub, do, w, x)
    w_c, x_c, nf_c = jax.jit(_cond_form, static_argnums=(0, 1))(
        resampler, model, sub, do, w, x)

    # taken-branch tolerance: the while-body and cond-branch compile as
    # different XLA programs whose fusion choices differ by ~1 ULP in f32
    # (measured max |dx| = 6e-8); the untaken branch must be bit-exact.
    atol = 1e-6 if taken else 0.0
    np.testing.assert_allclose(np.asarray(w_wl), np.asarray(w_c), atol=atol)
    np.testing.assert_allclose(np.asarray(x_wl), np.asarray(x_c), atol=atol)
    assert int(nf_wl) == int(nf_c)
    if taken:
        # the taken branch must actually resample (uniform weights out)
        np.testing.assert_allclose(np.asarray(w_wl),
                                   1.0 / w.shape[0], rtol=1e-6)
        assert not np.allclose(np.asarray(x_wl), np.asarray(x))
    else:
        # the untaken branch must be an exact pass-through
        np.testing.assert_array_equal(np.asarray(w_wl), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(x_wl), np.asarray(x))


def test_gated_resample_traced_predicate_in_scan():
    """The gate must behave correctly when the predicate is data-dependent
    inside a scan (the batch_update shape): alternate taken/untaken trips
    and check each trip against the eager cond evaluation."""
    model, resampler, w, x = _setup(n=128, seed=3)
    sub = jax.random.key(11)
    flags = jnp.asarray([False, True, False, True])

    def body(carry, do):
        cw, cx = carry
        nw, nx, _ = _gated_resample(resampler, model, sub, do, cw, cx)
        return (nw, nx), (nw, nx)

    (_, _), (ws, xs) = jax.jit(
        lambda w0, x0: jax.lax.scan(body, (w0, x0), flags))(w, x)

    cw, cx = w, x
    for i, do in enumerate(np.asarray(flags)):
        cw, cx, _ = _cond_form(resampler, model, sub,
                               jnp.asarray(bool(do)), cw, cx)
        np.testing.assert_allclose(np.asarray(ws[i]), np.asarray(cw),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(xs[i]), np.asarray(cx),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# VERDICT r3 #8: interval-gated resampling in perf_test_scan_batch
# ---------------------------------------------------------------------------

def test_scan_batch_resample_interval():
    """interval=1 gates every step — identical to the ungated default;
    a long interval produces fewer, synchronized resamples but still
    converges (the vmap-mode performance lever)."""
    from qinfer_tpu.perf_testing import perf_test_scan_batch

    model = q.SimplePrecessionModel()
    prior = q.UniformDistribution([[0.0, 1.0]])
    rec0 = perf_test_scan_batch(model, 1024, prior, 40, n_trials=3,
                                seed=9, resample_interval=0)
    rec1 = perf_test_scan_batch(model, 1024, prior, 40, n_trials=3,
                                seed=9, resample_interval=1)
    np.testing.assert_allclose(np.asarray(rec0["loss"]),
                               np.asarray(rec1["loss"]), rtol=1e-5)
    rec8 = perf_test_scan_batch(model, 1024, prior, 40, n_trials=3,
                                seed=9, resample_interval=8)
    # still converges by orders of magnitude despite 1/8 the gate steps
    loss = np.asarray(rec8["loss"])
    assert np.median(loss[:, -1] / np.maximum(loss[:, 0], 1e-30)) < 1e-2
