"""Smoke test of the engine's main path on the GPU.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded precession loop
                                   # and its one-device comparison, only

Phases, all in this one JAX process:

* ``device``: fail unless JAX's first device is a GPU; print its kind and
  the card's name and power limit (``nvidia-smi``, no JAX).
* ``precession``: the headline deployment at its real size —
  ``SimplePrecessionModel``, 2²² particles × 256 PGH steps through
  ``perf_testing.perf_test_scan``, then ``SMCUpdater.batch_update`` on a
  fixed 40-experiment binomial record at 2²² particles, compared with the
  float64 NumPy oracle of ``tests/test_crosscheck_numpy.py``.
* ``tomography``: qubit state tomography at 500k particles (100 updates,
  checked against the oracle) and the two-qubit-channel flagship at 50k
  particles (64-shot fiducials, resample-move with ``mcmc_adapt``) run to
  at least three resample-move events; every flagship particle must be
  PSD to 1e-5.
* ``kernels``: each route the engine takes on the GPU (resample fill, PSD
  projection, Born-rule dot, precession reweight) against its plain
  reference at the real widths, tolerance and precision printed.
* ``tests``: the ``gpu``-marked tests, run in this process.

Every phase raises on failure and nothing is caught, so the exit code is
non-zero and the result line is never printed. The last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: matmul precision of the sites that need float32 (stated per phase)
HIGHEST = "float32 dot at Precision.HIGHEST"
XLA_DEFAULT = "XLA default (float32 elementwise; no matmul)"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size the phases use; :data:`FULL` is the deployment size."""

    prec_particles: int = 1 << 22
    prec_steps: int = 256
    prec_record: int = 40
    oracle_particles: int = 20_000
    tomo_particles: int = 500_000
    tomo_updates: int = 100
    flagship_qubits: int = 2
    flagship_particles: int = 50_000
    flagship_steps: int = 24
    flagship_moves: int = 4
    fill_shapes: tuple = ((1 << 22, 1), (500_000, 3))
    eigh_shapes: tuple = ((50_000, 32), (100_000, 8), (100_000, 16))
    four_particles_per_device: int = 1 << 22


FULL = Sizes()
#: a CPU rehearsal of every phase in seconds (single-qubit channel)
TINY = Sizes(prec_particles=4096, prec_steps=16, oracle_particles=2000,
             tomo_particles=4000, tomo_updates=30, flagship_qubits=1,
             flagship_particles=512, flagship_steps=12, flagship_moves=2,
             fill_shapes=((4096, 1), (2000, 3)),
             eigh_shapes=((256, 32), (512, 8), (512, 16)),
             four_particles_per_device=2048)


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def require_gpu():
    """Raise unless JAX's first device is a GPU: nothing carries on on the
    CPU."""
    import jax

    try:
        dev = jax.devices()[0]
    except (RuntimeError, AssertionError) as err:
        # JAX_PLATFORMS=cuda on a machine without a usable CUDA backend
        raise RuntimeError("no GPU: JAX could not initialise CUDA") from err
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def card_line():
    """The card's name and power limit as nvidia-smi reports them (a
    subprocess that does not use JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_info():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def result_line(info):
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def _oracle():
    """The float64 NumPy oracle and its fixed problems
    (``tests/test_crosscheck_numpy.py``)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_crosscheck_numpy

    return test_crosscheck_numpy


def _timed(label, fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    log(f"  {label}: {time.perf_counter() - t0:.4f} s")
    return out


def _memory(label, compiled):
    mem = compiled.memory_analysis()
    if mem is None:
        log(f"  {label} memory_analysis: none reported")
        return
    log(f"  {label} memory_analysis: "
        f"args {mem.argument_size_in_bytes} B, "
        f"outputs {mem.output_size_in_bytes} B, "
        f"temps {mem.temp_size_in_bytes} B, "
        f"generated code {mem.generated_code_size_in_bytes} B")


def _peak_memory():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_precession(sizes=FULL):
    """Headline loop, then a fixed binomial record against the oracle."""
    import jax
    import jax.numpy as jnp
    import qinfer_tpu as q
    from qinfer_tpu.perf_testing import perf_test_scan
    from qinfer_tpu.smc import _batch_update

    n = sizes.prec_particles
    log(f"[precession] SimplePrecessionModel, {n} particles × "
        f"{sizes.prec_steps} PGH steps (perf_test_scan); {XLA_DEFAULT}")
    updater, record = _timed(
        "perf_test_scan wall (compile included)", perf_test_scan,
        q.SimplePrecessionModel(), n, q.UniformDistribution([[0.0, 1.0]]),
        sizes.prec_steps, true_mps=jnp.array([[0.7]]), seed=0)
    loss = np.asarray(record["loss"])
    est = float(np.asarray(updater.est_mean())[0])
    log(f"  final estimate {est:.6f} (true 0.7), final loss {loss[-1]:.3e}, "
        f"peak device bytes {_peak_memory()}")
    check(np.all(np.isfinite(loss)) and loss.shape == (sizes.prec_steps,),
          f"finite loss of shape ({sizes.prec_steps},): {loss.shape}")
    check(abs(est - 0.7) < 0.05, f"estimate {est} within 0.05 of 0.7")

    oracle = _oracle()
    prob = oracle.precession_binomial_problem(n_exp=sizes.prec_record)
    u = q.SMCUpdater(prob.model, n, prob.prior, seed=7)
    outcomes = jnp.asarray(prob.outcomes)
    eps = prob.model.canonicalize_expparams(prob.eps_batch)
    compiled = _batch_update.lower(
        u.model, u.resampler, u.state, outcomes, eps, u.resample_thresh,
        u.zero_weight_thresh, resample_interval=5).compile()
    _memory("batch_update", compiled)
    _timed(f"batch_update wall ({sizes.prec_record} experiments)",
           u.batch_update, outcomes, prob.eps_batch)
    diag = prob.check(u, sizes.oracle_particles)
    log(f"  oracle (float64 NumPy, 8 seeds × {sizes.oracle_particles}): "
        f"mean {diag['mean']} vs {diag['mean_ref']} (z {diag['z']}, "
        f"limit 4); sd {diag['sd']} vs {diag['sd_ref']} (rel "
        f"{diag['sd_rel_err']}, limit 0.35)")
    return diag


def _flagship(sizes):
    """The process-tomography flagship: depolarizing-0.25 truth, product
    tetrahedral fiducial pool, 64-shot counts, BCSZ prior."""
    import itertools
    from functools import reduce

    import jax
    import jax.numpy as jnp
    import qinfer_tpu as q
    from qinfer_tpu import tomography as tomo

    nq = sizes.flagship_qubits
    dd = 2 ** nq
    b1, b2 = tomo.pauli_basis(nq), tomo.pauli_basis(2 * nq)
    base = tomo.ProcessTomographyModel(b2, b1)
    model = q.BinomialModel(base, n_meas_max=64)
    prior = tomo.BCSZChoiDistribution(b2)
    j_id = np.zeros((dd * dd, dd * dd), dtype=np.complex64)
    for m in range(dd):
        for k in range(dd):
            e = np.zeros((dd, dd), dtype=np.complex64)
            e[m, k] = 1
            j_id += np.kron(e, e)
    p_dep = 0.25
    true_rho = ((1 - p_dep) * j_id
                + p_dep * np.kron(np.eye(dd), np.eye(dd) / dd)) / dd
    true_mps = jnp.asarray(np.asarray(
        base.states_to_modelparams(true_rho[None])))
    kets1 = np.asarray([[1, 0], [0, 1], [1 / np.sqrt(2), 1 / np.sqrt(2)],
                        [1 / np.sqrt(2), 1j / np.sqrt(2)]],
                       dtype=np.complex64)
    fid = np.stack([
        np.asarray(b1.state_to_modelparams(np.outer(k, k.conj())))
        for k in (reduce(np.kron, c)
                  for c in itertools.product(kets1, repeat=nq))])
    # eight distinct fiducial pairs, so the compressed record keeps one
    # shape and the second half of the record runs warm
    rng = np.random.default_rng(11)
    pool = rng.choice(fid.shape[0] ** 2, size=8, replace=False)
    picks = pool[rng.integers(0, 8, size=sizes.flagship_steps)]
    pairs = np.stack([picks // fid.shape[0], picks % fid.shape[0]], 1)
    eps = {"prep": jnp.asarray(fid[pairs[:, 0]], jnp.float32),
           "meas": jnp.asarray(fid[pairs[:, 1]], jnp.float32),
           "n_meas": jnp.full((sizes.flagship_steps,), 64, jnp.int32)}
    counts = jnp.stack([
        jnp.asarray(model.simulate_experiment(
            jax.random.key(100 + i), true_mps,
            {k: v[i:i + 1] for k, v in eps.items()})).reshape(-1)[0]
        for i in range(sizes.flagship_steps)])
    return base, model, prior, eps, counts, true_rho


def phase_tomography(sizes=FULL):
    """Qubit tomography against the oracle; the channel flagship's
    resample-move events and the PSD invariant."""
    import jax.numpy as jnp
    import qinfer_tpu as q

    oracle = _oracle()
    n = sizes.tomo_particles
    log(f"[tomography] qubit state tomography, {n} particles × "
        f"{sizes.tomo_updates} updates; Born rule {HIGHEST}")
    prob = oracle.qubit_tomography_problem(n_exp=sizes.tomo_updates)
    u = q.SMCUpdater(prob.model, n, prob.prior, seed=13)
    _timed("batch_update wall (compile included)", u.batch_update,
           jnp.asarray(prob.outcomes), prob.eps_batch)
    diag = prob.check(u, sizes.oracle_particles)
    log(f"  oracle (float64 NumPy, 8 seeds × {sizes.oracle_particles}): "
        f"mean {diag['mean']} vs {diag['mean_ref']} (z {diag['z']}, "
        f"limit 4); sd rel err {diag['sd_rel_err']} (limit 0.35)")

    base, model, prior, eps, counts, true_rho = _flagship(sizes)
    nf = sizes.flagship_particles
    d_emb = 2 * base.dim
    log(f"[tomography] {sizes.flagship_qubits}-qubit-channel flagship: "
        f"{base.n_modelparams} parameters, embedded d = {d_emb}, {nf} "
        f"particles, 64-shot fiducials, {sizes.flagship_moves} adaptive "
        f"moves per resample; likelihood {HIGHEST}")
    uf = q.SMCUpdater(model, nf, prior, seed=5,
                      n_mcmc_moves=sizes.flagship_moves,
                      compress_mcmc_record=True, mcmc_adapt=True,
                      zero_weight_policy="reset")
    half = sizes.flagship_steps // 2
    for lo, what in ((0, "compile included"), (half, "warm")):
        sl = slice(lo, lo + half)
        _timed(f"batch_update wall (steps {lo}..{lo + half - 1}, {what})",
               uf.batch_update, counts[sl],
               {k: v[sl] for k, v in eps.items()}, resample_interval=1)
    events = int(uf.resample_count)
    log(f"  resample-move events: {events}")
    check(events >= 3, f"{events} resample-move events >= 3")
    # every particle PSD to 1e-5: float64 spectrum of each embedded state
    m = np.asarray(base.basis.coords_to_embedded(
        base._full_coords(uf.particle_locations)), dtype=np.float64)
    min_ev = float(np.linalg.eigvalsh(m).min())
    log(f"  min eigenvalue over {nf} particles (float64, embedded): "
        f"{min_ev:.3e} (limit -1e-5)")
    check(min_ev >= -1e-5, f"min eigenvalue {min_ev} >= -1e-5")
    from scipy.linalg import sqrtm

    rho = np.asarray(base.modelparams_to_states(
        np.asarray(uf.est_mean())[None]))[0]
    s_true = sqrtm(true_rho)
    fidelity = float(np.real(np.trace(sqrtm(s_true @ rho @ s_true))) ** 2)
    log(f"  fidelity of the posterior-mean Choi state to the truth after "
        f"{sizes.flagship_steps} experiments: {fidelity:.4f}")
    return {"qubit": diag, "flagship_events": events,
            "flagship_min_eigenvalue": min_ev}


def phase_kernels(sizes=FULL):
    """The engine's GPU routes against their plain references."""
    import jax
    import jax.numpy as jnp
    import qinfer_tpu as q
    from qinfer_tpu.resamplers import (_default_fill_strategy,
                                       counting_locations_from_u,
                                       counting_multiplicities_from_u)
    from qinfer_tpu.smc import _reweight
    from qinfer_tpu.tomography import pauli_basis
    from qinfer_tpu.tomography.models import TomographyModel

    out = {}
    for n, d in sizes.fill_shapes:
        strategy = _default_fill_strategy(d)
        x = jax.random.normal(jax.random.key(d), (n, d))
        w = jax.nn.softmax(1.5 * jax.random.normal(jax.random.key(n), (n,)))
        got = np.asarray(jax.jit(
            lambda w, x: counting_locations_from_u(0.37, w, x))(w, x))
        m, _ = counting_multiplicities_from_u(0.37, w, n)
        want = np.repeat(np.asarray(x), np.asarray(m), axis=0)
        err = float(np.max(np.abs(got - want)))
        tol = 1e-4 if strategy == "telescope" else 0.0
        log(f"[kernels] resample fill '{strategy}' at ({n}, {d}) vs NumPy "
            f"span expansion: max abs err {err:.3e} (limit {tol}); "
            f"{XLA_DEFAULT}")
        check(err <= tol, f"fill {strategy} ({n}, {d}) error {err}")
        out[f"fill_{n}x{d}"] = err

    for n, d in sizes.eigh_shapes:
        # a trace-2 embedded-like symmetric batch with negative directions
        g = np.random.default_rng(d).standard_normal((n, d, d),
                                                     dtype=np.float32)
        a = np.einsum("nab,ncb->nac", g, g) / d - 0.3 * np.eye(d)
        a = (2.0 * a / np.trace(a, axis1=1, axis2=2)[:, None, None]
             ).astype(np.float32)
        proj = jax.jit(TomographyModel.project_psd)
        got = np.asarray(_timed(f"PSD projection ({n}, {d}, {d})", proj,
                                jnp.asarray(a)))[:512]
        ev, V = np.linalg.eigh(a[:512].astype(np.float64))
        ev = np.clip(ev, 0.0, None)
        ev = 2.0 * ev / ev.sum(-1, keepdims=True)
        want = np.einsum("nab,nb,ncb->nac", V, ev, V)
        err = float(np.max(np.abs(got - want)))
        log(f"[kernels] PSD projection ({n}, {d}, {d}) vs NumPy float64 "
            f"eigh: max abs err {err:.3e} (limit 1e-4); rebuild {HIGHEST}")
        check(err < 1e-4, f"PSD projection ({n}, {d}) error {err}")
        out[f"eigh_{n}x{d}"] = err

    for nq, n in ((1, sizes.tomo_particles), (4, sizes.flagship_particles)):
        model = TomographyModel(pauli_basis(nq))
        k = model.n_modelparams
        rng = np.random.default_rng(nq)
        x = (rng.standard_normal((n, k)) * 0.3 / np.sqrt(k)).astype(
            np.float32)
        e = rng.standard_normal((3, k + 1)).astype(np.float32) * 0.3
        e[:, 0] = 1.0 / np.sqrt(model.dim)
        got = np.asarray(jax.jit(model.likelihood)(
            jnp.array([0]), jnp.asarray(x), {"meas": jnp.asarray(e)}))[0]
        full = np.concatenate(
            [np.full((n, 1), 1 / np.sqrt(model.dim)), x], 1).astype(
                np.float64)
        want = np.clip(full @ e.T.astype(np.float64), 0.0, 1.0)
        err = float(np.max(np.abs(got - want)))
        log(f"[kernels] Born-rule likelihood ({n} × {k + 1}) vs NumPy "
            f"float64: max abs err {err:.3e} (limit 1e-5); {HIGHEST}")
        check(err < 1e-5, f"Born rule {nq} qubits error {err}")
        out[f"born_{nq}q"] = err

    n = sizes.prec_particles
    om = np.random.default_rng(0).uniform(0, 1, (n, 1)).astype(np.float32)
    w = np.full(n, 1.0 / n, np.float32)
    model = q.SimplePrecessionModel()
    hyp, _, log_norm = jax.jit(
        lambda w, x: _reweight(model, w, x, 0, {"t": jnp.array([3.3])},
                               None))(jnp.asarray(w), jnp.asarray(om))
    want = w.astype(np.float64) * np.cos(om[:, 0].astype(np.float64)
                                         * 1.65) ** 2
    hyp = np.asarray(hyp, np.float64)
    err = float(np.max(np.abs(hyp / hyp.sum() - want / want.sum()))
                * n)
    nerr = float(abs(float(log_norm) - np.log(want.sum())))
    log(f"[kernels] precession reweight ({n}) vs NumPy float64: posterior "
        f"weight err {err:.3e} (× n, limit 1e-5), log-evidence err "
        f"{nerr:.3e} (limit 1e-5); {XLA_DEFAULT}")
    check(err < 1e-5 and nerr < 1e-5, f"reweight errors {err}, {nerr}")
    out["reweight"] = (err, nerr)
    return out


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process (it already holds the
    card; a second process could not)."""
    import pytest

    log("[tests] pytest -m gpu tests/test_gpu.py")
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      str(ROOT / "tests" / "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests pass (pytest exit {rc})")


def phase_four(sizes=FULL, devices=None):
    """Sharded precession over four devices against the same record on
    device 0 alone, both against the oracle."""
    import jax
    import jax.numpy as jnp
    import qinfer_tpu as q
    from jax.sharding import NamedSharding
    from qinfer_tpu.parallel import ParticleMesh
    from qinfer_tpu.parallel.resample import DistributedLiuWestResampler

    devices = jax.devices()[:4] if devices is None else devices
    check(len(devices) == 4, f"4 devices, have {len(devices)}")
    n = 4 * sizes.four_particles_per_device
    prob = _oracle().precession_binomial_problem(n_exp=sizes.prec_record)
    pm = ParticleMesh(devices)
    rs = DistributedLiuWestResampler(pm.mesh, a=0.98, exchange="auto")
    log(f"[four] sharded precession, {n} particles over {pm.n_devices} "
        f"devices, exchange '{rs.exchange}'; {XLA_DEFAULT}")
    u4 = pm.shard_updater(q.SMCUpdater(prob.model, n, prob.prior, seed=7,
                                       resampler=rs))
    outcomes = jnp.asarray(prob.outcomes)
    chunk = 10
    for lo in range(0, len(prob.outcomes), chunk):
        sl = slice(lo, lo + chunk)
        _timed(f"sharded batch_update experiments {lo}..{lo + chunk - 1}",
               u4.batch_update, outcomes[sl],
               {k: v[sl] for k, v in prob.eps_batch.items()})
        for arr in (u4.particle_weights, u4.particle_locations):
            check(isinstance(arr.sharding, NamedSharding)
                  and arr.sharding.device_set == set(devices),
                  f"NamedSharding over the 4 devices: {arr.sharding}")
            shards = arr.addressable_shards
            check(len(shards) == 4
                  and all(s.data.shape[0] == n // 4 for s in shards),
                  f"4 shards of {n // 4} rows: "
                  f"{[(s.device, s.data.shape) for s in shards]}")
    log(f"  NamedSharding kept on all 4 devices after every chunk; "
        f"resamples {int(u4.resample_count)}")

    with jax.default_device(devices[0]):
        u1 = q.SMCUpdater(prob.model, n, prob.prior, seed=7)
        _timed("device-0 batch_update (same record)", u1.batch_update,
               outcomes, prob.eps_batch)
    check(u1.particle_weights.sharding.device_set == {devices[0]},
          "the comparison ensemble lives on device 0")
    out = {}
    for name, u in (("sharded", u4), ("device0", u1)):
        diag = prob.check(u, sizes.oracle_particles)
        log(f"  {name}: mean {diag['mean']} vs oracle {diag['mean_ref']} "
            f"(z {diag['z']}, limit 4); sd rel err {diag['sd_rel_err']} "
            f"(limit 0.35)")
        out[name] = diag
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded four-GPU path and its "
                        "one-device comparison")
    args = parser.parse_args(argv)

    # the GPU or nothing: set before any backend initialises
    os.environ["JAX_PLATFORMS"] = "cuda"
    import jax

    jax.config.update("jax_platforms", "cuda")
    from qinfer_tpu._cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    dev = require_gpu()
    info = device_info()
    log(f"[device] {dev.platform} {dev.device_kind} × {info['count']}; "
        f"default matmul precision "
        f"{jax.config.jax_default_matmul_precision or 'XLA default'}")
    log(f"[device] nvidia-smi: {card_line()}")
    if args.four:
        phase_four()
    else:
        if info["count"] != 1:
            raise RuntimeError(f"one GPU expected, found {info['count']}")
        phase_precession()
        phase_tomography()
        phase_kernels()
        phase_gpu_tests()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(result_line(info), flush=True)


if __name__ == "__main__":
    main()
