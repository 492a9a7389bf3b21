"""CPU tests of the GPU entry points: ``chip_smoke.py`` (each phase at a
tiny size, its refusal without a GPU and its result line), ``bench.py``'s
refusal, the compile-cache helper and the per-backend routes the GPU
takes (resample fill, PSD projection)."""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_bench_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main(["--particles", "4096"])


def test_result_line_matches_contract():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": 1}
    line = chip_smoke.result_line(info)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": info}


def test_device_info_names_the_backend():
    info = chip_smoke.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


@pytest.mark.parametrize("phase", ["precession", "tomography", "kernels",
                                   "four"])
def test_phase_at_tiny_size(phase):
    """Every phase of the smoke test runs its checks at a tiny size here
    (``four`` on four of the eight virtual CPU devices)."""
    if phase == "four":
        out = chip_smoke.phase_four(chip_smoke.TINY, jax.devices()[:4])
        assert set(out) == {"sharded", "device0"}
    else:
        out = getattr(chip_smoke, f"phase_{phase}")(chip_smoke.TINY)
        assert out


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from qinfer_tpu._cache import enable_compile_cache

    assert enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    from qinfer_tpu._cache import enable_compile_cache

    root = pathlib.Path(__file__).resolve().parents[1]
    path = enable_compile_cache()
    assert path == str(root / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


@pytest.mark.parametrize("backend,d,want", [
    ("cpu", 1, "telescope"), ("cpu", 4, "telescope"), ("cpu", 5, "gather"),
    ("gpu", 1, "gather"), ("gpu", 3, "gather"), ("gpu", 255, "gather"),
])
def test_default_fill_strategy(monkeypatch, backend, d, want):
    from qinfer_tpu import resamplers

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resamplers._default_fill_strategy(d) == want


@pytest.mark.parametrize("strategy", ["gather", "scan", "telescope"])
def test_fills_match_span_expansion(strategy):
    """Every fill equals the literal span expansion ``np.repeat(x, m)``."""
    from qinfer_tpu.resamplers import (counting_locations_from_u,
                                       counting_multiplicities_from_u)

    n, d = 700, 3
    x = jax.random.normal(jax.random.key(1), (n, d))
    w = jax.nn.softmax(2.0 * jax.random.normal(jax.random.key(2), (n,)))
    got = np.asarray(counting_locations_from_u(0.41, w, x, strategy))
    m, _ = counting_multiplicities_from_u(0.41, w, n)
    want = np.repeat(np.asarray(x), np.asarray(m), axis=0)
    tol = 1e-5 if strategy == "telescope" else 0.0
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("nq", [2, 3, 4])
def test_canonicalize_matches_numpy_projection(nq):
    """General-dim canonicalize (embedded d = 8, 16, 32) against a float64
    NumPy eigh projection of the complex states."""
    import qinfer_tpu.tomography as tomo

    basis = tomo.pauli_basis(nq)
    model = tomo.TomographyModel(basis)
    mp = tomo.GinibreDistribution(basis).sample(jax.random.key(nq), 64)
    pushed = np.asarray(1.5 * mp)
    out = np.asarray(model.canonicalize(jnp.asarray(pushed)))
    rho = np.asarray(model.modelparams_to_states(jnp.asarray(pushed)),
                     dtype=np.complex128)
    ev, V = np.linalg.eigh(rho)
    ev = np.clip(ev, 0.0, None)
    ev = ev / ev.sum(axis=-1, keepdims=True)
    proj = np.einsum("nab,nb,ncb->nac", V, ev, V.conj())
    want = np.asarray(basis.state_to_modelparams(proj))[:, 1:]
    invalid = ~np.asarray(model.are_models_valid(jnp.asarray(pushed)))
    assert invalid.any()
    np.testing.assert_allclose(out[invalid], want[invalid], atol=3e-5)
    rho_out = np.asarray(model.modelparams_to_states(jnp.asarray(out)),
                         dtype=np.complex128)
    assert np.linalg.eigvalsh(rho_out).min() > -1e-5
