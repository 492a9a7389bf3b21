"""Built-in example likelihood models.

Reference parity: ``src/qinfer/test_models.py`` (SURVEY.md §2 #9) —
``SimplePrecessionModel``, ``SimpleInversionModel``, ``CoinModel``,
``NoisyCoinModel``, ``NDieModel`` — plus the Ramsey/T2 model family named in
the rebuild's benchmark configs (BASELINE.md: "MultiCosineModel / Ramsey
estimation with T2 decoherence nuisance parameter").

All likelihoods are pure ``jax.numpy`` broadcasting over
``(n_outcomes, n_models, n_expparams)`` so the engine can jit/fuse/shard
them; :mod:`qinfer_tpu.ops` keeps the reference-name
``AcceleratedPrecessionModel`` (the analogue of the reference's OpenCL
``gpu_models.py``).
"""

from __future__ import annotations

import jax.numpy as jnp

from .abstract_model import (
    FiniteOutcomeModel,
    DifferentiableModel,
    n_expparams,
)
from .domains import IntegerDomain

__all__ = [
    "SimplePrecessionModel",
    "SimpleInversionModel",
    "CoinModel",
    "NoisyCoinModel",
    "NDieModel",
    "MultiCosineModel",
    "RamseyModel",
]


class SimplePrecessionModel(DifferentiableModel, FiniteOutcomeModel):
    """Single-frequency precession: Pr(0 | ω; t) = cos²(ω t / 2).

    Reference parity: ``src/qinfer/test_models.py::SimplePrecessionModel``
    (1 model parameter ω ≥ ``min_freq``; expparams ``[('t', float)]``).
    """

    def __init__(self, min_freq=0.0):
        super().__init__()
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["omega"]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        return modelparams[:, 0] >= self.min_freq

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        t = eps["t"]  # (n_e,)
        omega = modelparams[:, 0]  # (n_m,)
        pr0 = jnp.cos(omega[:, None] * t[None, :] / 2.0) ** 2
        return self.pr0_to_likelihood_array(outcomes, pr0)


class SimpleInversionModel(DifferentiableModel, FiniteOutcomeModel):
    """Precession with a controllable inversion frequency:
    Pr(0 | ω; t, ω_inv) = cos²((ω − ω_inv) t / 2).

    Reference parity: ``src/qinfer/test_models.py::SimpleInversionModel``
    (expparams ``[('t', float), ('w_', float)]``).
    """

    def __init__(self, min_freq=0.0):
        super().__init__()
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["omega"]

    @property
    def expparams_dtype(self):
        return [("t", "float32"), ("w_", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        return modelparams[:, 0] >= self.min_freq

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        t = eps["t"]
        w_inv = eps["w_"]
        omega = modelparams[:, 0]
        pr0 = jnp.cos((omega[:, None] - w_inv[None, :]) * t[None, :] / 2.0) ** 2
        return self.pr0_to_likelihood_array(outcomes, pr0)


class CoinModel(DifferentiableModel, FiniteOutcomeModel):
    """Estimate the heads probability of a coin; experiments carry no
    parameters.

    Reference parity: ``src/qinfer/test_models.py::CoinModel`` (Pr(0) = p,
    a dummy expparams field so batches have a leading axis).
    """

    def __init__(self):
        super().__init__()

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["p"]

    @property
    def expparams_dtype(self):
        return [("exp_num", "int32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        p = modelparams[:, 0]
        return (p >= 0) & (p <= 1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        n_e = n_expparams(eps)
        p = modelparams[:, 0]
        pr0 = jnp.broadcast_to(p[:, None], (p.shape[0], n_e))
        return self.pr0_to_likelihood_array(outcomes, pr0)


class NoisyCoinModel(DifferentiableModel, FiniteOutcomeModel):
    """Coin observed through an asymmetric noisy channel:
    Pr(0 | p; α, β) = α p + β (1 − p).

    Reference parity: ``src/qinfer/test_models.py::NoisyCoinModel``
    (expparams ``[('alpha', float), ('beta', float)]``).
    """

    def __init__(self):
        super().__init__()

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["p"]

    @property
    def expparams_dtype(self):
        return [("alpha", "float32"), ("beta", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        p = modelparams[:, 0]
        return (p >= 0) & (p <= 1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        alpha = eps["alpha"]
        beta = eps["beta"]
        p = modelparams[:, 0]
        pr0 = alpha[None, :] * p[:, None] + beta[None, :] * (1 - p[:, None])
        return self.pr0_to_likelihood_array(outcomes, pr0)


class NDieModel(FiniteOutcomeModel):
    """An ``n``-sided die whose face probabilities are the model parameters.

    Reference parity: ``src/qinfer/test_models.py::NDieModel(n)``.
    """

    def __init__(self, n=6, threshold=1e-5):
        super().__init__()
        self.n = int(n)
        self.threshold = float(threshold)

    @property
    def n_modelparams(self):
        return self.n

    @property
    def modelparam_names(self):
        return [f"p_{i}" for i in range(self.n)]

    @property
    def expparams_dtype(self):
        return [("exp_num", "int32")]

    def n_outcomes(self, expparams=None):
        return self.n

    def domain(self, expparams=None):
        return IntegerDomain(0, self.n - 1)

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        nonneg = jnp.all(modelparams >= 0, axis=1)
        normed = jnp.abs(jnp.sum(modelparams, axis=1) - 1.0) < self.threshold
        return nonneg & normed

    def canonicalize(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        clipped = jnp.clip(modelparams, 0.0, None)
        total = jnp.sum(clipped, axis=1, keepdims=True)
        return clipped / jnp.where(total == 0, 1.0, total)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        n_e = n_expparams(eps)
        outcomes = jnp.atleast_1d(outcomes).astype(jnp.int32)
        # (n_out, n_models) -> broadcast over experiments
        probs = modelparams[:, :].T[outcomes]  # (n_out, n_models)
        return jnp.broadcast_to(
            probs[:, :, None], probs.shape + (n_e,)
        )


class MultiCosineModel(DifferentiableModel, FiniteOutcomeModel):
    """Sum of ``n_terms`` cosines:
    Pr(0 | ω₁..ω_k; t) = (1/k) Σⱼ cos²(ωⱼ t / 2).

    Reference parity: the multi-cos generalization of
    ``test_models.py::SimplePrecessionModel`` named by the rebuild's
    benchmark config 2 (BASELINE.json "MultiCosineModel").
    """

    def __init__(self, n_terms=2, min_freq=0.0):
        super().__init__()
        self.n_terms = int(n_terms)
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return self.n_terms

    @property
    def modelparam_names(self):
        return [f"omega_{i}" for i in range(self.n_terms)]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        return jnp.all(modelparams >= self.min_freq, axis=1)

    def canonicalize(self, modelparams):
        # sort frequencies to break the permutation symmetry
        modelparams = jnp.atleast_2d(modelparams)
        return jnp.sort(modelparams, axis=1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        t = eps["t"]
        phases = modelparams[:, :, None] * t[None, None, :] / 2.0
        pr0 = jnp.mean(jnp.cos(phases) ** 2, axis=1)
        return self.pr0_to_likelihood_array(outcomes, pr0)


class RamseyModel(DifferentiableModel, FiniteOutcomeModel):
    """Ramsey fringe with T2 decoherence nuisance parameter:
    Pr(0 | ω, T2⁻¹; t) = e^{−t/T2} cos²(ω t / 2) + (1 − e^{−t/T2}) / 2.

    Model parameters are (ω, Γ=1/T2), both non-negative; parameterizing by
    the decay *rate* keeps the prior box-shaped.

    Reference parity: the "Ramsey estimation with T2 decoherence nuisance
    parameter" benchmark config (BASELINE.md config 2); the functional form
    matches QInfer's known-T2 precession examples generalized to unknown T2.
    """

    def __init__(self, min_freq=0.0):
        super().__init__()
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return 2

    @property
    def modelparam_names(self):
        return ["omega", "Gamma"]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        return (modelparams[:, 0] >= self.min_freq) & (modelparams[:, 1] >= 0)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        t = eps["t"]
        omega = modelparams[:, 0:1]
        gamma = modelparams[:, 1:2]
        visibility = jnp.exp(-gamma * t[None, :])
        pr0 = visibility * jnp.cos(omega * t[None, :] / 2.0) ** 2 \
            + (1.0 - visibility) / 2.0
        return self.pr0_to_likelihood_array(outcomes, pr0)
