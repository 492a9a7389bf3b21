"""Measurement heuristics for tomography.

Reference parity: ``src/qinfer/tomography/expdesign.py`` —
``RandomPauliHeuristic``, ``RandomStabilizerStateHeuristic``,
``ProductHeuristic``, ``BestOfKMetaheuristic`` (SURVEY.md §2 #11).

Measurement effects are expressed as coordinate vectors in the model's
basis (the ``'meas'`` expparams field), so proposals are plain arrays and
compose with the jitted engine.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..heuristics import Heuristic

__all__ = [
    "RandomPauliHeuristic",
    "RandomStabilizerStateHeuristic",
    "ProductHeuristic",
    "BestOfKMetaheuristic",
]


def _model_basis(model):
    """Tomography basis of ``model``, unwrapping derived-model chains
    (e.g. ``BinomialModel(TomographyModel(...))``) via ``base_model`` —
    the reference heuristics likewise reach through wrappers
    (``tomography/expdesign.py::RandomPauliHeuristic``)."""
    base = getattr(model, "base_model", model)
    basis = getattr(base, "basis", None)
    if basis is None:
        raise TypeError(
            f"{type(model).__name__} does not wrap a tomography model "
            "(no .basis found on it or its base_model)")
    return basis


def _projector_coords(basis, vecs):
    """Coordinates of rank-1 projectors |v⟩⟨v| in ``basis`` for a batch of
    kets ``vecs`` (m, d). HOST-side numpy."""
    vecs = np.asarray(vecs, dtype=np.complex64)
    projs = np.einsum("ma,mb->mab", vecs, vecs.conj())
    data = np.asarray(basis.data)
    return np.real(np.einsum("iab,mba->mi", data, projs))


class RandomPauliHeuristic(Heuristic):
    """Measure a uniformly random (non-identity) Pauli eigenprojector.

    Reference parity: ``tomography/expdesign.py::RandomPauliHeuristic``.
    """

    def __init__(self, updater, other_fields=None):
        super().__init__(updater)
        self.other_fields = dict(other_fields or {})
        basis = _model_basis(updater.model)
        nq = len(basis.dims)
        if any(d != 2 for d in basis.dims):
            raise ValueError("RandomPauliHeuristic requires qubit systems")
        # Precompute +1-eigenprojector coordinates of every non-identity
        # Pauli string: P₊ = (I + σ)/2 ↦ coords.
        d = basis.dim
        eye_coords = np.zeros(basis.n_ops)
        eye_coords[0] = np.sqrt(d)  # coords of identity: Tr(B_0 I) = √d
        # Coordinates of the normalized basis op B_i itself are e_i; a Pauli
        # string σ = √d · B_i (since B_i = σ/√d), so P₊ = (I + σ)/2 gives:
        self.proj_coords = jnp.asarray(
            0.5 * (eye_coords[None, :] + np.sqrt(d) * np.eye(basis.n_ops))[1:],
            dtype=jnp.float32)  # (n_ops-1, n_ops)

    def propose(self, key, weights, locations, idx_exp):
        n_choices = self.proj_coords.shape[0]
        pick = jax.random.randint(key, (), 0, n_choices)
        eps = {"meas": self.proj_coords[pick][None, :]}
        for fname, val in self.other_fields.items():
            eps[fname] = jnp.atleast_1d(jnp.asarray(val))
        return eps


# single-qubit stabilizer states: eigenstates of X, Y, Z
_STABILIZER_KETS = np.array([
    [1, 0],                       # |0⟩  (+Z)
    [0, 1],                       # |1⟩  (−Z)
    [1 / np.sqrt(2), 1 / np.sqrt(2)],        # |+⟩ (+X)
    [1 / np.sqrt(2), -1 / np.sqrt(2)],       # |−⟩ (−X)
    [1 / np.sqrt(2), 1j / np.sqrt(2)],       # |+i⟩ (+Y)
    [1 / np.sqrt(2), -1j / np.sqrt(2)],      # |−i⟩ (−Y)
], dtype=np.complex64)


class RandomStabilizerStateHeuristic(Heuristic):
    """Measure the projector onto a random product of single-qubit
    stabilizer states.

    Reference parity:
    ``tomography/expdesign.py::RandomStabilizerStateHeuristic``.
    """

    def __init__(self, updater, other_fields=None):
        super().__init__(updater)
        self.other_fields = dict(other_fields or {})
        basis = _model_basis(updater.model)
        if any(d != 2 for d in basis.dims):
            raise ValueError(
                "RandomStabilizerStateHeuristic requires qubit systems")
        self.nq = len(basis.dims)
        self.basis = basis
        # HOST-precomputed single-qubit stabilizer projector coordinates in
        # the 1-qubit Pauli basis; multi-qubit coordinates factor as real
        # Kronecker products because the Pauli basis is itself a tensor
        # product basis (Tr((P_i⊗P_j)(A⊗B)) = Tr(P_i A)·Tr(P_j B)).
        from .bases import pauli_basis

        self.stabilizer_coords = jnp.asarray(
            _projector_coords(pauli_basis(1), _STABILIZER_KETS),
            dtype=jnp.float32)  # (6, 4)

    def propose(self, key, weights, locations, idx_exp):
        keys = jax.random.split(key, self.nq)
        coords = jnp.ones((1,), dtype=jnp.float32)
        for k in keys:
            pick = jax.random.randint(k, (), 0, 6)
            coords = jnp.kron(coords, self.stabilizer_coords[pick])
        eps = {"meas": coords[None, :]}
        for fname, val in self.other_fields.items():
            eps[fname] = jnp.atleast_1d(jnp.asarray(val))
        return eps


class ProductHeuristic(Heuristic):
    """Tensor-product meta-heuristic: run one sub-heuristic per subsystem
    and measure the product effect.

    Reference parity: ``tomography/expdesign.py::ProductHeuristic`` —
    constructed from per-subsystem heuristic classes.
    """

    def __init__(self, updater, basis, sub_heuristic_classes,
                 sub_updaters=None, other_fields=None):
        super().__init__(updater)
        self.basis = basis
        self.other_fields = dict(other_fields or {})
        subs = sub_updaters if sub_updaters is not None else \
            [updater] * len(sub_heuristic_classes)
        self.sub_heuristics = [
            cls(u) for cls, u in zip(sub_heuristic_classes, subs)]
        # the kron of per-subsystem coordinate proposals must land exactly
        # on the target basis — catch the (easy) mistake of binding
        # sub-heuristics to the full multi-subsystem updater up front
        prod = 1
        for h in self.sub_heuristics:
            prod *= _model_basis(h.updater.model).n_ops
        if prod != basis.n_ops:
            raise ValueError(
                f"ProductHeuristic: sub-heuristic bases combine to "
                f"{prod} coordinates but the target basis has "
                f"{basis.n_ops}; pass sub_updaters built on the "
                f"per-subsystem bases (e.g. pauli_basis(1) models)")

    def propose(self, key, weights, locations, idx_exp):
        keys = jax.random.split(key, len(self.sub_heuristics))
        # Each sub-heuristic proposes 'meas' coordinates in its own basis;
        # for tensor-product target bases (pauli_basis(n) et al.) the
        # combined coordinates are the real Kronecker product of the
        # per-subsystem coordinate vectors — no complex operator
        # reconstruction on device.
        coords = jnp.ones((1,), dtype=jnp.float32)
        for h, k in zip(self.sub_heuristics, keys):
            sub_eps = h.propose(k, weights, locations, idx_exp)
            coords = jnp.kron(coords, sub_eps["meas"][0])
        eps = {"meas": coords[None, :]}
        for fname, val in self.other_fields.items():
            eps[fname] = jnp.atleast_1d(jnp.asarray(val))
        return eps


class BestOfKMetaheuristic(Heuristic):
    """Draw ``k`` candidate measurements from a base heuristic and keep the
    one with the best adaptivity score (max information gain or min Bayes
    risk) — scored in ONE batched engine call.

    Reference parity: ``tomography/expdesign.py::BestOfKMetaheuristic``.
    """

    def __init__(self, updater, base_heuristic, k=8, score="information_gain",
                 other_fields=None):
        super().__init__(updater)
        self.base_heuristic = base_heuristic
        self.k = int(k)
        if score not in ("information_gain", "bayes_risk"):
            raise ValueError("score must be information_gain or bayes_risk")
        self.score = score
        self.other_fields = dict(other_fields or {})

    def __call__(self, idx_exp=0):
        # batched host-level scoring (the engine call is one fused XLA
        # reduction over particles × outcomes × k candidates)
        st = self._updater.state
        key, *keys = jax.random.split(st.key, self.k + 1)
        self._updater.state = st._replace(key=key)
        cands = [self.base_heuristic.propose(
            kk, st.weights, st.locations, jnp.asarray(idx_exp))
            for kk in keys]
        # concatenate EVERY field the base heuristic proposes (a base bound
        # to a time-dependent model emits more than just 'meas')
        eps = {f: jnp.concatenate([jnp.atleast_1d(c[f]) for c in cands],
                                  axis=0)
               for f in cands[0]}
        for fname, val in self.other_fields.items():
            val = jnp.atleast_1d(jnp.asarray(val))
            eps[fname] = (jnp.repeat(val, self.k, axis=0)
                          if val.shape[0] == 1
                          else jnp.tile(val, (self.k,) + (1,) * (val.ndim - 1))[:self.k])
        if self.score == "information_gain":
            scores = self._updater.expected_information_gain(eps)
            best = int(jnp.argmax(scores))
        else:
            scores = self._updater.bayes_risk(eps)
            best = int(jnp.argmin(scores))
        return {k_: v[best:best + 1] for k_, v in eps.items()}

    def propose(self, key, weights, locations, idx_exp):
        raise NotImplementedError(
            "BestOfKMetaheuristic scores candidates against the updater "
            "posterior; use the host __call__ form")
