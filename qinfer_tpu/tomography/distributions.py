"""Priors over density operators.

Reference parity: ``src/qinfer/tomography/distributions.py`` —
``DensityOperatorDistribution`` ABC plus ``GinibreDistribution``,
``GinibreReditDistribution`` (real-valued rebits/redits),
``BCSZChoiDistribution`` (random channels as Choi states) and
``GADFLIDistribution`` (fiducial-state-informed prior).

All sampling runs in the **real embedding** E(H) = [[Re H, −Im H], [Im H, Re H]]
— an algebra homomorphism (E(AB) = E(A)E(B), E(H†) = E(H)ᵀ), so a complex
Ginibre draw G = A + iB becomes the real block matrix E(G) built from two
real normals, GG† becomes E(G)E(G)ᵀ, and coordinates come out through the
basis's real trace inner products. Nothing complex ever touches the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..distributions import Distribution
from ..config import EPS
from .bases import assemble_embedding as _assemble_embedding, \
    embed_hermitian_host

__all__ = [
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
]


class DensityOperatorDistribution(Distribution):
    """Distribution over density operators expressed in a tomography
    basis; samples are the ``d²−1`` free coordinates (trace component
    dropped, matching :class:`~qinfer_tpu.tomography.models.TomographyModel`).

    Subclasses implement ``_sample_embedded(key, n) -> (n, 2d, 2d)`` —
    unit-trace density operators in the real embedding.

    Reference parity:
    ``tomography/distributions.py::DensityOperatorDistribution``.
    """

    def __init__(self, basis):
        self.basis = basis

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_rvs(self):
        return self.basis.n_ops - 1

    def sample(self, key, n=1):
        m = self._sample_embedded(key, n)  # (n, 2d, 2d)
        coords = self.basis.embedded_to_coords(m)
        return coords[:, 1:]

    def _sample_embedded(self, key, n):
        raise NotImplementedError


class GinibreDistribution(DensityOperatorDistribution):
    """Ginibre-ensemble random states of given rank: ρ ∝ GG† with G a
    ``d × rank`` complex standard normal (drawn as its real embedding).

    Reference parity: ``tomography/distributions.py::GinibreDistribution``.
    """

    def __init__(self, basis, rank=None):
        super().__init__(basis)
        self.rank = int(rank) if rank is not None else self.dim

    @property
    def is_flat_on_support(self):
        """Full-rank Ginibre IS the Hilbert-Schmidt measure: density
        ∝ det(ρ)^{rank−dim}, i.e. UNIFORM over the PSD cone (in the
        orthonormal-basis coordinates the models use) exactly when
        rank == dim. Rank-deficient ensembles live on a measure-zero
        boundary stratum and are not rejuvenation targets."""
        return self.rank == self.dim

    def _sample_embedded(self, key, n):
        d, r = self.dim, self.rank
        kr, ki = jax.random.split(key)
        A = jax.random.normal(kr, (n, d, r))
        B = jax.random.normal(ki, (n, d, r))
        gE = _assemble_embedding(A, B)          # (n, 2d, 2r) = E(G)
        mE = jnp.einsum("nij,nkj->nik", gE, gE)  # E(G G†)
        tr = 0.5 * jnp.trace(mE, axis1=1, axis2=2)  # Tr rho
        return mE / jnp.clip(tr, EPS, None)[:, None, None]


class GinibreReditDistribution(DensityOperatorDistribution):
    """Real-valued Ginibre states (rebits/redits): ρ ∝ GGᵀ with G real
    (the imaginary block of the embedding is exactly zero).

    Reference parity:
    ``tomography/distributions.py::GinibreReditDistribution``.
    """

    def __init__(self, basis, rank=None):
        super().__init__(basis)
        self.rank = int(rank) if rank is not None else self.dim

    def _sample_embedded(self, key, n):
        d, r = self.dim, self.rank
        g = jax.random.normal(key, (n, d, r))
        rho = jnp.einsum("nij,nkj->nik", g, g)
        tr = jnp.trace(rho, axis1=1, axis2=2)
        rho = rho / jnp.clip(tr, EPS, None)[:, None, None]
        return _assemble_embedding(rho, jnp.zeros_like(rho))


class BCSZChoiDistribution(DensityOperatorDistribution):
    """BCSZ-random CPTP channels represented as (normalized) Choi states.

    Sampling (Bruzda-Cappellini-Sommers-Życzkowski): W = GG† with G a
    ``d² × rank`` complex normal; trace preservation enforced by the
    partial-trace whitening W ↦ (S^{-1/2} ⊗ I) W (S^{-1/2} ⊗ I) with
    S = Tr₂ W; normalized to a unit-trace Choi *state*. All products,
    partial traces and the inverse square root run in the real embedding.

    Reference parity: ``tomography/distributions.py::BCSZChoiDistribution``
    — the basis must live on the doubled space (dim d²).
    """

    def __init__(self, basis, hilbert_dim=None, rank=None):
        super().__init__(basis)
        d2 = self.dim
        hd = int(hilbert_dim) if hilbert_dim is not None else int(d2 ** 0.5)
        if hd * hd != d2:
            raise ValueError(
                "BCSZChoiDistribution needs a basis on a d² space")
        self.hilbert_dim = hd
        self.rank = int(rank) if rank is not None else d2

    @property
    def is_flat_on_support(self):
        """Full Kraus-rank BCSZ coincides with the flat (HS/Lebesgue)
        measure on the Choi section of CPTP channels (Bruzda-Cappellini-
        Sommers-Życzkowski 2009, K = d² case), so in Choi coordinates the
        density is constant on its support."""
        return self.rank == self.dim

    def _sample_embedded(self, key, n):
        d = self.hilbert_dim
        d2, r = d * d, self.rank
        kr, ki = jax.random.split(key)
        A = jax.random.normal(kr, (n, d2, r))
        B = jax.random.normal(ki, (n, d2, r))
        gE = _assemble_embedding(A, B)           # E(G): (n, 2d², 2r)
        wE = jnp.einsum("nij,nkj->nik", gE, gE)   # E(W): (n, 2d², 2d²)

        # partial trace over the SECOND tensor factor, blockwise:
        # S_ab = Σ_k W_{(a k),(b k)} applied to Re W and Im W separately
        w_re = wE[:, :d2, :d2].reshape(n, d, d, d, d)
        w_im = wE[:, d2:, :d2].reshape(n, d, d, d, d)
        s_re = jnp.einsum("nakbk->nab", w_re)
        s_im = jnp.einsum("nakbk->nab", w_im)
        sE = _assemble_embedding(s_re, s_im)      # E(S): (n, 2d, 2d)

        # K = S^{-1/2} via real symmetric eigh on E(S)
        ev, V = jnp.linalg.eigh(sE)
        inv_sqrt = jnp.einsum(
            "nab,nb,ncb->nac", V,
            1.0 / jnp.sqrt(jnp.clip(ev, 1e-12, None)), V)  # E(K)
        k_re = inv_sqrt[:, :d, :d]
        k_im = inv_sqrt[:, d:, :d]

        # M = K ⊗ I in the embedding: Re/Im kron separately
        eye = jnp.eye(d, dtype=jnp.float32)
        m_re = jnp.einsum("nab,cd->nacbd", k_re, eye).reshape(n, d2, d2)
        m_im = jnp.einsum("nab,cd->nacbd", k_im, eye).reshape(n, d2, d2)
        mE = _assemble_embedding(m_re, m_im)      # E(K ⊗ I)

        choi = jnp.einsum("nij,njk,nlk->nil", mE, wE, mE)
        tr = 0.5 * jnp.trace(choi, axis1=1, axis2=2)
        return choi / jnp.clip(tr, EPS, None)[:, None, None]


class GADFLIDistribution(DensityOperatorDistribution):
    """Fiducial-state-informed prior: convex mixtures
    ρ = (1−β) ρ_Ginibre + β ρ_fiducial with β ~ Beta(alpha, beta) — mass
    concentrates near an experimenter's fiducial guess while keeping full
    support.

    Reference parity: ``tomography/distributions.py::GADFLIDistribution``
    [SURVEY.md marks this MED-confidence; the mixing form follows the
    GADFLI construction of Granade et al., Practical Bayesian tomography
    (NJP 18 033024, 2016)].
    """

    def __init__(self, basis, fiducial_state, alpha=1.0, beta=9.0,
                 rank=None):
        super().__init__(basis)
        # embed host-side; stored as a real pytree leaf
        self.fiducial_embedded = jnp.asarray(
            embed_hermitian_host(fiducial_state))
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.rank = int(rank) if rank is not None else None

    def _sample_embedded(self, key, n):
        k1, k2 = jax.random.split(key)
        gin = GinibreDistribution(self.basis, rank=self.rank)
        rho_g = gin._sample_embedded(k1, n)
        mix = jax.random.beta(k2, self.alpha, self.beta, (n, 1, 1))
        return (1.0 - mix) * rho_g + mix * self.fiducial_embedded[None]
