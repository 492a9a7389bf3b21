"""Hermitian operator bases for tomography.

Reference parity: ``src/qinfer/tomography/bases.py`` — ``TomographyBasis``
(an array of Hermitian basis operators with ``state_to_modelparams`` /
``modelparams_to_state`` giving flat real-vector coordinates) and the
constructors ``pauli_basis``, ``gell_mann_basis``, ``tensor_product_basis``.

Convention (matching the reference): bases are orthonormal under the
Hilbert-Schmidt inner product ``⟨A, B⟩ = Tr(A† B)``, with the FIRST element
proportional to the identity (``I/√d``), so that a unit-trace state has
fixed first coordinate ``1/√d`` and the remaining ``d²−1`` coordinates are
the free model parameters.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .._pytree import Module

__all__ = [
    "TomographyBasis",
    "pauli_basis",
    "gell_mann_basis",
    "tensor_product_basis",
    "hermitian_eigvalsh",
    "hermitian_eigh_embedded",
    "batched_cholesky_small",
    "assemble_embedding",
    "embed_hermitian",
    "embed_hermitian_host",
    "unembed_hermitian",
]


# ---------------------------------------------------------------------------
# Complex-Hermitian eigensolves via real-symmetric embedding.
#
# A complex Hermitian H maps to the real symmetric embedding
# E(H) = [[Re H, −Im H], [Im H, Re H]] whose spectrum is that of H with
# every eigenvalue doubled, so all PSD checks and eigenvalue-clipping
# projections run on real eigh and map back exactly. The device path keeps
# everything in this real form.
# ---------------------------------------------------------------------------

def assemble_embedding(re, im):
    """E(A + iB) = [[A, −B], [B, A]] for batched real blocks (..., d, d) —
    the shared building block of every embedded computation (works on jnp
    and on host numpy arrays alike via the caller's array namespace)."""
    top = jnp.concatenate([re, -im], axis=-1)
    bot = jnp.concatenate([im, re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def embed_hermitian_host(mat):
    """HOST-side embedding of a complex NumPy matrix: returns a real
    float32 numpy array."""
    mat = np.asarray(mat, dtype=np.complex64)
    return np.block([[mat.real, -mat.imag],
                     [mat.imag, mat.real]]).astype(np.float32)


def embed_hermitian(rho):
    """(..., d, d) complex Hermitian → (..., 2d, 2d) real symmetric."""
    return assemble_embedding(jnp.real(rho), jnp.imag(rho))


def unembed_hermitian(m, d):
    """Inverse of :func:`embed_hermitian` (symmetrized block read-off)."""
    re = 0.5 * (m[..., :d, :d] + m[..., d:, d:])
    im = 0.5 * (m[..., d:, :d] - m[..., :d, d:])
    return (re + 1j * im).astype(jnp.complex64)


def hermitian_eigvalsh(rho):
    """Eigenvalues of complex Hermitian matrices, shape (..., d), via the
    real embedding (each eigenvalue appears twice in the embedded
    spectrum; the sorted duplicates are decimated)."""
    ev = jnp.linalg.eigvalsh(embed_hermitian(rho))
    return ev[..., ::2]


def batched_cholesky_small(a):
    """Cholesky factor of a batch of small symmetric matrices (..., d, d),
    d static and small (tomography embeddings: d ≤ ~32), via a fully
    UNROLLED Cholesky–Banachiewicz recursion — every step is an
    elementwise op over the batch axis, so XLA fuses the whole factor
    into a handful of elementwise passes. Non-PD inputs produce NaN
    entries, same detection contract as ``jnp.linalg.cholesky``.
    """
    d = a.shape[-1]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)       # NaN for non-PD pivots
            else:
                L[i][j] = s / L[j][j]
    zero = jnp.zeros_like(a[..., 0, 0])
    return jnp.stack(
        [jnp.stack([L[i][j] if j <= i else zero for j in range(d)], -1)
         for i in range(d)], -2)


def hermitian_eigh_embedded(rho, transform):
    """Apply an elementwise spectral ``transform`` (e.g. clipping) to a
    batch of complex Hermitian matrices, entirely in the real embedding:
    returns matrices with eigenvalues ``transform(eigenvalues)``."""
    d = rho.shape[-1]
    m = embed_hermitian(rho)
    ev, V = jnp.linalg.eigh(m)
    ev = transform(ev)
    m2 = jnp.einsum("...ab,...b,...cb->...ac", V, ev, V)
    return unembed_hermitian(m2, d)


class _HostArray:
    """Hashable host-side array holder: keeps complex basis data OUT of the
    pytree (a leaf would be device-transferred whenever the model crosses
    ``jit``; the device path uses only the real embedding). Hash/eq by
    content so jit cache keys stay correct."""

    __slots__ = ("arr", "_hash")

    def __init__(self, arr):
        self.arr = np.ascontiguousarray(arr)
        self._hash = hash((self.arr.shape, self.arr.dtype.str,
                           self.arr.tobytes()))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, _HostArray)
                and self.arr.shape == other.arr.shape
                and np.array_equal(self.arr, other.arr))


class TomographyBasis(Module):
    """An orthonormal Hermitian operator basis.

    :param data: complex array ``(n_ops, d, d)`` of Hermitian operators,
        orthonormal under Hilbert-Schmidt; ``data[0]`` must be ``I/√d``.
    :param dims: subsystem dimension list (e.g. ``[2, 2]`` for two qubits).
    :param labels: operator names for display.

    Reference parity: ``tomography/bases.py::TomographyBasis``.
    """

    def __init__(self, data, dims, labels=None):
        host = np.asarray(data, dtype=np.complex64)
        # Complex data lives HOST-side only, as static (non-pytree) content:
        # it is never device-transferred when a model carrying this basis
        # crosses jit.
        self.data_host = _HostArray(host)
        self.dims = list(int(d) for d in dims)
        self.labels = list(labels) if labels is not None else [
            f"B{i}" for i in range(host.shape[0])]
        # Real-embedded basis operators — the ONLY on-device representation:
        # every device-side tomography computation runs on these
        # (n_ops, 2d, 2d) real matrices via the embedding homomorphism
        # E(AB) = E(A)E(B).
        re, im = host.real, host.imag
        self.data_embedded = jnp.asarray(np.concatenate(
            [np.concatenate([re, -im], axis=-1),
             np.concatenate([im, re], axis=-1)], axis=-2),
            dtype=jnp.float32)

    @property
    def data(self):
        """Complex basis operators as a host NumPy array (API-compat view;
        all device computation uses :attr:`data_embedded`)."""
        return self.data_host.arr

    @property
    def dim(self):
        """Total Hilbert-space dimension."""
        return int(np.prod(self.dims))

    @property
    def n_ops(self):
        return self.data_host.arr.shape[0]

    def __len__(self):
        return self.n_ops

    def __getitem__(self, idx):
        return self.data[idx]

    # -- coordinates -------------------------------------------------------

    def state_to_modelparams(self, rho):
        """Flat real coordinates of a (batch of) d×d Hermitian matrices:
        ``x_i = Tr(B_i ρ)`` (real by Hermiticity), shape ``(..., n_ops)``.

        Reference parity: ``TomographyBasis.state_to_modelparams``.
        """
        rho = np.asarray(rho, dtype=np.complex64)
        return jnp.asarray(
            np.real(np.einsum("iab,...ba->...i", self.data_host.arr, rho)))

    def modelparams_to_state(self, x):
        """Inverse: coordinates ``(..., n_ops)`` to matrices
        ``(..., d, d)``.

        Reference parity: ``TomographyBasis.modelparams_to_state``.
        """
        x = np.asarray(x, dtype=np.complex64)
        return np.einsum("...i,iab->...ab", x, self.data_host.arr)

    # -- real-embedded coordinates (the on-device path; complex-free) -----

    def coords_to_embedded(self, x):
        """Coordinates ``(..., n_ops)`` → real-embedded matrices
        ``(..., 2d, 2d)``: E(ρ) = Σ xᵢ E(Bᵢ). Pure real einsum, in full
        float32 (TF32 would leave ~1e-3 errors in the entries)."""
        x = jnp.asarray(x, dtype=jnp.float32)
        return jnp.einsum("...i,iab->...ab", x, self.data_embedded,
                          precision=jax.lax.Precision.HIGHEST)

    def embedded_to_coords(self, m):
        """Inverse of :func:`coords_to_embedded` for Hermitian-embedded
        matrices: xᵢ = Tr(Bᵢ ρ) = ½ Tr(E(Bᵢ) E(ρ))."""
        m = jnp.asarray(m, dtype=jnp.float32)
        return 0.5 * jnp.einsum("iab,...ba->...i", self.data_embedded, m,
                                precision=jax.lax.Precision.HIGHEST)

    def covariance_mtx_to_superop(self, cov):
        """Lift a coordinate covariance matrix to a superoperator on
        operators (host-side helper for plotting; reference
        ``TomographyBasis.covariance_mtx_to_superop``)."""
        cov = np.asarray(cov, dtype=np.complex64)
        return np.einsum("ij,iab,jcd->abcd", cov,
                         self.data_host.arr, self.data_host.arr)

    def __repr__(self):
        return (f"<TomographyBasis dims={self.dims} "
                f"n_ops={self.n_ops} labels={self.labels[:4]}...>")


def _pauli_matrices():
    I = np.eye(2, dtype=np.complex64)
    X = np.array([[0, 1], [1, 0]], dtype=np.complex64)
    Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex64)
    Z = np.array([[1, 0], [0, -1]], dtype=np.complex64)
    return [I, X, Y, Z]


def pauli_basis(nq=1):
    """Normalized Pauli basis on ``nq`` qubits: all tensor products of
    {I, X, Y, Z}/√2, identity first.

    Reference parity: ``tomography/bases.py::pauli_basis``.
    """
    import itertools

    paulis = _pauli_matrices()
    names = ["I", "X", "Y", "Z"]
    ops, labels = [], []
    for combo in itertools.product(range(4), repeat=nq):
        op = np.array([[1.0]], dtype=np.complex64)
        for c in combo:
            op = np.kron(op, paulis[c])
        ops.append(op / np.sqrt(2.0 ** nq))
        labels.append("".join(names[c] for c in combo))
    return TomographyBasis(np.stack(ops), [2] * nq, labels)


def gell_mann_basis(dim):
    """Normalized generalized Gell-Mann basis for one ``dim``-level system,
    identity first.

    Reference parity: ``tomography/bases.py::gell_mann_basis``.
    """
    ops = [np.eye(dim, dtype=np.complex64) / np.sqrt(dim)]
    labels = ["I"]
    # symmetric
    for i in range(dim):
        for j in range(i + 1, dim):
            m = np.zeros((dim, dim), dtype=np.complex64)
            m[i, j] = m[j, i] = 1.0 / np.sqrt(2.0)
            ops.append(m)
            labels.append(f"S{i}{j}")
    # antisymmetric
    for i in range(dim):
        for j in range(i + 1, dim):
            m = np.zeros((dim, dim), dtype=np.complex64)
            m[i, j] = -1j / np.sqrt(2.0)
            m[j, i] = 1j / np.sqrt(2.0)
            ops.append(m)
            labels.append(f"A{i}{j}")
    # diagonal
    for k in range(1, dim):
        m = np.zeros((dim, dim), dtype=np.complex64)
        for i in range(k):
            m[i, i] = 1.0
        m[k, k] = -float(k)
        m /= np.sqrt(k * (k + 1))
        ops.append(m)
        labels.append(f"D{k}")
    return TomographyBasis(np.stack(ops), [dim], labels)


def tensor_product_basis(*bases):
    """Tensor product of operator bases, with the identity-proportional
    element re-sorted to index 0 (the position
    :class:`~qinfer_tpu.tomography.models.TomographyModel` requires for its
    fixed trace coordinate).

    Reference parity: ``tomography/bases.py::tensor_product_basis``.
    """
    import itertools

    datas = [np.asarray(b.data) for b in bases]
    dims = sum((b.dims for b in bases), [])
    ops, labels = [], []
    for combo in itertools.product(*[range(d.shape[0]) for d in datas]):
        op = np.array([[1.0]], dtype=np.complex64)
        lab = []
        for b_idx, o_idx in enumerate(combo):
            op = np.kron(op, datas[b_idx][o_idx])
            lab.append(bases[b_idx].labels[o_idx])
        ops.append(op)
        labels.append("⊗".join(lab))
    ops = np.stack(ops)
    # locate the identity-proportional element and move it to index 0
    d = ops.shape[-1]
    eye = np.eye(d, dtype=np.complex64)
    id_idx = None
    for i, op in enumerate(ops):
        tr = np.trace(op)
        if abs(tr) > 1e-6 and np.allclose(op, (tr / d) * eye, atol=1e-5):
            id_idx = i
            break
    if id_idx is None:
        raise ValueError(
            "tensor_product_basis: no identity-proportional element found; "
            "input bases must each contain an identity-proportional op")
    order = [id_idx] + [i for i in range(len(ops)) if i != id_idx]
    ops = ops[order]
    labels = [labels[i] for i in order]
    # fix the sign/phase so data[0] = +I/sqrt(d)
    tr0 = np.trace(ops[0])
    ops[0] = ops[0] * (abs(tr0) / tr0)
    return TomographyBasis(ops, dims, labels)
