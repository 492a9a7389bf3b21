"""Particle resamplers.

Reference parity: ``src/qinfer/resamplers.py`` (SURVEY.md §2 #5) —
``LiuWestResampler(a, h, maxiter, postselect, zero_cov_comp, kernel)``.

Design
------
* The resampler is a **pure keyed function** ``(model, key, weights,
  locations) -> new_locations`` so it composes into the jitted / scanned
  update step (the reference mutates NumPy arrays in place).
* Ancestor selection defaults to **systematic resampling** (single uniform,
  stratified cumsum inversion via ``searchsorted``) — lower variance than the
  reference's multinomial draw (``resamplers.py::LiuWestResampler.__call__``
  uses cumsum + searchsorted on iid uniforms); ``kind='multinomial'``
  reproduces the reference scheme.
* The reference's unbounded rejection loop over ``model.are_models_valid``
  becomes a **fixed-round masked redraw** (static shape under jit): invalid
  proposals are redrawn up to ``maxiter`` rounds; slots still invalid fall
  back to their ancestor's (valid) location — the same best-effort fallback
  the reference applies when it exhausts ``maxiter``, without dynamic shapes.
* The covariance square root uses ``eigh`` with eigenvalue clipping
  (:func:`qinfer_tpu.utils.sqrtm_psd`) instead of ``scipy.linalg.sqrtm``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import math

from ._pytree import Module
from .config import EPS
from .utils import weighted_moments, sqrtm_psd

__all__ = ["Resampler", "LiuWestResampler", "systematic_ancestors",
           "systematic_resample_locations", "systematic_ancestors_counting",
           "systematic_resample_locations_counting", "multinomial_ancestors"]


#: largest float32 strictly below 1.0 — stratified positions are clamped
#: here so none can round up to exactly 1.0 and tie with cdf[-1] (at large
#: n, (n-1+u)/n rounds to 1.0f for u near 1; the stable sort would then
#: place the final cdf entry FIRST and the position slot would miss its
#: ancestor).
_BELOW_ONE = 1.0 - 2.0 ** -24


def _stratified_cdf_positions(key, weights, n_out):
    """Shared prelude of all systematic-resampling variants: normalized
    weight CDF and clamped stratified positions (single uniform offset)."""
    u = jax.random.uniform(key, ())
    cdf = jnp.cumsum(weights)
    cdf = cdf / cdf[-1]
    positions = (jnp.arange(n_out, dtype=cdf.dtype) + u) / n_out
    positions = jnp.minimum(positions, jnp.asarray(_BELOW_ONE, cdf.dtype))
    return cdf, positions


def systematic_ancestors(key, weights, n_out=None):
    """Systematic (stratified, single-uniform) ancestor indices.

    Positions u_i = (i + u)/n for one u ~ U[0,1) are inverted through the
    weight CDF. Lower variance than multinomial resampling (see PAPERS.md,
    Murray et al., "Parallel resampling in the particle filter").

    Because both the CDF and the stratified positions are sorted, the
    inversion is computed as a **merge rank** — one stable sort of the
    concatenated sequences plus a scan — instead of ``searchsorted``.
    Exact same output as ``searchsorted(cdf, positions)``. Kept for
    comparison; the production engine uses the sort-free
    :func:`systematic_ancestors_counting`.
    """
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    cdf, positions = _stratified_cdf_positions(key, weights, n_out)
    merged = jnp.concatenate([cdf, positions])
    order = jnp.argsort(merged, stable=True)
    is_cdf = order < n
    cdf_count = jnp.cumsum(is_cdf.astype(jnp.int32))
    # scatter each position's cdf-rank to its output slot; cdf slots are
    # routed to an out-of-bounds index and dropped (NOT a negative index —
    # those would wrap under JAX indexing)
    idx = jnp.where(is_cdf, n_out, order - n)
    anc = jnp.zeros(n_out, dtype=jnp.int32).at[idx].set(
        cdf_count, mode="drop")
    return jnp.clip(anc, 0, n - 1)


def systematic_resample_locations(key, weights, locations):
    """Systematic resampling that produces the resampled particle
    **locations directly**, with no random gather.

    The merge-rank inversion (see :func:`systematic_ancestors`) sorts the
    concatenated ``[cdf, positions]`` sequence. This variant carries the
    particle coordinates through that same sort as payloads and
    **backward-fills** them (reverse ``associative_scan``): each stratified
    position slot picks up the coordinates of the first CDF entry at or
    after it — exactly its systematic ancestor. A final scatter routes the
    filled coordinates to their output slots.

    All passes (sort, scan, scatter) are regular-access, so this avoids the
    ``x[ancestors]`` gather of the classic formulation. Kept for
    comparison and diagnostics; the production engine uses the sort-free
    :func:`systematic_resample_locations_counting`.

    :return: ``(n, d)`` resampled locations (same law as
        ``locations[systematic_ancestors(key, weights)]``).
    """
    n, d = locations.shape
    cdf, positions = _stratified_cdf_positions(key, weights, n)

    # co-sorted operands (payloads move through the sort network — regular
    # access, never an indexed gather):
    #   keys     : [cdf, positions]
    #   is_cdf   : marks cdf slots (stable sort keeps cdf before equal pos)
    #   out_j    : each position's output slot (unused for cdf slots)
    #   payload_k: particle coordinate columns (garbage for pos slots)
    zeros_i = jnp.zeros((n,), dtype=jnp.int32)
    operands = [
        jnp.concatenate([cdf, positions]),
        jnp.concatenate([jnp.ones((n,), jnp.int32), zeros_i]),
        jnp.concatenate([zeros_i, jnp.arange(n, dtype=jnp.int32)]),
    ] + [
        jnp.concatenate([locations[:, k_col],
                         jnp.zeros((n,), locations.dtype)])
        for k_col in range(d)
    ]
    sorted_ops = jax.lax.sort(operands, num_keys=1, is_stable=True)
    is_cdf = sorted_ops[1] > 0
    out_j = sorted_ops[2]
    payload = jnp.stack(sorted_ops[3:], axis=1)  # (2n, d)

    # backward fill: propagate the NEXT cdf slot's payload onto earlier
    # position slots (each position's systematic ancestor is the first cdf
    # entry at-or-after it).  Associative on (payload, flag) pairs.
    def combine(a, b):
        a_x, a_f = a
        b_x, b_f = b
        take_b = b_f[..., None] > 0
        return jnp.where(take_b, b_x, a_x), jnp.maximum(a_f, b_f)

    filled, _ = jax.lax.associative_scan(
        combine, (payload, is_cdf.astype(jnp.int32)), reverse=True)

    # route position slots' filled coords to their output index; cdf slots
    # go to an out-of-bounds index and are dropped (NOT negative — those
    # would wrap under JAX indexing)
    out_idx = jnp.where(is_cdf, n, out_j)
    out = jnp.zeros((n, d), dtype=locations.dtype).at[out_idx].set(
        filled, mode="drop")
    # Every position slot is guaranteed a fill: cdf[-1] is exactly 1.0
    # (x/x) and _stratified_cdf_positions clamps every position strictly
    # below 1.0f, so a cdf entry always sorts at-or-after it (the clamp is
    # load-bearing: without it, (n-1+u)/n rounds to 1.0f at large n and
    # the tying position slot would receive zeros).
    return out


def counting_multiplicities_from_u(u, weights, n_out):
    """Shared prelude of the sort-free systematic variants: per-particle
    copy counts and output offsets, from ONE cumsum and elementwise math.
    Takes the uniform offset explicitly (the distributed resampler
    supplies its own per-shard uniform).

    ``m_i = ceil(n·F_i − u) − ceil(n·F_{i−1} − u)`` counts the stratified
    positions ``(j + u)/n`` that land in ``(F_{i−1}, F_i]`` — no sort, no
    searchsorted. The exclusive cumsum of ``m`` (each particle's first
    output slot) is ``ceil(n·F_{i−1} − u)`` itself, so it is free.

    Precision: ``n·F`` amplifies float32 CDF rounding (ulp 0.125 at
    n = 2²¹), so boundary assignments can shift by one slot relative to
    the merge-rank formulation — the same magnitude of tie noise the sort
    path has when comparing f32 keys, and statistically irrelevant to the
    resampling law. ``Σ m = n`` holds exactly: ``F`` is normalized so
    ``ceil(n·1 − u) = n`` for ``u ∈ (0, 1)``.
    """
    cdf = jnp.cumsum(weights)
    cdf = cdf / jnp.maximum(cdf[-1], EPS)
    upper = jnp.ceil(n_out * cdf - u)
    # XLA's cumsum is a PARALLEL scan: float reassociation can make the
    # prefix sums (and hence the ceilings) dip non-monotonically by one
    # ulp, which would produce m = -1 / overlapping offsets. One cheap
    # cummax pass restores monotonicity.
    upper = jax.lax.cummax(upper)
    lower = jnp.concatenate([jnp.zeros((1,), upper.dtype), upper[:-1]])
    m = (upper - lower).astype(jnp.int32)
    offsets = jnp.clip(lower, 0.0, None).astype(jnp.int32)
    return m, offsets


def _scatter_indices(m, offsets, n_out):
    """Output slot for each particle's first copy, with EMPTY particles
    routed to DISTINCT out-of-bounds slots (``n_out + i``): every index is
    provably unique, which lets the scatters below carry
    ``unique_indices=True`` — without it XLA must assume collisions and
    serialize the scatter."""
    n = m.shape[0]
    return jnp.where(m > 0, offsets,
                     n_out + jnp.arange(n, dtype=jnp.int32))


def counting_ancestors_from_u(u, weights, n_out):
    """Sort-free systematic ancestors with an explicit uniform offset
    (see :func:`systematic_ancestors_counting`)."""
    n = weights.shape[0]
    m, offsets = counting_multiplicities_from_u(u, weights, n_out)
    idx = _scatter_indices(m, offsets, n_out)
    anc = jnp.zeros((n_out,), jnp.int32).at[idx].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop", unique_indices=True)
    return jax.lax.cummax(anc)


def counting_locations_from_u(u, weights, locations, strategy=None):
    """Sort-free systematic resample-to-locations with an explicit uniform
    offset (see :func:`systematic_resample_locations_counting`).

    Three strategies compute the same expansion of survivors into their
    contiguous output spans (chosen per backend and dimension by
    :func:`_default_fill_strategy` unless pinned):

    * ``gather`` — scatter each survivor's index at its first slot,
      forward-fill the indices with a ``cummax`` and gather the rows
      ``locations[ancestors]`` (the ancestors are sorted, so the gather
      reads memory nearly in order).
    * ``scan`` — scatter survivors at their first slot + an
      ``associative_scan`` "last-written-wins" forward fill.
    * ``telescope`` — scatter-add ``+x_i`` at each survivor's first slot
      and ``-x_i`` at one-past-its-last + cumsum — far cheaper than the
      generic scan recursion on CPU; float32 cancellation ~sqrt(n)*eps
      relative to particle spread (coordinates are mean-centered).
    """
    n, d = locations.shape
    m, offsets = counting_multiplicities_from_u(u, weights, n)
    if strategy is None:
        strategy = _default_fill_strategy(d)
    start = _scatter_indices(m, offsets, n)
    if strategy == "gather":
        anc = jnp.zeros((n,), jnp.int32).at[start].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop", unique_indices=True)
        return locations[jax.lax.cummax(anc)]
    alive = m > 0
    if strategy == "telescope":
        mu = jnp.mean(locations, axis=0)
        xc = jnp.where(alive[:, None], locations - mu[None, :], 0.0)
        stop = _scatter_indices(m, offsets + m, n)
        contrib = jnp.zeros((n, d), locations.dtype).at[start].add(
            xc, mode="drop", unique_indices=True)
        contrib = contrib.at[stop].add(
            -xc, mode="drop", unique_indices=True)
        return mu[None, :] + jnp.cumsum(contrib, axis=0)
    flag = jnp.zeros((n,), jnp.int32).at[start].set(
        1, mode="drop", unique_indices=True)
    out = jnp.zeros((n, d), locations.dtype).at[start].set(
        locations, mode="drop", unique_indices=True)

    def combine(a, b):
        a_x, a_f = a
        b_x, b_f = b
        take_b = b_f[..., None] > 0
        return jnp.where(take_b, b_x, a_x), jnp.maximum(a_f, b_f)

    filled, _ = jax.lax.associative_scan(combine, (out, flag))
    return filled


def systematic_ancestors_counting(key, weights, n_out=None):
    """Sort-free systematic ancestor indices.

    Scatter each surviving particle's index at its first output slot, then
    forward-fill with a ``cummax`` — valid because surviving particle
    indices are strictly increasing along the output axis, and slot 0 is
    always written (the first surviving particle has offset 0). Total cost
    is one cumsum + one scatter + one cummax: log-depth regular-access
    passes, ~an order of magnitude cheaper than the ``2n`` bitonic sort of
    the merge-rank formulation (sort is O(n log²n) network passes).

    Same resampling law as :func:`systematic_ancestors`; boundary slots
    can differ by one particle (see :func:`counting_multiplicities_from_u`).
    """
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    return counting_ancestors_from_u(
        jax.random.uniform(key, ()), weights, n_out)


def systematic_resample_locations_counting(key, weights, locations,
                                           strategy=None):
    """Sort-free systematic resampling producing the resampled particle
    **locations directly** — no sort AND no random gather (scatter the
    survivors, forward-fill; strategies and precision notes in
    :func:`counting_locations_from_u`).

    :return: ``(n, d)`` resampled locations (same law as
        ``locations[systematic_ancestors(key, weights)]``).
    """
    return counting_locations_from_u(
        jax.random.uniform(key, ()), weights, locations, strategy=strategy)


def _default_fill_strategy(d):
    """The ONE place that decides how a counting fill is materialized for
    the current backend and particle dimension ``d``:

    * CPU → ``telescope`` at d ≤ 4 (the generic odd/even scan recursion
      crawls there), ``gather`` above;
    * GPU → ``gather`` at every d: exact, and faster than ``scan`` at
      every shape measured; ``telescope`` is faster at d ≤ 3 but inexact
      (PERF.md, "Kernels on H100").
    """
    if jax.default_backend() == "cpu" and d <= 4:
        return "telescope"
    return "gather"


def multinomial_ancestors(key, weights, n_out=None):
    """IID categorical ancestor indices (the reference's scheme:
    ``resamplers.py::LiuWestResampler.__call__`` cumsum + searchsorted on iid
    uniforms)."""
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    return jax.random.categorical(
        key, jnp.log(jnp.clip(weights, EPS, None)), shape=(n_out,)
    )


class Resampler(Module):
    """Abstract resampler protocol: ``__call__(model, key, weights,
    locations) -> (new_weights, new_locations)``.

    Resamplers may additionally implement :meth:`call_with_diagnostics`
    to report degraded-strategy events (the reference's
    ``ResamplerWarning`` path) as a traced count the engine accumulates.
    """

    def __call__(self, model, key, particle_weights, particle_locations):
        raise NotImplementedError

    def call_with_diagnostics(self, model, key, particle_weights,
                              particle_locations):
        """Like ``__call__`` but returns ``(weights, locations,
        n_fallback)`` where ``n_fallback`` (traced i32) counts particle
        slots that required a degraded fallback (0 for resamplers without
        a rejection loop)."""
        w, x = self(model, key, particle_weights, particle_locations)
        return w, x, jnp.asarray(0, jnp.int32)


class LiuWestResampler(Resampler):
    """Liu-West kernel-shrinkage resampler.

    Reference parity: ``src/qinfer/resamplers.py::LiuWestResampler`` — the
    same algorithm: weighted mean μ and covariance Σ; shrinkage
    ``h = sqrt(1 − a²)``; ancestors drawn ∝ weights; proposals
    ``x' = a·x_anc + (1−a)·μ + h·S·z`` with ``S = sqrtm(Σ)``; validity
    postselection against ``model.are_models_valid``; ``model.canonicalize``
    applied; weights reset to uniform. ``a=1`` (⇒ h=0) degenerates to plain
    bootstrap resampling.

    :param float a: shrinkage parameter in (0, 1].
    :param float h: kernel bandwidth override (default ``sqrt(1 - a**2)``).
    :param int maxiter: masked-redraw rounds for validity postselection.
    :param bool postselect: disable to skip the validity redraw entirely.
    :param float zero_cov_comp: diagonal jitter added when Σ is singular.
    :param str kind: ``'systematic'`` (default) or ``'multinomial'``.
    :param fill_strategy: override the backend-selected ancestor-fill
        strategy (``'gather'``/``'scan'``/``'telescope'``; None = auto).
        Benchmarks use this to compare the fills through the full
        engine.
    :param bool canonicalize: apply ``model.canonicalize`` to the output
        ensemble (default, reference parity). ``False`` is the
        validity-tolerant contract for resample-MOVE configs (round 5):
        the output is still within the model's validity tolerance
        (postselection + ancestor fallback), and the Metropolis moves
        that follow re-gate validity per proposal and re-apply the
        strict projection at the end of the move block — so the
        intermediate strict projection here is redundant. The engine
        selects this
        automatically when ``n_mcmc_moves > 0`` AND the move block's
        own projection is active (``mcmc_canonicalize=True``).
        WARNING: never combine ``canonicalize=False`` with a move block
        that also skips its projection — with no strict projection per
        resample-move event the 255-dim flagship posterior collapses
        (fidelity 0.98 → 0.48-0.65 in the earlier measurements kept in
        git history); the strict projection is per-event correctness at
        high dimension, not hygiene.
    """

    def __init__(self, a=0.98, h=None, maxiter=10, debug=False,
                 postselect=True, zero_cov_comp=1e-10, kernel=None,
                 kind="systematic", fill_strategy=None, canonicalize=True):
        self.a = float(a)
        self.h = float(h) if h is not None else math.sqrt(max(1.0 - a ** 2, 0.0))
        self.maxiter = int(maxiter)
        self.debug = bool(debug)
        self.postselect = bool(postselect)
        self.zero_cov_comp = float(zero_cov_comp)
        self.kernel = kernel  # kept for API parity; None = standard normal
        if kind not in ("systematic", "multinomial"):
            raise ValueError("kind must be 'systematic' or 'multinomial'")
        self.kind = kind
        if fill_strategy not in (None, "gather", "scan", "telescope"):
            raise ValueError(
                "fill_strategy must be None, 'gather', 'scan' or "
                "'telescope'")
        self.fill_strategy = fill_strategy
        self.canonicalize = bool(canonicalize)

    def __call__(self, model, key, particle_weights, particle_locations):
        w, x, _ = self.call_with_diagnostics(
            model, key, particle_weights, particle_locations)
        return w, x

    def call_with_diagnostics(self, model, key, particle_weights,
                              particle_locations):
        w = jnp.asarray(particle_weights)
        x = jnp.asarray(particle_locations)
        n, d = x.shape

        k_anc, k_draw = jax.random.split(key)
        mu, cov = weighted_moments(w, x)
        cov = cov + self.zero_cov_comp * jnp.eye(d, dtype=cov.dtype)
        # Cholesky, not sqrtm: any S with S Sᵀ = Σ gives the same proposal
        # law, and one Cholesky factor is cheaper than an eigh-based
        # sqrtm. The jitter above makes Σ strictly PD; a NaN-producing
        # failure (pathological Σ) falls back to the eigh route.
        L = jnp.linalg.cholesky(cov)
        L = jax.lax.cond(
            jnp.any(jnp.isnan(L)),
            lambda _: sqrtm_psd(cov),
            lambda _: L,
            None)
        S = L * self.h

        if self.kind == "systematic":
            x_anc = systematic_resample_locations_counting(
                k_anc, w, x,
                strategy=self.fill_strategy or _default_fill_strategy(d))
        else:
            x_anc = x[multinomial_ancestors(k_anc, w)]
        centers = self.a * x_anc + (1.0 - self.a) * mu[None, :]

        def propose(k):
            z = (jax.random.normal(k, (n, d)) if self.kernel is None
                 else self.kernel(k, (n, d)))
            return centers + z @ S.T

        k_first, k_loop = jax.random.split(k_draw)
        new_x = propose(k_first)
        n_fallback = jnp.asarray(0, jnp.int32)
        if self.postselect and self.maxiter > 0:
            valid = model.are_models_valid(new_x)

            # Early-exit rejection: a while_loop that stops as soon as every
            # slot is valid (the common case needs ZERO redraw rounds, where
            # the reference — and a lax.scan — would pay all `maxiter`).
            def cond(carry):
                _, cur_valid, _, it = carry
                return (~jnp.all(cur_valid)) & (it < self.maxiter)

            def body(carry):
                cur_x, cur_valid, k, it = carry
                k, sub = jax.random.split(k)
                fresh = propose(sub)
                fresh_valid = model.are_models_valid(fresh)
                take = (~cur_valid) & fresh_valid
                cur_x = jnp.where(take[:, None], fresh, cur_x)
                return (cur_x, cur_valid | fresh_valid, k, it + 1)

            # k_loop is a FRESH split — re-splitting the consumed k_first
            # would correlate redraw streams with the rejected proposal
            new_x, valid, _, _ = jax.lax.while_loop(
                cond, body, (new_x, valid, k_loop, jnp.asarray(0)))
            # Fallback: still-invalid slots inherit their ancestor directly
            # (ancestors are valid by induction) — the bounded-shape analogue
            # of the reference's ResamplerWarning path. The count is
            # surfaced to the engine, which accumulates it in the state and
            # emits ``ResamplerWarning`` host-side when it grows.
            n_fallback = jnp.sum(~valid).astype(jnp.int32)
            new_x = jnp.where(valid[:, None], new_x, x_anc)

        # canonicalize by default (reference parity: the reference applies
        # it after every resample). The redraw loop above only guarantees
        # validity within the model's psd_tol, while canonicalize may
        # promise a strictly tighter invariant (e.g. TomographyModel
        # projects anything outside 1e-6 of the PSD cone); models gate
        # their own expensive projections internally, so this call is
        # cheap on the all-valid common path. Resample-MOVE configs skip
        # it (ctor flag) — the move block re-gates validity and owns the
        # strict projection.
        if self.canonicalize:
            new_x = model.canonicalize(new_x)
        new_w = jnp.full((n,), 1.0 / n, dtype=w.dtype)
        return new_w, new_x, n_fallback
