"""Systematic-resampling ancestor selection.

The second SMC hot loop (SURVEY.md §3.2). Systematic resampling inverts the
weight CDF at stratified positions ``(i + u) / n``. Because both the CDF and
the positions are sorted, inversion is a linear merge — O(n) with
sequential structure; the data-parallel formulation used here is:

1. one ``cumsum`` over the weights (XLA's scan is log-depth and bandwidth
   bound),
2. a **counting formulation** of the merge: ancestor multiplicities are
   ``m_i = ceil(n·cdf_i − u) − ceil(n·cdf_{i−1} − u)``, a pure elementwise
   pass, and
3. the ancestor index vector is recovered from multiplicities by a second
   cumsum + ``searchsorted`` (both log-depth primitives).

This replaces the reference's iid-uniform ``cumsum + searchsorted``
multinomial draw (``src/qinfer/resamplers.py::LiuWestResampler.__call__``)
with the lower-variance stratified scheme (PAPERS.md: Murray et al.,
"Parallel resampling in the particle filter").

The production engine uses the counting formulations in
:mod:`qinfer_tpu.resamplers`; this module keeps the counting formulation
(`ancestor_multiplicities`) as the reference statement of the algorithm
and for diagnostics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["systematic_resample_indices", "ancestor_multiplicities"]


@jax.jit
def ancestor_multiplicities(weights, u):
    """Number of copies each particle receives under systematic resampling
    with offset ``u`` ∈ [0, 1): a pure elementwise counting pass.

    ``m_i = ceil(n·F_i − u) − ceil(n·F_{i−1} − u)`` where F is the weight
    CDF. Σ m_i = n exactly (the final CDF value is forced to 1).

    Delegates to the single guarded implementation
    (:func:`qinfer_tpu.resamplers.counting_multiplicities_from_u` — whose
    ``cummax`` guard against XLA's non-monotone parallel cumsum is
    load-bearing); only the counts are returned here.
    """
    from ..resamplers import counting_multiplicities_from_u

    n = weights.shape[0]
    m, _ = counting_multiplicities_from_u(u, weights, n)
    return m


@jax.jit
def systematic_resample_indices(key, weights):
    """Ancestor indices (sorted) for systematic resampling.

    Delegates to the merge-rank CDF inversion in
    :func:`qinfer_tpu.resamplers.systematic_ancestors` (one sort, no
    searchsorted); the stratified positions are ascending, so the result
    is already sorted.

    :return: (n,) int32 ancestor indices, sorted ascending.
    """
    from ..resamplers import systematic_ancestors

    return systematic_ancestors(key, weights)
