"""Distributed (shard-local) Liu-West resampling.

SURVEY.md §7 names distributed resampling the #1 hard part: categorical
ancestry across shards without gathering 10⁷ particles to one place, and
load-balancing when weight mass concentrates on one shard.

The scheme here is **two-level systematic resampling** (cf. PAPERS.md,
Murray et al., "Parallel resampling in the particle filter"):

1. *Shard level*: treat the D shard weight-masses ``W_d`` as D
   super-particles and draw a systematic allocation over them — each output
   shard ``s`` gets an ancestor shard ``A_s`` (expected multiplicity
   ``D · W_d``). Shards exchange whole fixed-size particle blocks along the
   ring (``ppermute``), so communication is static-shaped and rides ICI.
2. *Local level*: each shard systematically resamples its ``n/D`` slots
   from the received block's local weights, then applies the Liu-West
   shrinkage kernel with the **global** mean/covariance (computed via
   ``psum`` partial moments).

Expected copy count of particle i in shard d:
``E[#shards with A=d] · (n/D) · w_i/W_d = (D W_d)(n/D)(w_i/W_d) = n w_i``
— exactly unbiased, uniform output weights, and load-balanced by
construction (every shard ends with n/D equally-weighted particles).

Two block-exchange algorithms (selected by the ``exchange`` ctor arg,
identical outputs): a D-round ``ppermute`` ring (traffic ≤ n particles per
device — fine at slice scale) and a ``3·log₂D``-round butterfly
(:func:`butterfly_exchange_schedule`: compact → spread → segmented
broadcast, each phase provably collision-free) whose per-device traffic is
≤ 3·log₂D·n/D — the pod-scale shape.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import EPS
from ..resamplers import Resampler
from ..utils import sqrtm_psd

__all__ = ["DistributedLiuWestResampler", "shard_systematic_ancestors",
           "butterfly_exchange_schedule"]


def _local_systematic(u, weights, n_out):
    """Systematic ancestors within one shard — the same sort-free counting
    formulation as the single-device path."""
    from ..resamplers import counting_ancestors_from_u

    return counting_ancestors_from_u(u, weights, n_out)


def _local_systematic_locations(u, weights, locations):
    """Shard-local systematic resample producing locations directly
    (gather-free; see
    :func:`qinfer_tpu.resamplers.systematic_resample_locations_counting`).
    """
    from ..resamplers import counting_locations_from_u

    return counting_locations_from_u(u, weights, locations)


def shard_systematic_ancestors(u, shard_masses):
    """Level-1: ancestor shard index for every output shard (systematic
    over the D shard masses; D is tiny so this is replicated scalar work).
    """
    d = shard_masses.shape[0]
    cdf = jnp.cumsum(shard_masses)
    cdf = cdf / jnp.maximum(cdf[-1], EPS)
    positions = (jnp.arange(d, dtype=cdf.dtype) + u) / d
    return jnp.clip(jnp.searchsorted(cdf, positions), 0, d - 1)


def butterfly_exchange_schedule(anc_shard, n_dev):
    """Log-depth block-exchange schedule: move block ``d`` to every output
    shard ``s`` with ``anc_shard[s] == d`` in ``3·log₂(n_dev)`` rounds of
    STATIC ``ppermute`` rotations plus data-dependent take masks.

    ``anc_shard`` is sorted (systematic over shard masses), so the
    destinations of each surviving source form a contiguous segment
    ``[lo_d, hi_d]`` and the exchange decomposes into three provably
    collision-free phases (each shard relays at most ONE candidate at any
    time — the correctness hinge):

    1. **Compact** survivors to a rank prefix (rank ``r`` = number of
       surviving sources before ``d``): backward hops ``1, 2, …, D/2``
       (LSB-first), candidate ``r`` moving on bit ``h`` of its distance
       ``m_r = d_r − r``. Positions are ``r + (m_r mod 2h)`` with ``m``
       non-decreasing in ``r``; two candidates colliding would need the
       non-monotone part to invert the rank gap — impossible (time
       reversal of phase 2's argument).
    2. **Spread** ranks to segment starts ``lo_r``: forward hops
       ``D/2, …, 1`` (MSB-first) on ``δ_r = lo_r − r ≥ 0``; ``δ`` is
       non-decreasing (``δ_{r+1} − δ_r = mult_{d_r} − 1``), so positions
       ``r + ⌊δ_r/h⌋·h`` are strictly increasing in ``r`` — no collisions.
    3. **Segmented broadcast** within each ``[lo, hi]``: forward hops
       ``D/2, …, 1``; a shard holding its own target block forwards it,
       the receiver takes iff it is in the same segment; after the ``h``
       round every in-segment offset divisible by ``h`` holds.

    Per-shard traffic: ``3·log₂D`` blocks instead of the ring's ``D``
    (``parallel/resample.py`` ring docstring) — the pod-scale shape.

    :return: ``(shifts, takes)`` — static forward-rotation amounts per
        round (negative = backward) and a ``(n_rounds, D)`` bool array:
        ``takes[k, s]`` = shard ``s`` replaces its buffer with the one
        arriving from ``s − shifts[k]`` in round ``k``. After all rounds
        every shard ``s`` holds block ``anc_shard[s]``.
    """
    D = n_dev
    if D & (D - 1) or D < 2:
        raise ValueError("butterfly exchange needs a power-of-two mesh")
    log_d = D.bit_length() - 1
    r_arr = jnp.arange(D, dtype=jnp.int32)
    mult = jnp.zeros(D, jnp.int32).at[anc_shard].add(1)
    lo = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(mult)[:-1].astype(jnp.int32)])
    alive = mult > 0
    rank_of_d = jnp.cumsum(alive.astype(jnp.int32)) - 1
    n_surv = jnp.sum(alive.astype(jnp.int32))
    # source index per rank; ranks ≥ n_surv are inactive
    d_of_r = jnp.full(D, D, jnp.int32).at[
        jnp.where(alive, rank_of_d, D)].set(r_arr, mode="drop")
    active = r_arr < n_surv
    d_safe = jnp.minimum(d_of_r, D - 1)
    m = jnp.where(active, d_safe - r_arr, 0)         # compaction distance
    delta = jnp.where(active, lo[d_safe] - r_arr, 0)  # spread distance
    sentinel = D + r_arr  # inactive candidates never match a shard index

    shifts = []
    takes = []
    # phase 1: compact (backward, LSB-first)
    for k in range(log_d):
        h = 1 << k
        pos = jnp.where(active, d_safe - (m % h), sentinel)
        moves = ((m // h) % 2 == 1) & active
        take = jnp.zeros(D, bool).at[
            jnp.where(moves, pos - h, D)].set(True, mode="drop")
        shifts.append(-h)
        takes.append(take)
    # phase 2: spread (forward, MSB-first)
    for k in range(log_d - 1, -1, -1):
        h = 1 << k
        pos = jnp.where(active, r_arr + delta - (delta % (2 * h)), sentinel)
        moves = ((delta // h) % 2 == 1) & active
        take = jnp.zeros(D, bool).at[
            jnp.where(moves, pos + h, D)].set(True, mode="drop")
        shifts.append(h)
        takes.append(take)
    # phase 3: segmented broadcast from the segment starts
    have = jnp.zeros(D, bool).at[
        jnp.where(active, jnp.minimum(lo[d_safe], D - 1), D)].set(
        True, mode="drop")
    anc = jnp.asarray(anc_shard, jnp.int32)
    for k in range(log_d - 1, -1, -1):
        h = 1 << k
        take = jnp.roll(have, h) & (anc == jnp.roll(anc, h)) & ~have
        shifts.append(h)
        takes.append(take)
        have = have | take
    return shifts, jnp.stack(takes)


class DistributedLiuWestResampler(Resampler):
    """Liu-West resampler that decomposes over a 1-D particle mesh.

    Drop-in for :class:`~qinfer_tpu.resamplers.LiuWestResampler` when the
    ensemble is sharded: same ``(model, key, weights, locations) ->
    (weights, locations)`` signature, implemented as a ``shard_map`` over
    the mesh with only psum/all_gather/ppermute collectives.

    :param mesh: the :class:`jax.sharding.Mesh` (1-D) the ensemble lives on.
    :param str axis_name: mesh axis name.
    :param float a: Liu-West shrinkage (h = sqrt(1-a²)).
    :param int maxiter: bounded validity-redraw rounds (masked, like the
        single-device resampler).
    :param str exchange: block-exchange algorithm — ``'ring'`` (D−1
        rotation rounds, traffic ≤ n particles/device), ``'butterfly'``
        (``3·log₂D`` rounds via :func:`butterfly_exchange_schedule`,
        traffic ≤ 3·log₂D·n/D — the pod-scale shape; requires
        power-of-two D), or ``'auto'`` (butterfly when it uses fewer
        rounds, i.e. D ≥ 16 and a power of two). Both deliver block
        ``anc_shard[s]`` to shard ``s`` exactly, so results are
        bit-identical.
    """

    def __init__(self, mesh, axis_name="particles", a=0.98, h=None,
                 maxiter=10, zero_cov_comp=1e-10, exchange="auto"):
        # jax.sharding.Mesh is hashable, so it rides in the pytree's static
        # aux data and survives flatten/unflatten through jit.
        self.mesh = mesh
        self.axis_name = axis_name
        self.a = float(a)
        self.h = float(h) if h is not None else math.sqrt(max(1.0 - a ** 2, 0.0))
        self.maxiter = int(maxiter)
        self.zero_cov_comp = float(zero_cov_comp)
        if exchange not in ("auto", "ring", "butterfly"):
            raise ValueError("exchange must be 'auto', 'ring' or "
                             "'butterfly'")
        n_dev = mesh.shape[axis_name]
        pow2 = n_dev >= 2 and (n_dev & (n_dev - 1)) == 0
        if exchange == "butterfly" and not pow2:
            raise ValueError(
                f"butterfly exchange needs a power-of-two mesh, got "
                f"{n_dev} devices")
        if exchange == "auto":
            exchange = ("butterfly" if pow2 and 3 * (n_dev.bit_length() - 1)
                        < n_dev - 1 else "ring")
        self.exchange = exchange

    def __call__(self, model, key, particle_weights, particle_locations):
        w, x, _ = self.call_with_diagnostics(
            model, key, particle_weights, particle_locations)
        return w, x

    def call_with_diagnostics(self, model, key, particle_weights,
                              particle_locations):
        axis = self.axis_name
        mesh = self.mesh
        n, dim = particle_locations.shape
        n_dev = mesh.shape[axis]
        a, h = self.a, self.h
        maxiter = self.maxiter
        zcc = self.zero_cov_comp

        def kernel(key, w_loc, x_loc):
            idx = jax.lax.axis_index(axis)
            n_loc = w_loc.shape[0]

            # --- global moments via psum partials --------------------------
            total = jax.lax.psum(jnp.sum(w_loc), axis)
            w_norm = w_loc / jnp.maximum(total, EPS)
            mu = jax.lax.psum(w_norm @ x_loc, axis)
            xc = x_loc - mu[None, :]
            cov = jax.lax.psum((xc * w_norm[:, None]).T @ xc, axis)
            cov = cov + zcc * jnp.eye(dim, dtype=cov.dtype)
            L = jnp.linalg.cholesky(cov)
            L = jax.lax.cond(
                jnp.any(jnp.isnan(L)), lambda _: sqrtm_psd(cov),
                lambda _: L, None)
            S = L * h

            # --- level 1: shard ancestry + ring block exchange -------------
            k_shard, k_local, k_draw = jax.random.split(
                jax.random.fold_in(key, 0), 3)
            masses = jax.lax.all_gather(jnp.sum(w_norm), axis)  # (D,)
            u1 = jax.random.uniform(k_shard, ())  # same key -> same on all
            anc_shard = shard_systematic_ancestors(u1, masses)  # (D,)
            my_anc = anc_shard[idx]

            if self.exchange == "butterfly":
                # log-depth exchange: 3·log₂D static rotations with
                # data-dependent take masks (schedule replicated — every
                # shard derives it from the same anc_shard vector)
                shifts, takes = butterfly_exchange_schedule(
                    anc_shard, n_dev)
                buf = jnp.concatenate([x_loc, w_norm[:, None]], axis=1)
                for r, shift in enumerate(shifts):
                    perm = [(s, (s + shift) % n_dev) for s in range(n_dev)]
                    rot = jax.lax.ppermute(buf, axis, perm)
                    buf = jnp.where(takes[r, idx], rot, buf)
                recv_x = buf[:, :dim]
                recv_w = buf[:, dim]
            else:
                recv_w = w_norm
                recv_x = x_loc
                for r in range(1, n_dev):
                    perm = [(s, (s + r) % n_dev) for s in range(n_dev)]
                    rot_w = jax.lax.ppermute(w_norm, axis, perm)
                    rot_x = jax.lax.ppermute(x_loc, axis, perm)
                    src = (idx - r) % n_dev
                    take = my_anc == src
                    recv_w = jnp.where(take, rot_w, recv_w)
                    recv_x = jnp.where(take[None, None] if recv_x.ndim == 2
                                       else take, rot_x, recv_x)

            # --- level 2: local systematic over the received block ---------
            u2 = jax.random.uniform(jax.random.fold_in(k_local, idx), ())
            if dim <= 4:
                # gather-free: scatter + log-depth fill instead of a
                # shard-local random gather of n_loc rows
                x_anc = _local_systematic_locations(u2, recv_w, recv_x)
            else:
                x_anc = recv_x[_local_systematic(u2, recv_w, n_loc)]
            centers = a * x_anc + (1.0 - a) * mu[None, :]

            def propose(k):
                z = jax.random.normal(k, (n_loc, dim))
                return centers + z @ S.T

            k_draw = jax.random.fold_in(k_draw, idx)
            k_first, k_loop = jax.random.split(k_draw)
            new_x = propose(k_first)
            valid = model.are_models_valid(new_x)

            def cond(carry):
                _, cur_valid, _, it = carry
                return (~jnp.all(cur_valid)) & (it < maxiter)

            def body(carry):
                cur_x, cur_valid, k, it = carry
                k, sub = jax.random.split(k)
                fresh = propose(sub)
                fresh_valid = model.are_models_valid(fresh)
                take = (~cur_valid) & fresh_valid
                cur_x = jnp.where(take[:, None], fresh, cur_x)
                return (cur_x, cur_valid | fresh_valid, k, it + 1)

            new_x, valid, _, _ = jax.lax.while_loop(
                cond, body, (new_x, valid, k_loop, jnp.asarray(0)))
            # global degraded-slot count (reference ResamplerWarning path)
            n_fb = jax.lax.psum(jnp.sum(~valid).astype(jnp.int32), axis)
            new_x = jnp.where(valid[:, None], new_x, x_anc)
            new_x = model.canonicalize(new_x)
            new_w = jnp.full((n_loc,), 1.0 / n, dtype=w_loc.dtype)
            return new_w, new_x, n_fb

        shard = P(axis)
        shard2d = P(axis, None)
        mapped = jax.shard_map(
            kernel, mesh=mesh,
            in_specs=(P(), shard, shard2d),
            out_specs=(shard, shard2d, P()),
            check_vma=False)
        return mapped(key, particle_weights, particle_locations)
