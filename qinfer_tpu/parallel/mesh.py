"""Device-mesh plumbing for sharded particle ensembles.

The scale axis of SMC inference is the particle count (SURVEY.md §5): every
engine reduction (weight normalization, ESS, moments, Bayes risk) is a sum
over particles, so sharding the particle axis over a 1-D mesh makes the
whole engine SPMD with ``psum``-shaped collectives — the device-mesh
equivalent of ``src/qinfer/parallel.py::DirectViewParallelizedModel``'s
scatter/gather and of ``jax.distributed`` replacing the ipyparallel
controller.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["ParticleMesh", "make_particle_sharding", "initialize_multihost"]


class ParticleMesh:
    """A 1-D device mesh dedicated to the particle axis.

    :param devices: explicit device list (default: all available).
    :param str axis_name: mesh axis name (default ``'particles'``).
    """

    def __init__(self, devices=None, axis_name="particles"):
        if devices is None:
            devices = jax.devices()
        self.axis_name = axis_name
        self.mesh = Mesh(np.asarray(devices), (axis_name,))

    @property
    def n_devices(self):
        return int(np.prod(self.mesh.devices.shape))

    @property
    def particle_sharding(self):
        """Sharding for per-particle vectors ``(n,)``."""
        return NamedSharding(self.mesh, P(self.axis_name))

    @property
    def location_sharding(self):
        """Sharding for particle location matrices ``(n, d)``."""
        return NamedSharding(self.mesh, P(self.axis_name, None))

    @property
    def replicated(self):
        return NamedSharding(self.mesh, P())

    def pad_particles(self, n_particles):
        """Round ``n_particles`` up to a multiple of the mesh size (equal
        shards keep every chip busy; XLA requires divisibility for clean
        layouts)."""
        k = self.n_devices
        return int(-(-n_particles // k) * k)

    def shard_updater(self, updater):
        """Re-place an existing updater's state onto this mesh."""
        updater.sharding = self.particle_sharding
        updater.state = updater._shard_state(updater.state)
        return updater

    def __repr__(self):
        return f"<ParticleMesh {self.n_devices} devices axis={self.axis_name!r}>"


def make_particle_sharding(devices=None, axis_name="particles"):
    """Shorthand: the ``(n,)`` particle sharding over a fresh 1-D mesh."""
    return ParticleMesh(devices, axis_name).particle_sharding


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Initialize multi-host JAX (the ipyparallel-controller replacement).

    Thin wrapper over ``jax.distributed.initialize``; returns without
    calling it for single-host runs (no coordinator given) and tolerates
    re-initialization — but genuine misconfiguration (bad coordinator
    address, inconsistent process counts) propagates instead of silently
    degrading to single-process (which would make later cross-host
    collectives hang with no diagnostic).
    """
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-host: nothing to initialize
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as err:
        if "already" in str(err).lower():
            return
        raise
