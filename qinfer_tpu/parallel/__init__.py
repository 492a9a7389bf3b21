"""Parallel / multi-device backend.

Reference parity: ``src/qinfer/parallel.py`` (SURVEY.md §2 #17) — the
reference scatters the particle axis over ipyparallel engines
(``DirectViewParallelizedModel``). The replacement here is a
**mesh-sharded particle ensemble**: the engine's arrays carry a
``NamedSharding`` over a 1-D ``particles`` mesh axis, and the exact same
jitted update/estimator code runs SPMD across all devices with XLA inserting
``psum`` / ``all_gather`` collectives (SURVEY.md §5 "Distributed
communication backend").

``DirectViewParallelizedModel`` is also provided for API parity (and for
running against reference-style engine pools or test mocks).
"""

from .mesh import (
    ParticleMesh,
    make_particle_sharding,
    initialize_multihost,
)
from .directview import DirectViewParallelizedModel
from .resample import DistributedLiuWestResampler

__all__ = [
    "ParticleMesh",
    "make_particle_sharding",
    "initialize_multihost",
    "DirectViewParallelizedModel",
    "DistributedLiuWestResampler",
]
