"""ipyparallel-style model parallelization (API-parity shim).

Reference parity: ``src/qinfer/parallel.py::DirectViewParallelizedModel`` —
wraps a serial model and scatters the **modelparams (particle) axis** over
the engines of a DirectView-like object (``scatter``/``gather``/``apply``/
``__len__``), falling back to serial evaluation below a threshold.

On accelerators this pattern is superseded by mesh sharding
(:class:`~qinfer_tpu.parallel.mesh.ParticleMesh`) — kept here because (a)
the reference API promises it, (b) tests exercise engine-pool semantics with
serial mock views exactly like the reference's test suite (SURVEY.md §4
"Distributed tests without a cluster").
"""

from __future__ import annotations

import warnings

import numpy as np
import jax.numpy as jnp

from ..derived_models import DerivedModel

__all__ = ["DirectViewParallelizedModel"]


class DirectViewParallelizedModel(DerivedModel):
    """Parallelize ``likelihood`` over the model-parameter axis via a
    DirectView-like executor.

    Reference parity: ``src/qinfer/parallel.py::DirectViewParallelizedModel
    (serial_model, direct_view, purge_client, serial_threshold)``.
    """

    #: Signals the SMC engine to run update steps eagerly (this likelihood
    #: dispatches to a host-side engine pool and cannot be traced by XLA).
    host_only = True

    def __init__(self, serial_model, direct_view, purge_client=False,
                 serial_threshold=None):
        super().__init__(serial_model)
        self.direct_view = direct_view
        self.purge_client = bool(purge_client)
        self.serial_threshold = (int(serial_threshold)
                                 if serial_threshold is not None
                                 else 10 * self.n_engines)

    @property
    def n_engines(self):
        """Number of engines behind the view.

        Reference parity: ``DirectViewParallelizedModel.n_engines``.
        """
        try:
            return max(1, len(self.direct_view))
        except TypeError:
            return 1

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = np.atleast_2d(np.asarray(modelparams))
        n_models = modelparams.shape[0]
        if n_models <= self.serial_threshold or self.n_engines == 1:
            return self.underlying_model.likelihood(
                outcomes, modelparams, expparams)

        chunks = np.array_split(modelparams, self.n_engines, axis=0)
        serial = self.underlying_model

        def eval_chunk(chunk):
            return np.asarray(serial.likelihood(outcomes, chunk, expparams))

        try:
            results = [self.direct_view.apply(eval_chunk, c) for c in chunks]
            results = [r.get() if hasattr(r, "get") else r for r in results]
        except Exception as err:  # pragma: no cover - remote failures
            warnings.warn(
                f"DirectView apply failed ({err!r}); falling back to serial")
            return serial.likelihood(outcomes, modelparams, expparams)
        finally:
            if self.purge_client and hasattr(self.direct_view, "purge_results"):
                self.direct_view.purge_results("all")
        return jnp.concatenate(
            [jnp.asarray(r) for r in results], axis=1)
