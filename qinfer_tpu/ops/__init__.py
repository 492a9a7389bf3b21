"""Resampling primitives and the reference-parity accelerated model.

The reference's single native-code artifact is an OpenCL likelihood kernel
(``src/qinfer/gpu_models.py::AcceleratedPrecessionModel``, SURVEY.md §2
#18). Its counterparts here are plain ``jax.numpy`` that XLA compiles:

* :mod:`qinfer_tpu.ops.resample` — systematic-resampling ancestor
  selection (counting formulation of the CDF inversion).
* :mod:`qinfer_tpu.ops.accelerated` — ``AcceleratedPrecessionModel``, the
  reference-name parity class.
"""

from .resample import systematic_resample_indices
from .accelerated import AcceleratedPrecessionModel

__all__ = [
    "systematic_resample_indices",
    "AcceleratedPrecessionModel",
]
