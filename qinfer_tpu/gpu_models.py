"""Accelerated models (reference-name compatibility module).

Reference parity: ``src/qinfer/gpu_models.py`` — the reference keeps its
OpenCL-accelerated ``AcceleratedPrecessionModel`` in a module of this name;
the implementation lives in :mod:`qinfer_tpu.ops.accelerated` and is
re-exported here so reference users find it at the expected path.
"""

from .ops.accelerated import AcceleratedPrecessionModel

__all__ = ["AcceleratedPrecessionModel"]
