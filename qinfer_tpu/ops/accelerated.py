"""Reference-parity precession model with the reference's precision check.

Reference parity: ``src/qinfer/gpu_models.py::AcceleratedPrecessionModel``
(SURVEY.md §2 #18) — the reference embeds an OpenCL C kernel computing
cos²(ωt/2) over a particle × experiment grid and uploads/downloads buffers
via PyOpenCL. Here the plain likelihood already runs on the device inside
the compiled update: XLA fuses cos² × weight and the step's reductions, and
a hand-written fused kernel measured no faster end to end on the GPU
(PERF.md, "Kernels on H100"). The class keeps the reference's name and its
float32-only contract.
"""

from __future__ import annotations

from ..test_models import SimplePrecessionModel

__all__ = ["AcceleratedPrecessionModel"]


class AcceleratedPrecessionModel(SimplePrecessionModel):
    """Drop-in :class:`~qinfer_tpu.test_models.SimplePrecessionModel` with
    the reference's ``precision`` argument.

    Reference parity: ``gpu_models.py::AcceleratedPrecessionModel
    (precision='float')`` — float32 only, matching the reference's default
    precision.
    """

    def __init__(self, precision="float", min_freq=0.0):
        super().__init__(min_freq=min_freq)
        if precision not in ("float", "single", "float32"):
            raise ValueError(
                "AcceleratedPrecessionModel is float32; use "
                "SimplePrecessionModel for float64 (requires "
                "jax_enable_x64)")
        self.precision = "float"
