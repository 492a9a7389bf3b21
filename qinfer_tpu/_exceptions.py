"""Warnings and exceptions used across the package.

Reference parity: ``src/qinfer/_exceptions.py::ApproximationWarning`` and the
resampler warnings/errors (``src/qinfer/resamplers.py::ResamplerWarning`` /
``ResamplerError``). We centralise all of them here.
"""

__all__ = [
    "ApproximationWarning",
    "ResamplerWarning",
    "ResamplerError",
    "ZeroWeightWarning",
    "ZeroWeightError",
]


class ApproximationWarning(RuntimeWarning):
    """Emitted when an approximation (e.g. ALE likelihood estimation, bounded
    rejection in the resampler) may have exceeded its configured tolerance."""


class ResamplerWarning(RuntimeWarning):
    """Emitted when a resampler had to fall back to a degraded strategy, e.g.
    when the bounded validity-rejection loop exhausted its iteration budget
    and invalid proposals were replaced by their (valid) ancestors."""


class ResamplerError(RuntimeError):
    """Raised when a resampler cannot produce a valid particle set at all."""


class ZeroWeightWarning(RuntimeWarning):
    """Emitted when an observed datum annihilated (numerically) all particle
    weights and the updater's ``zero_weight_policy`` recovered by resetting."""


class ZeroWeightError(RuntimeError):
    """Raised when an observed datum annihilated all particle weights and the
    updater's ``zero_weight_policy`` is ``'error'``."""
