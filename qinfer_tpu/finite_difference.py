"""Central finite-difference gradients.

Reference parity: ``src/qinfer/finite_difference.py::FiniteDifference``
(SURVEY.md §2 #22) — used by :class:`~qinfer_tpu.abstract_model.ScoreMixin`
and the CG experiment designer. Most gradients here come from autodiff;
this survives for black-box objectives (e.g. host-side optimizer callbacks).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FiniteDifference"]


class FiniteDifference:
    """Functor approximating the gradient of ``func`` by central
    differences.

    Reference parity: ``finite_difference.py::FiniteDifference(func, n_args,
    h)`` — calling it on a point of ``n_args`` coordinates returns the
    gradient estimate.
    """

    def __init__(self, func, n_args, h=1e-6):
        self.func = func
        self.n_args = int(n_args)
        self.h = np.broadcast_to(np.asarray(h, dtype=float),
                                 (self.n_args,)).copy()

    def central(self, x):
        x = np.asarray(x, dtype=float).reshape(self.n_args)
        grad = np.empty(self.n_args)
        for i in range(self.n_args):
            dx = np.zeros(self.n_args)
            dx[i] = self.h[i]
            grad[i] = (np.asarray(self.func(x + dx))
                       - np.asarray(self.func(x - dx))) / (2 * self.h[i])
        return grad

    __call__ = central
