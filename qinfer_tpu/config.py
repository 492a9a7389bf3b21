"""Global configuration for qinfer_tpu.

The reference library has no config system (all configuration is constructor
kwargs — SURVEY.md §5). We keep that spirit: this module only holds numeric
defaults that must be consistent across the whole engine (dtypes, epsilons),
because the choice of ``float32`` vs ``float64`` is a hardware matter, not a
per-call preference.

Defaults:
  * particles / weights / likelihoods default to ``float32`` — accelerators
    run float64 at a fraction of the float32 rate.
  * accumulators that are sensitive to cancellation (log-evidence) are kept in
    ``float32`` but accumulated in log-space, which is well-conditioned.
  * integer outcomes use ``int32``.
"""

import jax.numpy as jnp

__all__ = ["default_dtype", "default_int_dtype", "EPS", "set_default_dtype"]

default_dtype = jnp.float32
default_int_dtype = jnp.int32

#: smallest safe positive float for clipping probabilities / weights
EPS = 1e-35


def set_default_dtype(dtype):
    """Set the package-wide default floating dtype (e.g. ``jnp.float64`` after
    enabling x64 with ``jax.config.update('jax_enable_x64', True)``)."""
    global default_dtype
    default_dtype = dtype
