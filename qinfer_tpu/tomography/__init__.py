"""Quantum state (and process) tomography.

Reference parity: ``src/qinfer/tomography/`` (SURVEY.md §2 #11) — bases,
density-operator priors, likelihood models, measurement heuristics and
plotting. The reference requires **QuTiP**; this rebuild represents
operator bases as stacked complex JAX arrays, so Ginibre/Haar sampling,
PSD checks (``eigh``) and the Born-rule likelihood are all native XLA and
run on the device (SURVEY.md §7 "Tomography without QuTiP").
"""

from .bases import (
    TomographyBasis,
    pauli_basis,
    gell_mann_basis,
    tensor_product_basis,
)
from .distributions import (
    DensityOperatorDistribution,
    GinibreDistribution,
    GinibreReditDistribution,
    BCSZChoiDistribution,
    GADFLIDistribution,
)
from .models import (TomographyModel, DiffusiveTomographyModel,
                     ProcessTomographyModel)
from .plotting_tools import (
    rebit_coords,
    plot_rebit_posterior,
    plot_decaying_exponentials,
)
from .expdesign import (
    RandomPauliHeuristic,
    RandomStabilizerStateHeuristic,
    ProductHeuristic,
    BestOfKMetaheuristic,
)

__all__ = [
    "rebit_coords",
    "plot_rebit_posterior",
    "plot_decaying_exponentials",
    "TomographyBasis",
    "pauli_basis",
    "gell_mann_basis",
    "tensor_product_basis",
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
    "TomographyModel",
    "DiffusiveTomographyModel",
    "ProcessTomographyModel",
    "RandomPauliHeuristic",
    "RandomStabilizerStateHeuristic",
    "ProductHeuristic",
    "BestOfKMetaheuristic",
]
