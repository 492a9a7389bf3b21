"""qinfer_tpu — a sequential-Monte-Carlo Bayesian inference engine on JAX.

A from-scratch JAX/XLA rebuild with the capabilities of QInfer
(reference: ``whitewhim2718/python-qinfer``; see SURVEY.md). The public
surface is a flat re-export, matching the reference convention
(``src/qinfer/__init__.py``).
"""

from .version import version, __version__

from .config import default_dtype, default_int_dtype, set_default_dtype
from ._exceptions import (
    ApproximationWarning,
    ResamplerWarning,
    ResamplerError,
    ZeroWeightWarning,
    ZeroWeightError,
)

from .domains import (
    Domain,
    RealDomain,
    IntegerDomain,
    MultinomialDomain,
)

from .distributions import (
    Distribution,
    SingleSampleMixin,
    UniformDistribution,
    DiscreteUniformDistribution,
    MVUniformDistribution,
    ConstantDistribution,
    NormalDistribution,
    MultivariateNormalDistribution,
    SlantedNormalDistribution,
    LogNormalDistribution,
    BetaDistribution,
    BetaBinomialDistribution,
    GammaDistribution,
    InterpolatedUnivariateDistribution,
    ProductDistribution,
    MixtureDistribution,
    PostselectedDistribution,
    ConstrainedSumDistribution,
    ParticleDistribution,
    HaarUniform,
    GinibreUniform,
    HilbertSchmidtUniform,
)

from .abstract_model import (
    Simulatable,
    Model,
    FiniteOutcomeModel,
    DifferentiableModel,
    ScoreMixin,
    expparams_to_dict,
    dict_to_expparams,
)

from .test_models import (
    SimplePrecessionModel,
    SimpleInversionModel,
    CoinModel,
    NoisyCoinModel,
    NDieModel,
    MultiCosineModel,
    RamseyModel,
)

from .smc import SMCState, SMCUpdater, SMCUpdaterBCRB
from .resamplers import LiuWestResampler

from .heuristics import Heuristic, PGH, ExpSparseHeuristic, IdentityHeuristic

from .clustering import particle_clusters, NO_CLUSTER
from .finite_difference import FiniteDifference

from .utils import (
    binomial_pdf,
    multinomial_pdf,
    sample_multinomial,
    outer_product,
    particle_meanfn,
    particle_covariance_mtx,
    in_ellipsoid,
    ellipsoid_volume,
    mvee,
    to_simplex,
    from_simplex,
    uniquify,
    assert_sigfigs_equal,
    format_uncertainty,
    compactspace,
    safe_shape,
)

# Subpackages / late modules are imported lazily where optional dependencies
# may be missing; the following are part of the core surface.
from .derived_models import (  # noqa: E402
    DerivedModel,
    PoisonedModel,
    BinomialModel,
    MultinomialModel,
    MLEModel,
    RandomWalkModel,
    GaussianRandomWalkModel,
    ReferencedPoissonModel,
)
from .rb import RandomizedBenchmarkingModel, p_to_F, F_to_p  # noqa: E402
from .ale import ALEApproximateModel, binom_est_p, binom_est_error  # noqa: E402
from .expdesign import (ExperimentDesigner, OptimizationAlgorithms,  # noqa: E402
                        select_candidate, design_from_candidates)
from .perf_testing import perf_test, perf_test_multiple  # noqa: E402
from .simple_est import simple_est_prec, simple_est_rb, load_data  # noqa: E402
from .parallel import (  # noqa: E402
    ParticleMesh,
    make_particle_sharding,
    DirectViewParallelizedModel,
)
from .gpu_models import AcceleratedPrecessionModel  # noqa: E402
from .checkpoint import save_updater, load_updater  # noqa: E402
from . import checkpoint  # noqa: E402
from .ipy import IPythonProgressBar  # noqa: E402
from . import tomography  # noqa: E402
from . import ops  # noqa: E402
from . import perf_testing  # noqa: E402
from ._due import due, Doi, BibTeX  # noqa: E402
