"""advancedps_tpu — a particle-based inference engine for accelerators.

A from-scratch JAX/XLA framework with the capabilities of
TuringLang/AdvancedPS.jl (bootstrap SMC, Particle Gibbs, PGAS over a state-space-model
DSL), redesigned for accelerators: dense particle-axis arrays advanced by ``lax.scan``,
positional counter-based RNG keys, vectorised resampling, genealogy-based trajectory
storage, and ``shard_map`` collectives for multi-chip scaling.

Quick start::

    import jax
    import advancedps_tpu as aps

    model = aps.models.LinearGaussianSSM(a=0.9, b=0.0, q=0.32, r=1.0)
    xs, ys = aps.simulate(jax.random.key(0), model.ssm, 200)
    traced = aps.TracedSSM(model.ssm, ys)
    chain = aps.sample(jax.random.key(1), traced, aps.PGAS(20), 500)
"""

from . import distributions
from . import models
from . import rng
from . import utils
from .distributions import (
    Bernoulli,
    Beta,
    Categorical,
    Dirac,
    Exponential,
    Gamma,
    LogNormal,
    MvNormal,
    Normal,
    Poisson,
    StudentT,
    Uniform,
)
from .engine import SweepKernel, SweepResult, lineages, reconstruct, sweep
from .generic import GenericModel, GenericSSMKernel, observe, sample_site
from .inference import make_kernel, sample, sample_pg, sample_smc, step_pg
from .pg import PG, PGAS, PGSample, PGState
from .resampling import (
    DEFAULT_RESAMPLER,
    ResampleWithESSThreshold,
    effective_sample_size,
    randcat,
    resample_multinomial,
    resample_residual,
    resample_stratified,
    resample_systematic,
)
from .smc import SMC, SMCSample, SSMKernel
from .ssm import (
    History,
    LatentDynamics,
    ObservationProcess,
    StatePrior,
    StateSpaceModel,
    TracedSSM,
    simulate,
)

__version__ = "0.1.0"
