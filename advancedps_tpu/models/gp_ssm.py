"""Gaussian-process state-space model (non-Markovian).

Reference: ``/root/reference/examples/gaussian-process/script.jl`` — the latent
process is a zero-mean GP over *time indices*, conditioned at each step on the whole
past trajectory:

    prior   = GP(0, k)(1..t-1)
    post    = posterior(prior, X[1..t-1])
    x_t ~ N(mean(post at t), std(post at t))           (script.jl:59-64)

with a stochastic-volatility observation ``y_t ~ N(0, exp(x_t/2))``.

This is the model that forces the non-Markovian hook (SURVEY.md §7 hard part (f)):
dynamics receive a :class:`~advancedps_tpu.ssm.History` — the particle's padded
``[T]`` trajectory buffer plus its valid length — and perform **masked GP
regression** with static shapes: the kernel matrix is built over all T time points,
rows/columns at or beyond the current step are replaced by identity so one Cholesky
factorisation of a fixed-size [T, T] matrix serves every step.  vmapped over
particles, the per-step conditioning becomes a batched triangular solve.  The two
dot products run at full float32 precision (``Precision.HIGHEST``): a TF32
product (10-bit mantissa, the default for float32 matmuls on recent NVIDIA GPUs)
errs by about 1e-3 of ``v·v``, and the predictive variance ``k − v·v`` cancels,
which magnifies that error wherever the variance is small.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..distributions import Normal
from ..ssm import History, LatentDynamics, ObservationProcess, StateSpaceModel
from ..utils.trees import pytree_dataclass, static_field
from .lgssm import GaussianPrior
from .stochastic_volatility import StochasticVolatilityObservation

__all__ = ["SqExponentialKernel", "GPDynamics", "gp_ssm"]


@pytree_dataclass
class SqExponentialKernel:
    """k(i, j) = variance · exp(−(i−j)² / (2ℓ²)) — AbstractGPs' default RBF."""

    lengthscale: jax.Array = 1.0
    variance: jax.Array = 1.0

    def __call__(self, a, b):
        d = (a[..., :, None] - b[..., None, :]) / self.lengthscale
        return self.variance * jnp.exp(-0.5 * d * d)


@pytree_dataclass
class GPDynamics(LatentDynamics):
    """GP-posterior transition over time indices, conditioned on the history.

    ``num_steps`` fixes the static buffer length T.  Masked regression: with
    ``m_i = 1[i < t]``, we factor ``K̃ = m m^T ∘ K + diag(1 − m) + jitter·I`` —
    identity outside the active block — so ``chol(K̃)`` is valid for every step and
    the predictive reduces to two triangular solves.
    """

    num_steps: int = static_field(default=0)
    kernel: SqExponentialKernel = SqExponentialKernel()
    jitter: float = static_field(default=1e-6)

    needs_history = True

    def distribution(self, step, state, history: History):
        T = self.num_steps
        times = jnp.arange(T, dtype=jnp.result_type(float))
        m = (times < step).astype(times.dtype)  # [T] active-past mask

        K = self.kernel(times, times)  # [T, T]
        K_masked = K * m[:, None] * m[None, :] + jnp.diag(1.0 - m) + self.jitter * jnp.eye(T)
        chol = jnp.linalg.cholesky(K_masked)

        x = history.states * m  # masked past values
        k_star = self.kernel(times, jnp.asarray(step, times.dtype)[None])[:, 0] * m

        # alpha = K̃^{-1} x ; v = chol^{-1} k_star
        alpha = jax.scipy.linalg.cho_solve((chol, True), x)
        v = jax.scipy.linalg.solve_triangular(chol, k_star, lower=True)

        mean = jnp.dot(k_star, alpha, precision=lax.Precision.HIGHEST)
        var = self.kernel(
            jnp.asarray(step, times.dtype)[None], jnp.asarray(step, times.dtype)[None]
        )[0, 0] - jnp.dot(v, v, precision=lax.Precision.HIGHEST)
        var = jnp.maximum(var, self.jitter)
        return Normal(mean, jnp.sqrt(var))


def gp_ssm(num_steps: int, lengthscale=1.0, variance=1.0, prior_sigma=1.0) -> StateSpaceModel:
    """Reference ``GaussianProcessStateSpaceModel``
    (``/root/reference/examples/gaussian-process/script.jl:46-52``)."""
    return StateSpaceModel(
        prior=GaussianPrior(mu=0.0, sigma=prior_sigma),
        dynamics=GPDynamics(
            num_steps=num_steps,
            kernel=SqExponentialKernel(lengthscale=lengthscale, variance=variance),
        ),
        observation=StochasticVolatilityObservation(),
    )
