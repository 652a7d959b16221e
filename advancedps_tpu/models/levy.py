"""Lévy-driven stochastic volatility SSM (reference ``examples/levy-ssm``).

The reference simulates a Gamma-process jump path with a data-dependent ``while``
loop (``/root/reference/examples/levy-ssm/script.jl:21-40``) — impossible under XLA.
The array-native redesign draws a **fixed budget of K candidate jumps** and masks:

* arrival times ``t_k`` = cumsative sums of Exp(1/rate) draws (Poisson-process
  arrivals, as the reference's ``t += rand(Exponential(1/rate))``);
* jump sizes ``x_k = 1 / (β (exp(t_k / C) − 1))`` — strictly decreasing in ``t_k``;
* thinning acceptance ``u_k < (1 + β x_k)·exp(−β x_k)``;
* truncation mask ``x_k ≥ tol`` (replaces the loop's exit condition — since sizes
  decrease, everything past the first sub-tolerance jump is dropped).

``K`` is chosen so P(a super-tolerance jump beyond K arrivals) is negligible; all
shapes are static and the whole path simulation vectorises over particles.

Langevin transition (``script.jl:52-66,84-88``): state ``[x, ẋ]`` with
``exp(A dt) = [[1, (e^{θdt}−1)/θ], [0, e^{θdt}]]`` and jump-driven MvNormal
mean/covariance; linear-Gaussian observation on the first component.

Note on PGAS: the transition density is *conditionally* Gaussian given a random
jump path, so scoring draws a fresh path — a random-weight ancestor estimate,
mirroring the reference whose ``distribution(proc, step, state)`` also simulates a
fresh path at scoring time (``script.jl:84-88``).  The scoring path key is a pure
function of the step, shared across particles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..distributions import MvNormal, Normal
from ..ssm import LatentDynamics, ObservationProcess, StatePrior, StateSpaceModel
from ..utils.trees import pytree_dataclass, static_field

__all__ = ["GammaProcess", "LevyPrior", "LevyLangevinDynamics", "levy_ssm"]


@pytree_dataclass
class GammaProcess:
    """Gamma process (C, β) with truncation tolerance and a static jump budget."""

    C: jax.Array = 1.0
    beta: jax.Array = 1.0
    tol: float = static_field(default=1e-10)
    max_jumps: int = static_field(default=64)

    def simulate(self, key, rate, start, finish):
        """Return (jumps [K], times [K], mask [K]) for the interval [start, finish)."""
        k_arr, k_acc, k_t = jax.random.split(key, 3)
        K = self.max_jumps
        gaps = jax.random.exponential(k_arr, (K,)) / rate
        ts = jnp.cumsum(gaps)
        x = 1.0 / (self.beta * (jnp.exp(ts / self.C) - 1.0))
        prob = (1.0 + self.beta * x) * jnp.exp(-self.beta * x)
        accept = jax.random.uniform(k_acc, (K,)) < prob
        mask = accept & (x >= self.tol)
        times = jax.random.uniform(k_t, (K,), minval=start, maxval=finish)
        return x, times, mask


@pytree_dataclass
class LevyPrior(StatePrior):
    vectorized = True

    mu: jax.Array
    cov: jax.Array

    def distribution(self):
        return MvNormal(self.mu, self.cov)


@pytree_dataclass
class LevyLangevinDynamics(LatentDynamics):
    """Langevin dynamics driven by a Gamma-process subordinator.

    ``theta``: mean-reversion; ``dt``: step size; ``mu_w``/``sigma_w``: jump-mark
    Gaussian (reference ``LevyLangevin`` + ``meancov``,
    ``/root/reference/examples/levy-ssm/script.jl:52-88``).
    """

    dt: jax.Array = 0.5
    theta: jax.Array = -0.5
    mu_w: jax.Array = 0.0
    sigma_w: jax.Array = 1.0
    process: GammaProcess = GammaProcess()
    jitter: float = static_field(default=1e-6)
    score_seed: int = static_field(default=7)

    def _expm(self, dt):
        f = jnp.exp(self.theta * dt)
        return jnp.array([[1.0, (f - 1.0) / self.theta], [0.0, f]])

    def _meancov(self, key, step):
        dt = self.dt
        start = (step - 1) * dt
        finish = step * dt
        jumps, times, mask = self.process.simulate(key, dt, start, finish)
        # f_k = exp(A (t_end - t_k)) @ L  with L = [0, 1]
        f = jnp.exp(self.theta * (finish - times))  # [K]
        fts = jnp.stack([(f - 1.0) / self.theta, f], axis=-1)  # [K, 2]
        m = mask.astype(fts.dtype)[:, None]
        mu = jnp.sum(fts * m * self.mu_w * jumps[:, None], axis=0)
        cov = jnp.einsum(
            "ki,kj->ij", fts * m * (jumps[:, None]), fts,
            precision=lax.Precision.HIGHEST,
        ) * (self.sigma_w**2)
        return mu, cov + self.jitter * jnp.eye(2)

    def _dist(self, key, step, state):
        mu, cov = self._meancov(key, step)
        mean = jnp.matmul(
            self._expm(self.dt), state, precision=lax.Precision.HIGHEST
        ) + mu
        return MvNormal(mean, cov)

    # LatentDynamics interface: sample uses the particle's key; log_prob uses a
    # step-derived scoring key (random-weight PGAS, see module docstring).
    def sample(self, key, step, state, history=None):
        k_path, k_noise = jax.random.split(key)
        return self._dist(k_path, step, state).sample(k_noise)

    def log_prob(self, step, state, x, history=None):
        k_score = jax.random.fold_in(jax.random.key(self.score_seed), step)
        return self._dist(k_score, step, state).log_prob(x)

    def distribution(self, step, state):  # pragma: no cover - direct use
        raise NotImplementedError(
            "LevyLangevinDynamics is conditionally Gaussian given a random jump "
            "path; use sample()/log_prob()"
        )


@pytree_dataclass
class LevyObservation(ObservationProcess):
    vectorized = True

    """y_t ~ N(H·x_t, σ_e) with H = [1, 0] (reference ``script.jl:90-98``)."""

    sigma_e: jax.Array = 1.0

    def distribution(self, step, state):
        return Normal(state[..., 0], self.sigma_e)


def levy_ssm(
    dt=0.5,
    theta=-0.5,
    sigma_e=1.0,
    C=1.0,
    beta=1.0,
    mu_w=0.0,
    sigma_w=1.0,
    max_jumps=64,
) -> StateSpaceModel:
    """Reference ``LevyModel`` (``/root/reference/examples/levy-ssm/script.jl:100-111``)."""
    return StateSpaceModel(
        prior=LevyPrior(mu=jnp.zeros(2), cov=jnp.eye(2)),
        dynamics=LevyLangevinDynamics(
            dt=dt,
            theta=theta,
            mu_w=mu_w,
            sigma_w=sigma_w,
            process=GammaProcess(C=C, beta=beta, max_jumps=max_jumps),
        ),
        observation=LevyObservation(sigma_e=sigma_e),
    )
