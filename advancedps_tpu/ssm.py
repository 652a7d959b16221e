"""State-space-model DSL — the JAX re-provision of the ``SSMProblems`` contract.

The reference programs its samplers against the ``SSMProblems`` protocol
(``/root/reference/src/AdvancedPS.jl:8``): a model is ``StateSpaceModel(prior, dyn,
obs)`` where the user supplies ``distribution(...)`` methods and gets
``simulate``/``logdensity`` for free (usage: ``/root/reference/test/pgas.jl:17-31``,
``/root/reference/examples/gaussian-ssm/script.jl:37-69``).

Here the same three-part protocol is expressed as pytree dataclasses whose
``distribution`` methods build :mod:`advancedps_tpu.distributions` objects.  Because
distributions are pytrees of arrays, one ``vmap`` over the particle axis turns a
user's scalar model into a dense, fused, all-particles kernel — no per-particle
objects, no coroutines.

Steps are **0-based** (the Julia reference is 1-based).

Non-Markovian models (e.g. the GP-SSM,
``/root/reference/examples/gaussian-process/script.jl:59-64``, which conditions on the
whole past trajectory) set ``needs_history = True`` on their dynamics; the sweep engine
then materialises a per-particle history buffer and passes ``History(states, length)``
to ``distribution`` (SURVEY.md §7 hard part (f)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils.trees import pytree_dataclass
from . import rng as rngmod

__all__ = [
    "StatePrior",
    "LatentDynamics",
    "ObservationProcess",
    "StateSpaceModel",
    "TracedSSM",
    "History",
    "simulate",
]


class StatePrior:
    """Initial-state distribution. Subclass and implement ``distribution(self)``.

    ``vectorized = True`` declares that sampling N draws via
    ``distribution().sample(key, (n,))`` is valid — the sweep engine then uses one
    batched counter pass per step (the fast path) instead of per-particle keys.
    """

    vectorized: bool = False

    def distribution(self):
        raise NotImplementedError

    def sample(self, key):
        return self.distribution().sample(key)

    def log_prob(self, x):
        return self.distribution().log_prob(x)


class LatentDynamics:
    """Transition kernel ``x_t | x_{t-1}``.

    Implement ``distribution(self, step, state)`` — or, for non-Markovian models,
    set ``needs_history = True`` and implement
    ``distribution(self, step, state, history)``.

    ``vectorized = True`` declares that ``distribution(step, x_batch)`` with a
    batched state array returns a correctly-batched distribution (i.e. the
    parameter computation broadcasts elementwise) — the engine then samples all
    particles with one key in one counter pass.  Leave ``False`` for per-particle
    computations that do not broadcast (matrix solves, jump-path simulation).
    """

    needs_history: bool = False
    vectorized: bool = False

    def distribution(self, step, state, history=None):
        raise NotImplementedError

    def sample(self, key, step, state, history=None):
        return self._dist(step, state, history).sample(key)

    def log_prob(self, step, state, x, history=None):
        return self._dist(step, state, history).log_prob(x)

    def _dist(self, step, state, history):
        if self.needs_history:
            return self.distribution(step, state, history)
        return self.distribution(step, state)


class ObservationProcess:
    """Observation kernel ``y_t | x_t``. Implement ``distribution(self, step, state)``.

    ``vectorized = True``: ``distribution(step, x_batch)`` broadcasts (see
    :class:`LatentDynamics`)."""

    vectorized: bool = False

    def distribution(self, step, state):
        raise NotImplementedError

    def sample(self, key, step, state):
        return self.distribution(step, state).sample(key)

    def log_prob(self, step, state, y):
        return self.distribution(step, state).log_prob(y)


@pytree_dataclass
class History:
    """Padded per-particle trajectory passed to non-Markovian dynamics.

    ``states``: ``[T_max, ...]`` buffer; rows ``>= length`` are undefined (zeros).
    ``length``: number of valid steps (traced scalar). Non-Markovian dynamics must
    mask on ``length`` — static shapes are what keep the sweep compilable.
    """

    states: jax.Array
    length: jax.Array


@pytree_dataclass
class StateSpaceModel:
    """Bundle of (prior, dynamics, observation) — reference
    ``SSMProblems.StateSpaceModel`` as used in ``/root/reference/src/model.jl:24-26``."""

    prior: StatePrior
    dynamics: LatentDynamics
    observation: ObservationProcess

    @property
    def markov(self) -> bool:
        return not getattr(self.dynamics, "needs_history", False)


@pytree_dataclass
class TracedSSM:
    """A state-space model paired with an observation sequence.

    API-parity wrapper for the reference's ``AdvancedPS.TracedSSM(model, y)``
    (``/root/reference/src/model.jl:13-28``): the dense ``X`` history the Julia
    struct carries per-particle lives instead in the sweep engine's state arrays.

    ``observations``: ``[T, ...]`` array; ``num_steps = T``.
    """

    model: StateSpaceModel
    observations: jax.Array

    @property
    def num_steps(self) -> int:
        return jnp.shape(self.observations)[0]

    @property
    def prior(self):
        return self.model.prior

    @property
    def dynamics(self):
        return self.model.dynamics

    @property
    def observation(self):
        return self.model.observation


def simulate(key: jax.Array, model: StateSpaceModel, num_steps: int):
    """Draw one latent/observation trajectory of length ``num_steps``.

    Equivalent of ``SSMProblems.sample(rng, model, T)`` used for data generation in
    ``/root/reference/examples/gaussian-ssm/script.jl:75``.  Returns ``(xs, ys)``
    with leading time axis.  Implemented as one ``lax.scan`` so it jit-compiles to a
    single fused program.
    """
    if not model.markov:
        return _simulate_nonmarkov(key, model, num_steps)

    k_init, k_scan = jax.random.split(key)
    kx0, ky0 = jax.random.split(k_init)
    x0 = model.prior.sample(kx0)
    y0 = model.observation.sample(ky0, 0, x0)

    def body(x_prev, inp):
        t, k = inp
        kx, ky = jax.random.split(k)
        x = model.dynamics.sample(kx, t, x_prev)
        y = model.observation.sample(ky, t, x)
        return x, (x, y)

    ts = jnp.arange(1, num_steps)
    keys = jax.random.split(k_scan, num_steps - 1)
    _, (xs, ys) = jax.lax.scan(body, x0, (ts, keys))
    xs = jnp.concatenate([x0[None], xs], axis=0)
    ys = jnp.concatenate([y0[None], ys], axis=0)
    return xs, ys


def _simulate_nonmarkov(key, model, num_steps):
    """Simulation with a materialised history buffer (static shapes)."""
    k_init, k_scan = jax.random.split(key)
    kx0, ky0 = jax.random.split(k_init)
    x0 = model.prior.sample(kx0)
    y0 = model.observation.sample(ky0, 0, x0)

    buf = jnp.zeros((num_steps,) + jnp.shape(x0), dtype=jnp.result_type(x0))
    buf = buf.at[0].set(x0)

    def body(carry, inp):
        x_prev, buf = carry
        t, k = inp
        kx, ky = jax.random.split(k)
        hist = History(states=buf, length=t)
        x = model.dynamics.sample(kx, t, x_prev, hist)
        y = model.observation.sample(ky, t, x)
        buf = jax.lax.dynamic_update_index_in_dim(buf, x, t, 0)
        return (x, buf), (x, y)

    ts = jnp.arange(1, num_steps)
    keys = jax.random.split(k_scan, num_steps - 1)
    _, (xs, ys) = jax.lax.scan(body, (x0, buf), (ts, keys))
    xs = jnp.concatenate([x0[None], xs], axis=0)
    ys = jnp.concatenate([y0[None], ys], axis=0)
    return xs, ys
