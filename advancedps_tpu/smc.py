"""SSM sweep kernel + the SMC sampler (user API).

Reference counterparts: the per-particle stepping kernel ``advance!``
(``/root/reference/src/pgas.jl:53-89``) and the ``SMC`` sampler
(``/root/reference/src/smc.jl:1-57``).  The Julia ``advance!`` runs once per particle
per step; :class:`SSMKernel` runs **all particles at once** — transition sample,
reference-state injection, observation score and weight update fuse into one XLA
computation over the particle axis (SURVEY.md §2.5 "Accelerator-native equivalent").
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from . import rng as rngmod
from .engine import SweepKernel, inject_ref
from .resampling import (
    DEFAULT_RESAMPLER,
    ResampleWithESSThreshold,
)
from .ssm import History, TracedSSM
from .utils.trees import pytree_dataclass

__all__ = ["SSMKernel", "SMC", "SMCSample"]


@pytree_dataclass
class SSMKernel(SweepKernel):
    """Drives the sweep engine over a :class:`~advancedps_tpu.ssm.TracedSSM`.

    State layout (structure-of-arrays — the per-particle ``Trace`` objects of the
    reference dissolve, SURVEY.md §2.4):

    * Markov dynamics: ``state = x`` with shape ``[N, ...]``.
    * non-Markovian dynamics (``needs_history``): ``state = (x, buf)`` where ``buf``
      is the ``[N, T, ...]`` materialised history passed to the dynamics — the dense
      equivalent of the GP-SSM conditioning on the whole trajectory
      (``/root/reference/examples/gaussian-process/script.jl:59-64``).
    """

    ssm: TracedSSM

    @property
    def num_steps(self) -> int:
        return self.ssm.num_steps

    @property
    def _markov(self) -> bool:
        return self.ssm.model.markov

    # -- helpers -----------------------------------------------------------
    def _obs_logw(self, t, x):
        y_t = jax.tree_util.tree_map(lambda a: a[t], self.ssm.observations)
        obs = self.ssm.observation
        if obs.vectorized:
            return obs.log_prob(t, x, y_t)
        return jax.vmap(lambda xi: obs.log_prob(t, xi, y_t))(x)

    def _hist(self, buf, t):
        return History(states=buf, length=t)

    # -- SweepKernel interface ---------------------------------------------
    def init(self, rng, ref0, ref_mask):
        prior = self.ssm.prior
        n = rng.n
        if prior.vectorized:
            # One batched counter pass, element i a pure function of
            # (key, gids[i]) — bit-exact across sharding layouts and
            # recomputable per-particle for O(T) trajectory replay.
            x0 = prior.distribution().sample_rng(rng)
        else:
            x0 = jax.vmap(lambda k: prior.sample(k))(rng.particle_keys())
        x0 = inject_ref(ref_mask, ref0, x0)
        logw = self._obs_logw(0, x0)
        if self._markov:
            state = x0
        else:
            T = self.num_steps
            buf = jnp.zeros((n, T) + x0.shape[1:], dtype=jnp.result_type(x0))
            buf = buf.at[:, 0].set(x0)
            state = (x0, buf)
        return state, logw

    def step(self, t, rng, state, ref_t, ref_mask):
        dyn = self.ssm.dynamics
        if self._markov:
            x_prev = state
            if dyn.vectorized:
                # distribution(t, x_batch) broadcasts ⇒ one positional batched
                # sample (paired counter = global particle id pair;
                # layout-independent, half-cost when the slice is contiguous).
                x_new = dyn.distribution(t, x_prev).sample_rng(rng)
            else:
                x_new = jax.vmap(lambda k, x: dyn.sample(k, t, x))(
                    rng.particle_keys(), x_prev
                )
            x_new = inject_ref(ref_mask, ref_t, x_new)
            return x_new, self._obs_logw(t, x_new)

        x_prev, buf = state
        x_new = jax.vmap(
            lambda k, x, b: dyn.sample(k, t, x, self._hist(b, t))
        )(rng.particle_keys(), x_prev, buf)
        x_new = inject_ref(ref_mask, ref_t, x_new)
        buf = buf.at[:, t].set(x_new)
        return (x_new, buf), self._obs_logw(t, x_new)

    def snapshot(self, state):
        return state if self._markov else state[0]

    def transition_logprob(self, t, state, ref_t):
        dyn = self.ssm.dynamics
        if self._markov:
            if dyn.vectorized:
                return dyn.distribution(t, state).log_prob(ref_t)
            return jax.vmap(lambda x: dyn.log_prob(t, x, ref_t))(state)
        x_prev, buf = state
        return jax.vmap(
            lambda x, b: dyn.log_prob(t, x, ref_t, self._hist(b, t))
        )(x_prev, buf)


def _build_gated_resampler(resampler, threshold):
    """Mirror the reference's convenience constructors
    (``/root/reference/src/smc.jl:15-21,75-81``):

    * neither given              → systematic @ ESS 0.5
    * threshold only             → systematic @ threshold
    * resampler fn only          → that resampler, every step
    * resampler + threshold      → that resampler @ threshold
    """
    if isinstance(resampler, ResampleWithESSThreshold):
        return resampler
    if resampler is None and threshold is None:
        return ResampleWithESSThreshold()
    if resampler is None:
        return ResampleWithESSThreshold(DEFAULT_RESAMPLER, float(threshold))
    if isinstance(resampler, float) and threshold is None:
        return ResampleWithESSThreshold(DEFAULT_RESAMPLER, resampler)
    if threshold is None:
        return ResampleWithESSThreshold(resampler, float("inf"))
    return ResampleWithESSThreshold(resampler, float(threshold))


class SMC:
    """Sequential Monte Carlo sampler config (reference ``SMC``,
    ``/root/reference/src/smc.jl:1-21``)."""

    def __init__(self, n_particles: int, resampler=None, threshold=None):
        self.n_particles = int(n_particles)
        self.resampler = _build_gated_resampler(resampler, threshold)

    def __repr__(self):
        return f"SMC(n_particles={self.n_particles}, resampler={self.resampler})"


@pytree_dataclass
class SMCSample:
    """Reference ``SMCSample`` (``/root/reference/src/smc.jl:23-27``).

    ``trajectories``: ``[T, N, ...]`` (time-major, all weighted particle paths,
    reconstructed through the genealogy), ``weights``: normalised ``[N]``,
    ``log_evidence``: scalar.
    """

    trajectories: Any
    weights: jax.Array
    log_evidence: jax.Array
    diagnostics: Any = None
