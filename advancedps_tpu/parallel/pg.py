"""Sharded PG / PGAS drivers.

Conditional SMC over the sharded sweep plus the retained-trajectory draw, handled
sharding-aware:

* the final log-weights ``[N]`` are replicated (small) before the categorical draw;
* the retained trajectory is extracted from the sharded state stack ``[T, N@p, ...]``
  by a **one-hot contraction** over the particle axis — ``traj[t] = Σ_n 1[lin_t = n]
  · states[t, n]`` — which XLA lowers to a local partial reduction plus one
  ``psum``-style all-reduce over the interconnect, instead of a cross-shard dynamic gather.

This mirrors the single-chip drivers in :mod:`advancedps_tpu.inference`; the chain
state (:class:`~advancedps_tpu.pg.PGState`) is identical, so chains can move between
sharded and unsharded execution.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import rng as rngmod
from ..engine import lineages
from ..pg import PG, PGSample, PGState
from ..resampling import randcat_gumbel
from .mesh import PARTICLE_AXIS
from .sharded import sharded_sweep

__all__ = ["reconstruct_one_sharded", "sharded_step_pg", "sharded_sample_pg"]


def reconstruct_one_sharded(states, ancestors, index):
    """Single trajectory through the genealogy via one-hot contraction.

    ``states``: pytree ``[T, N, ...]`` (particle axis may be sharded);
    ``ancestors``: ``[T, N]`` (replicated); ``index``: scalar final slot.
    """
    lin = lineages(ancestors)  # [T, N]
    idx_t = lin[:, index]  # [T]
    n = ancestors.shape[1]
    onehot = jax.nn.one_hot(idx_t, n, dtype=jnp.float32)  # [T, N]

    def one(s):
        # s: [T, N, ...] -> [T, ...]; contraction over the (sharded) particle axis.
        w = onehot.reshape(onehot.shape + (1,) * (s.ndim - 2))
        return (w * s.astype(jnp.float32)).sum(axis=1).astype(s.dtype)

    return jax.tree_util.tree_map(one, states)


def sharded_step_pg(
    key: jax.Array,
    kernel,
    sampler: PG,
    mesh: Mesh,
    state: Optional[PGState] = None,
    axis: str = PARTICLE_AXIS,
    trajectory_storage: str = "dense",
    exchange: str = "auto",
):
    """One sharded PG(AS) iteration.  Returns ``(PGSample, PGState)``.

    ``trajectory_storage="replay"`` is the sharded form of genealogy
    compaction (see :func:`advancedps_tpu.inference.step_pg`): the sweep keeps
    only the ``[T, N]`` ancestor trace sharded-free of state snapshots, and the
    retained trajectory is re-sampled along its lineage from the positional
    RNG — the replay consumes the same ``(key, stream, step, global id)``
    counters the sharded sweep drew, so the draws are identical by
    construction.  ``exchange`` selects the resampling state-exchange strategy
    (:func:`~advancedps_tpu.parallel.sharded.sweep_shard_body`).
    """
    if trajectory_storage not in ("dense", "replay"):
        raise ValueError(f"unknown trajectory_storage {trajectory_storage!r}")
    replay = trajectory_storage == "replay"
    ref = None if state is None else state.trajectory
    res = sharded_sweep(
        key,
        kernel,
        sampler.n_particles,
        sampler.resampler,
        mesh,
        ref=ref,
        ancestor_sampling=sampler.ancestor_sampling and ref is not None,
        store_states=not replay,
        axis=axis,
        exchange=exchange,
    )
    # Replicate the (small) final weights before the categorical draw; the state
    # stack stays sharded and the trajectory extraction contracts over it.
    rep = NamedSharding(mesh, P())
    logw = jax.sharding.reshard(res.log_weights, rep)
    ancestors = jax.sharding.reshard(res.ancestors, rep)
    draw_key = rngmod.step_key(key, rngmod.DRAW, 0)
    idx = randcat_gumbel(draw_key, logw)
    if replay:
        from ..engine import replay_trajectory

        # The genealogy is replicated and the replay is a single-particle
        # O(T·D) program: run it replicated rather than inventing a collective.
        traj = replay_trajectory(key, kernel, ancestors, idx, ref=ref)
    else:
        traj = reconstruct_one_sharded(res.states, ancestors, idx)
        traj = jax.sharding.reshard(traj, NamedSharding(mesh, P()))
    return PGSample(trajectory=traj, log_evidence=res.log_evidence), PGState(
        trajectory=traj
    )


def sharded_sample_pg(
    key: jax.Array,
    kernel,
    sampler: PG,
    mesh: Mesh,
    n_iterations: int,
    axis: str = PARTICLE_AXIS,
    trajectory_storage: str = "dense",
    exchange: str = "auto",
):
    """Sharded PG(AS) chain: first unconditional sweep, then a ``lax.scan`` of
    conditional sweeps — the whole chain one compiled multi-chip program.

    ``trajectory_storage``/``exchange`` plumb straight through to
    :func:`sharded_step_pg`, so the flagship multi-chip configuration — PGAS at
    1M particles with ``"replay"`` genealogy compaction and the O(N/K·D)
    neighbour exchange — is reachable from this chain function."""
    first, st = sharded_step_pg(
        jax.random.fold_in(key, 0), kernel, sampler, mesh, None, axis,
        trajectory_storage, exchange,
    )
    if n_iterations == 1:
        return jax.tree_util.tree_map(lambda a: a[None], first)

    def body(st, i):
        smp, st = sharded_step_pg(
            jax.random.fold_in(key, i), kernel, sampler, mesh, st, axis,
            trajectory_storage, exchange,
        )
        return st, smp

    _, rest = jax.lax.scan(body, st, jnp.arange(1, n_iterations))
    return jax.tree_util.tree_map(
        lambda f, r: jnp.concatenate([f[None], r], axis=0), first, rest
    )
