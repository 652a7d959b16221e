"""Mesh helpers for particle-axis sharding.

The reference has no distributed code at all (SURVEY.md §2.12-2.13) — this module is
the invented-from-the-north-star layer.  SMC's natural parallel axis is the particle
axis N (the time axis is a Markov recursion); independent chains form a free second
axis.  We build 1-D ``(particles,)`` or 2-D ``(chains, particles)`` meshes.  The GPUs
of one host are joined all to all by NVLink and XLA hands the collectives to NCCL,
so within a host the mesh follows the algorithm alone; across hosts the particle
axis should keep each host's shards contiguous.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_distributed",
    "particle_mesh",
    "chain_particle_mesh",
    "shard_along",
]

PARTICLE_AXIS = "p"
CHAIN_AXIS = "c"


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids=None,
    cpu_collectives: Optional[str] = "gloo",
) -> None:
    """Join this process into a process-spanning jax runtime (the "N hosts"
    leg of the north star; the reference has no distributed layer at all,
    SURVEY.md §2.13).

    Thin, ordered glue around ``jax.distributed.initialize``:

    * must run BEFORE any backend use (first ``jax.devices()``/array op) —
      after that the local backend is pinned and cannot join a cluster;
    * GPU processes run their cross-process collectives on NCCL, which
      needs no setting here;
    * CPU backends need a cross-process collectives implementation
      selected first (``jax_cpu_collectives_implementation``; ``gloo``,
      the default of ``cpu_collectives``, is the portable choice) or
      ``psum``/``all_gather`` across processes fail at dispatch — this is
      what lets the multi-process layer be *tested* on CPU hosts (each
      process contributes ``--xla_force_host_platform_device_count=K``
      virtual devices);
    * ``coordinator_address`` is any one process's ``host:port``
      (``localhost:<port>`` on one machine); nothing is discovered from the
      environment, so every process passes ``num_processes`` and its own
      ``process_id``.

    After this returns, ``jax.devices()`` lists the GLOBAL device set, so
    :func:`particle_mesh`/:func:`chain_particle_mesh` build process-spanning
    meshes unchanged, and the sharded sweeps run on them unchanged — all
    cross-device traffic is XLA collectives, which ride NVLink within a host
    and the network across hosts (docs/parallel.md).
    """
    if cpu_collectives is not None:
        try:
            jax.config.update(
                "jax_cpu_collectives_implementation", cpu_collectives
            )
        except Exception:  # config absent on this jax
            pass
    kwargs = {}
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def particle_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the particle axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (PARTICLE_AXIS,), devices=devices)


def chain_particle_mesh(n_chains: int, n_particle_shards: int, devices=None) -> Mesh:
    """2-D mesh: data-parallel chains × sharded particles."""
    if devices is None:
        devices = jax.devices()
    assert n_chains * n_particle_shards <= len(devices)
    return jax.make_mesh(
        (n_chains, n_particle_shards),
        (CHAIN_AXIS, PARTICLE_AXIS),
        devices=devices[: n_chains * n_particle_shards],
    )


def shard_along(mesh: Mesh, axis: str = PARTICLE_AXIS):
    """NamedSharding putting the leading array axis on ``axis``."""
    return NamedSharding(mesh, P(axis))
