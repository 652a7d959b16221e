"""Multi-chip particle sweep: ``shard_map`` over a particle-axis mesh.

The reference is single-process/single-threaded (SURVEY.md §2.12-2.13); this module
is the invented distributed layer specified by the north star (BASELINE.json):
particles sharded across chips, weight normalisation via collective logsumexp,
resampling via collective ancestor-index exchange over NVLink (NCCL).

Design (SURVEY.md §5.8):

* The **big data** (particle states) stays sharded ``[N/K, ...]`` per chip.  The
  ESS gate, the log-evidence increment and the softmax normaliser all derive from
  one distributed (max, Σe, Σe²) reduction family — a ``pmax`` plus two scalar
  ``psum``s per step (SURVEY.md §5.8(a-b)).  The full ``[N]`` weight vector is
  all-gathered **only on steps where the gate fires**, inside the resample branch,
  where the replicated ancestor computation reuses the very same resampler
  functions with the very same keys as the single-chip engine.
* Per-particle RNG keys are derived from **global** particle ids
  (``fold_in(step_key, global_id)``), so propagation is bitwise independent of the
  sharding layout.
* State exchange (the only heavy collective) happens **only when the ESS gate
  triggers**, under a ``lax.cond`` with a replicated predicate.  Because
  systematic ancestors are monotone, chip k's L output slots are owned by ≤ L+1
  contiguous source rows; when shard boundary extents stay within one shard of
  home (a replicated K-scalar test — the overwhelmingly common case, shard sums
  concentrate at O(√L)), two ``ppermute``s ship just the neighbour shards' rows:
  **O(L·D) per chip instead of O(N·D)**.  Heavy-skew firings fall back to the
  exact ``all_gather`` replica under the same ``lax.cond``.
* The reference particle occupies the **last slot of the last shard** and is masked
  into the propagate kernel exactly as in the single-chip engine.

Exactness contract (tested on an 8-device CPU mesh): same ``key`` ⇒ the sharded
sweep reproduces the single-chip sweep's randomness exactly *in exact arithmetic* —
identical per-particle keys, identical resampler uniforms.  In float32 the two
differently-compiled programs reduce softmax/cumsum in different orders; a
1-ulp weight difference can flip an ancestor index where a position lands on a
CDF step.  The share of flips grows with N, since the grid spacing 1/N shrinks
while the rounding gap does not.  A flipped particle's next weight shifts every
later CDF entry, so once a flip happens the two sweeps decorrelate.  The
contract is therefore: each path is individually bitwise deterministic; across
paths, first-firing ancestors agree exactly at ≥ 99% of entries up to
N = 65,536, and at larger N lie within a few slots of each other (four H100s at
N = 4M: 0.81 exact with the neighbour exchange, 0.71 with the all-gather, at
most 7 slots apart); over whole sweeps they agree only where no flip occurred;
log-evidence agrees within Monte-Carlo error.  ``chip_smoke.py --multi``
checks each of these.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .. import rng as rngmod
from ..engine import SweepResult, _ref_slice
from ..resampling import (
    ResampleWithESSThreshold,
    _decode_extents,
    resample_systematic,
)
from .mesh import PARTICLE_AXIS

__all__ = ["sharded_sweep", "sweep_shard_body"]


def _step_rng(key, tag, t, gids):
    return rngmod.StepRng(key=rngmod.step_key(key, tag, t), gids=gids)


def sweep_shard_body(
    key: jax.Array,
    kernel,
    ref: Any,
    *,
    n: int,
    L: int,
    resampler: ResampleWithESSThreshold,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    axis: str = PARTICLE_AXIS,
    exchange: str = "auto",
):
    """Per-shard sweep body — runs *inside* a ``shard_map`` whose mesh has a
    particle axis named ``axis`` (callers may add further axes, e.g. a chain
    axis).  ``L`` is the local particle count (``n // mesh.shape[axis]``).

    ``exchange`` picks the gated state-exchange strategy (systematic
    resampler only; others always use ``"allgather"``):

    * ``"auto"`` (default) — neighbour ``ppermute`` exchange, O(L·D) per chip,
      guarded by a replicated K-scalar predicate; falls back to ``all_gather``
      on the (heavy-skew) firings whose ancestor ranges leave the 3-shard
      window.  Exact either way.  REQUIRES the resample gate to be uniform
      across every device of the program — true for 1-D particle meshes, NOT
      under a per-chain gate (see ``chains.sharded_chains_pg``): ppermute
      lowers to a channel ``collective-permute`` whose rendezvous spans all
      devices, so a divergent branch deadlocks.
    * ``"allgather"`` — always replicate the state pytree.
    * ``"neighbor"`` — always take the ppermute path WITHOUT the predicate
      fallback; for tests/benches that assert on the collective footprint.
      Wrong results if a firing's ancestry leaves the neighbour window.

    Returns ``(state, logw, log_z, snaps, ancs, esss, rss)`` with per-particle
    arrays local ``[L, ...]`` and scalars replicated across the axis.
    """
    if exchange not in ("auto", "allgather", "neighbor"):
        raise ValueError(f"unknown exchange {exchange!r}")
    has_ref = ref is not None
    T = kernel.num_steps
    K = n // L
    n_resample = n - 1 if has_ref else n  # reference draws n-1 ancestors
    # (``/root/reference/src/container.jl:181-182``)

    def body(key, kernel, ref):
        k_idx = lax.axis_index(axis)
        gids = k_idx * L + jnp.arange(L)

        ref_mask = (gids == (n - 1)) if has_ref else None

        def gather_all(x):
            return jax.tree_util.tree_map(
                lambda a: lax.all_gather(a, axis, tiled=True), x
            )

        # ---- t = 0
        rng0 = _step_rng(key, rngmod.INIT, 0, gids)
        state, logw = kernel.init(rng0, _ref_slice(ref, 0), ref_mask)
        ln_n = jnp.log(jnp.asarray(float(n)))

        # Log-evidence bookkeeping mirrors the single-chip engine's carried
        # ``pending`` base (engine.py): one distributed (max, Σe, Σe²)
        # reduction family per step — three scalar collectives — feeds the
        # ESS gate, the normalised weights and the Del Moral increment.  The
        # full [N] weight vector crosses the interconnect only on steps where the gate
        # fires (inside ``resample_branch``), not every step.

        # Always-resample specialization (mirrors engine.py): with
        # ``threshold >= 1.0`` the replicated gate is statically true, so the
        # outer ``lax.cond`` (whose [L]-state operands XLA must keep
        # copy-consistent across branches) and the carried ``pending`` base
        # are elided at trace time.
        always_resample = float(resampler.threshold) >= 1.0

        def step(carry, t):
            state, logw, log_z, pending = carry

            m = lax.pmax(jnp.max(logw), axis)  # exact: max is order-free
            e = jnp.exp(logw - m)
            # ONE length-2 psum for (Σe, Σe²) — on a real interconnect each
            # scalar psum is a serial latency round; fusing halves the
            # per-step scalar collective count.
            s12 = lax.psum(jnp.stack([jnp.sum(e), jnp.sum(e * e)]), axis)
            s1, s2 = s12[0], s12[1]
            lse = m + jnp.log(s1)
            log_z = log_z + (lse - pending)
            ess = (s1 * s1) / s2
            do_rs = jnp.asarray(True) if always_resample else (
                ess <= resampler.threshold * n  # replicated predicate
            )

            def draw_ref_anc(state, logw):
                ref_anc = jnp.asarray(n - 1, dtype=jnp.int32)
                if ancestor_sampling:
                    # PGAS ancestor draw, Gumbel-max form (SURVEY.md §5.8(d)):
                    # per-element Gumbels are positional in the global id, so a
                    # local argmax + two scalar collectives replaces the O(N)
                    # weight all_gather + CDF inversion, and the drawn index is
                    # bit-identical to the single-chip engine's (argmax ties
                    # break to the smallest global id on both paths).
                    ref_t = _ref_slice(ref, t)
                    alw = logw + kernel.transition_logprob(t, state, ref_t)
                    anc_key = rngmod.step_key(key, rngmod.ANCESTOR, t)
                    u = rngmod.pos_uniform(anc_key, gids)
                    z = alw - jnp.log(-jnp.log(u))
                    li = jnp.argmax(z)
                    lmax = z[li]
                    vmax = lax.pmax(lmax, axis)
                    cand = jnp.where(
                        lmax == vmax, gids[li].astype(jnp.int32), jnp.int32(n)
                    )
                    ref_anc = lax.pmin(cand, axis).astype(jnp.int32)
                return ref_anc

            def apply_ref(local_anc, moved, ref_anc, row_of):
                """Overwrite the reference slot (global n-1, on the last
                shard) with the retained ancestor draw; ``row_of(ref_anc)``
                fetches that global row's state exactly."""
                is_ref = gids == (n - 1)
                local_anc = jnp.where(is_ref, ref_anc, local_anc)
                ref_row = row_of(ref_anc)
                moved = jax.tree_util.tree_map(
                    lambda mv, r: jnp.where(
                        is_ref.reshape((L,) + (1,) * (mv.ndim - 1)),
                        r[None],
                        mv,
                    ),
                    moved,
                    ref_row,
                )
                return local_anc, moved

            def exchange_allgather(operand, rs_key):
                """Replicate the state pytree (O(N·D) per chip), decode and
                move each chip's window from the replica."""
                state, logw = operand
                # The one O(N) weight collective, gated on the ESS test.
                weights_all = lax.all_gather(e, axis, tiled=True) / s1

                state_all = gather_all(state)
                # Replicated ancestor computation — same resampler, same key
                # as the single-chip engine ⇒ ancestors agree up to f32
                # reduction-order flips at CDF boundaries (module docstring).
                anc_drawn = resampler.resampler(rs_key, weights_all, n_resample)
                if has_ref:
                    ref_anc = draw_ref_anc(state, logw)
                    anc = jnp.concatenate([anc_drawn, ref_anc[None]])
                else:
                    anc = anc_drawn
                local_anc = anc[gids]  # [L]
                moved = jax.tree_util.tree_map(
                    lambda a: jnp.take(a, local_anc, axis=0), state_all
                )
                return local_anc, moved, jnp.zeros_like(logw)

            def exchange_neighbor(operand, rs_key, u, prefix, fb):
                """O(L·D)-per-chip exchange (replaces the fork
                loop ``/root/reference/src/container.jl:190-217``): because
                systematic ancestors are MONOTONE, chip k's L output slots are
                owned by ≤ L+1 CONTIGUOUS source rows, and when no shard's
                boundary extent strays more than one shard (the replicated
                predicate below — overwhelmingly the case, since shard weight
                sums concentrate at O(√L)), those rows lie within shards
                {k-1, k, k+1}.  Two ``ppermute``s ship the neighbour rows,
                then the windowed decode runs against a 3L-row extents slice.
                """
                state, logw = operand
                nr = n_resample
                # Per-shard global extents: stitch the local cumsum into the
                # replicated prefix EXACTLY at boundaries (clip + set + cummax
                # absorb the ulp disagreements between the shard-sum psum and
                # the local cumsum), so f_ext is globally nondecreasing and
                # each shard's last extent is bitwise fb[k].
                cdf = jnp.cumsum(e) / s1 + jnp.where(
                    k_idx > 0, prefix[k_idx - 1], 0.0
                )
                f_loc = jnp.clip(jnp.ceil(nr * cdf - u), 0, nr).astype(jnp.int32)
                lo = jnp.where(k_idx > 0, fb[k_idx - 1], 0)
                f_loc = jnp.clip(f_loc, lo, fb[k_idx])
                f_loc = f_loc.at[L - 1].set(fb[k_idx])
                f_loc = lax.cummax(f_loc, axis=0)

                recv_from_left = [(i, (i + 1) % K) for i in range(K)]
                recv_from_right = [(i, (i - 1) % K) for i in range(K)]

                def from_left(x):
                    return lax.ppermute(x, axis, recv_from_left)

                def from_right(x):
                    return lax.ppermute(x, axis, recv_from_right)

                # Ring wrap masking: chip 0's left block owns nothing
                # (extent 0 = consumed), chip K-1's right block owns nothing
                # (extent nr = beyond every drawn slot).  Values need no mask
                # — rows with empty ownership never contribute.
                f_left = jnp.where(k_idx == 0, 0, from_left(f_loc))
                f_right = jnp.where(k_idx == K - 1, nr, from_right(f_loc))
                f_ext = jnp.concatenate([f_left, f_loc, f_right])
                state_ext = jax.tree_util.tree_map(
                    lambda a: jnp.concatenate(
                        [from_left(a), a, from_right(a)], axis=0
                    ),
                    state,
                )

                # Window decode: this shard's slots [kL, (k+1)L) against the
                # 3L-row extents (rows (k-1)L ...), by the same extents decode
                # as the single-device resamplers.
                anc_win = _decode_extents(jnp.clip(f_ext - k_idx * L, 0, L), L)
                moved = jax.tree_util.tree_map(
                    lambda a: jnp.take(a, anc_win, axis=0), state_ext
                )
                local_anc = jnp.clip((k_idx - 1) * L + anc_win, 0, n - 1)

                if has_ref:
                    ref_anc = draw_ref_anc(state, logw)

                    def row_of(a):
                        # Bitwise-exact O(K·D) broadcast of one global row:
                        # every chip offers its clipped candidate, the owner
                        # chip's row is selected from the K-row gather.
                        loc = jnp.clip(a - k_idx * L, 0, L - 1)
                        return jax.tree_util.tree_map(
                            lambda s: lax.all_gather(s[loc], axis)[a // L],
                            state,
                        )

                    local_anc, moved = apply_ref(local_anc, moved, ref_anc, row_of)
                return local_anc, moved, jnp.zeros_like(logw)

            def resample_branch(operand):
                rs_key = rngmod.step_key(key, rngmod.RESAMPLE, t)
                u = jax.random.uniform(rs_key, dtype=e.dtype)
                neighbor_possible = (
                    exchange in ("auto", "neighbor")
                    and resampler.resampler is resample_systematic
                    and K >= 2
                )
                if not neighbor_possible:
                    return exchange_allgather(operand, rs_key)

                nr = n_resample
                # K-scalar collective: shard weight sums -> replicated global
                # CDF prefix -> each shard's boundary extent fb[k] (the extent
                # of its LAST row, enforced bitwise in exchange_neighbor).
                sums = lax.all_gather(jnp.sum(e), axis)  # [K]
                prefix = jnp.cumsum(sums) / s1
                fb = jnp.clip(
                    jnp.ceil(nr * prefix - u), 0, nr
                ).astype(jnp.int32)
                fb = fb.at[K - 1].set(nr)

                if exchange == "neighbor":
                    return exchange_neighbor(operand, rs_key, u, prefix, fb)

                # Replicated predicate: every chip k's owners lie in shards
                # {k-1, k, k+1}.  Right: the owner of k's last slot sits
                # before row (k+2)L ⟸ fb[k+1] ≥ (k+1)L.  Left: rows before
                # (k-1)L are consumed by slot kL ⟸ fb[k-2] ≤ kL.
                sl = (jnp.arange(K, dtype=jnp.int32) + 1) * L
                ok_right = jnp.all(fb[1:] >= sl[: K - 1])
                ok_left = (
                    jnp.all(fb[: K - 2] <= sl[1 : K - 1])
                    if K > 2
                    else jnp.asarray(True)
                )
                return lax.cond(
                    ok_right & ok_left,
                    lambda op: exchange_neighbor(op, rs_key, u, prefix, fb),
                    lambda op: exchange_allgather(op, rs_key),
                    operand,
                )

            def skip_branch(operand):
                state, logw = operand
                return gids.astype(jnp.int32), state, logw

            if always_resample:
                local_anc, state_rs, logw_pre = resample_branch((state, logw))
                pending_new = pending  # statically ln_n every step
            else:
                local_anc, state_rs, logw_pre = lax.cond(
                    do_rs, resample_branch, skip_branch, (state, logw)
                )
                pending_new = jnp.where(do_rs, ln_n, lse)

            rng_t = _step_rng(key, rngmod.PROPAGATE, t, gids)
            state_new, score = kernel.step(
                t, rng_t, state_rs, _ref_slice(ref, t), ref_mask
            )
            logw_new = logw_pre + score

            out = (
                kernel.snapshot(state_new) if store_states else None,
                local_anc,
                ess,
                do_rs,
            )
            return (state_new, logw_new, log_z, pending_new), out

        (state, logw, log_z, pending), (snaps, ancs, esss, rss) = lax.scan(
            step, (state, logw, ln_n * 0.0, ln_n), jnp.arange(1, T)
        )
        # Close the pending base with the final weights' distributed logsumexp.
        mf = lax.pmax(jnp.max(logw), axis)
        sf = lax.psum(jnp.sum(jnp.exp(logw - mf)), axis)
        log_z = log_z + (mf + jnp.log(sf) - pending)
        return state, logw, log_z, snaps, ancs, esss, rss

    return body(key, kernel, ref)


def sharded_sweep(
    key: jax.Array,
    kernel,
    n_particles: int,
    resampler: ResampleWithESSThreshold,
    mesh: Mesh,
    ref: Any = None,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    axis: str = PARTICLE_AXIS,
    exchange: str = "auto",
) -> SweepResult:
    """Sharded counterpart of :func:`advancedps_tpu.engine.sweep`.

    ``n_particles`` must divide evenly by the mesh's ``axis`` size.  Returns a
    :class:`SweepResult` whose per-particle arrays are global (sharded) arrays.
    ``exchange`` selects the gated state-exchange strategy — see
    :func:`sweep_shard_body`.
    """
    n = n_particles
    K = mesh.shape[axis]
    if n % K:
        raise ValueError(f"n_particles={n} not divisible by mesh axis {axis}={K}")
    L = n // K
    if ancestor_sampling and ref is None:
        raise ValueError("ancestor_sampling requires a reference trajectory")

    def body(key, kernel, ref):
        return sweep_shard_body(
            key,
            kernel,
            ref,
            n=n,
            L=L,
            resampler=resampler,
            ancestor_sampling=ancestor_sampling,
            store_states=store_states,
            axis=axis,
            exchange=exchange,
        )

    p = P(axis)
    rep = P()
    kernel_specs = jax.tree_util.tree_map(lambda _: rep, kernel)
    ref_specs = jax.tree_util.tree_map(lambda _: rep, ref)

    shmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, kernel_specs, ref_specs),
        out_specs=(
            p,  # state pytree: sharded on the particle axis
            p,  # logw
            rep,  # log_z (replicated computation)
            P(None, axis) if store_states else None,  # snaps [T-1, N, ...]
            P(None, axis),  # ancestors [T-1, N]
            rep,  # ess
            rep,  # resampled flags
        ),
        check_vma=False,
    )

    state, logw, log_z, snaps, ancs, esss, rss = shmapped(key, kernel, ref)

    # Reconstruct the t=0 pieces (identical keys ⇒ identical values).
    iota = jnp.arange(n, dtype=jnp.int32)
    ancestors = jnp.concatenate([iota[None], ancs], axis=0)
    ess0 = jnp.asarray(float(n), dtype=esss.dtype)
    ess = jnp.concatenate([ess0[None], esss])
    resampled = jnp.concatenate([jnp.zeros((1,), dtype=bool), rss])

    states = None
    if store_states:
        snap0 = _initial_snapshot(key, kernel, n, mesh, ref, axis)
        states = jax.tree_util.tree_map(
            lambda s0, ss: jnp.concatenate([s0[None], ss], axis=0), snap0, snaps
        )

    return SweepResult(
        log_evidence=log_z,
        log_weights=logw,
        states=states,
        ancestors=ancestors,
        final_state=state,
        ess=ess,
        resampled=resampled,
    )


def _initial_snapshot(key, kernel, n, mesh, ref, axis):
    """Recompute the t=0 snapshot (deterministic in ``key``)."""
    L = n // mesh.shape[axis]
    has_ref = ref is not None

    def init_body(key, kernel, ref):
        k_idx = lax.axis_index(axis)
        gids = k_idx * L + jnp.arange(L)
        ref_mask = (gids == (n - 1)) if has_ref else None
        rng0 = _step_rng(key, rngmod.INIT, 0, gids)
        state, _ = kernel.init(rng0, _ref_slice(ref, 0), ref_mask)
        return kernel.snapshot(state)

    rep = P()
    return jax.shard_map(
        init_body,
        mesh=mesh,
        in_specs=(rep, jax.tree_util.tree_map(lambda _: rep, kernel),
                  jax.tree_util.tree_map(lambda _: rep, ref)),
        out_specs=P(axis),
        check_vma=False,
    )(key, kernel, ref)
