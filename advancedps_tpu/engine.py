"""The particle sweep engine: one ``lax.scan`` over time, all particles dense.

This module is the array-native replacement for the reference's L4 layer — the
``ParticleContainer`` + ``sweep!`` loop (``/root/reference/src/container.jl:316-363``)
with its per-particle ``advance!`` (``/root/reference/src/pgas.jl:53-89``), fork loop
(``/root/reference/src/container.jl:190-217``) and seed-tree bookkeeping.  Where the
reference iterates ``for i in 1:n`` over ``Trace`` objects and forks them with
``deepcopy``, here the entire sweep is a single compiled scan whose body is:

    ESS gate → resample (one gather) → propagate+score (fused, vectorised) →
    log-evidence accumulate (logsumexp)

Particle identity is a *slot index*; genealogy is recorded as a dense ancestor-index
matrix instead of forked objects, and trajectories are reconstructed afterwards by a
backward pass (``lineages``) — the dense analogue of the reference's
replay-instead-of-store trick (``/root/reference/src/container.jl:220-221``), with
O(T·N·D) storage but no re-execution.

Reference-particle semantics (conditional SMC, PG/PGAS):

* the reference trajectory occupies slot ``N-1`` and always survives resampling
  (``children[n] = ref``, ``/root/reference/src/container.jl:219-224``);
* at each step its state is *read* from the retained trajectory instead of sampled
  (``/root/reference/src/pgas.jl:69-72``), implemented as a ``where`` mask inside the
  kernel step so it stays inside the fused propagate kernel;
* ancestor resampling draws the other ``N-1`` ancestors from the categorical over all
  ``N`` weights (``/root/reference/src/container.jl:181-182``).

PGAS ancestor sampling: when a resampling step occurs, the reference slot's ancestor
is drawn with probability ∝ ``exp(logW_i) · f_t(x^ref_t | x^i_{t-1})`` and recorded in
the genealogy, so the backward pass automatically splices the chosen ancestor's past
onto the retained trajectory (reference math ``/root/reference/src/pgas.jl:39-46`` and
``:113-128``).  Note: we score the *textbook* PGAS junction — the transition from each
particle's current state into the reference's next state (Lindsten, Jordan & Schön,
2014) — whereas the reference scores a one-step-lagged junction
(``transition_logweight`` uses ``X[iter-1] → ref.X[iter]`` at splice time,
``/root/reference/src/pgas.jl:26-32,117-119``).  Both splice the same prefix; the
statistical contracts (Kalman agreement, update-rate ≈ 1 − 1/N) hold for the textbook
form and are pinned by tests.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax import lax

from . import rng as rngmod
from .resampling import ResampleWithESSThreshold, randcat_gumbel
from .utils.trees import pytree_dataclass, static_field

__all__ = [
    "SweepKernel",
    "SweepResult",
    "sweep",
    "lineages",
    "reconstruct",
    "replay_trajectory",
    "propagate_rng",
]


def propagate_rng(key, t, gids):
    """The :class:`~advancedps_tpu.rng.StepRng` for the propagate stream at
    step ``t`` — EXACTLY as the sweep body constructs it.  Profilers must call
    this instead of building their own (a round-2 regression shipped because a
    micro-benchmark profiled a differently-constructed StepRng; see
    profiling/profile_sweep.py)."""
    return rngmod.StepRng(key=rngmod.step_key(key, rngmod.PROPAGATE, t), gids=gids)

class SweepKernel:
    """Protocol the sweep engine drives.  Implementations: the SSM kernel
    (:mod:`advancedps_tpu.smc`) and the generic-program kernel
    (:mod:`advancedps_tpu.generic`).

    All methods are vectorised over the particle axis (leading dim ``N``):

    * ``num_steps`` — number of observations ``T``.
    * ``init(rng, ref0, ref_mask) -> (state, logw[N])`` — sample initial latents
      (slot ``N-1`` reads ``ref0`` when a reference is present) and score ``y_0``.
      ``rng`` is a :class:`~advancedps_tpu.rng.StepRng`.
    * ``step(t, rng, state, ref_t, ref_mask) -> (state, logw[N])`` — one
      transition + observation score.  ``state`` is an arbitrary pytree with leading
      axis ``N``; resampling gathers it wholesale.
    * ``snapshot(state) -> pytree [N, ...] | None`` — the per-step value recorded for
      genealogy-based trajectory reconstruction (``None`` if the final state alone is
      the trajectory, as in the generic path).
    * ``transition_logprob(t, state, ref_t) -> [N]`` — density of moving from each
      particle's current state to ``ref_t``; required for PGAS only.
    """

    num_steps: int

    def init(self, rng, ref0, ref_mask):
        raise NotImplementedError

    def step(self, t, rng, state, ref_t, ref_mask):
        raise NotImplementedError

    def snapshot(self, state):
        return None

    def transition_logprob(self, t, state, ref_t):
        raise NotImplementedError(
            "ancestor sampling (PGAS) requires transition densities; "
            "this kernel does not provide them"
        )


@pytree_dataclass
class SweepResult:
    """Everything one sweep produces.

    ``log_evidence`` — Del Moral estimator ``Σ_t (logZ_after − logZ_before)``
    (reference ``/root/reference/src/container.jl:332-359``).
    ``log_weights`` — final unnormalised log-weights ``[N]``.
    ``states`` — stacked per-step snapshots ``[T, N, ...]`` (or ``None``).
    ``ancestors`` — ``[T, N]`` parent slots (``ancestors[0]`` is the identity).
    ``final_state`` — kernel state after the last step (pytree ``[N, ...]``).
    ``ess`` / ``resampled`` — per-step diagnostics ``[T]`` (SURVEY.md §5.5).
    """

    log_evidence: jax.Array
    log_weights: jax.Array
    states: Any
    ancestors: jax.Array
    final_state: Any
    ess: jax.Array
    resampled: jax.Array


def _gather(state, idx):
    """Resampling = one gather of the whole particle state by ancestor index.

    Ancestors lie in ``[0, N)`` by construction, so the gather clamps instead
    of masking out-of-range rows with NaN.  The mask's select sat between the
    gathered row and the propagate step's multiply-add, which kept XLA from
    contracting it into an FMA only where the gather fuses into propagate (the
    always-resample program), so that program's states differed by an ulp
    from the ESS-gated one's.
    """
    return jax.tree_util.tree_map(
        lambda a: jnp.take(a, idx, axis=0, mode="clip"), state
    )


def inject_ref(ref_mask, ref_val, vals):
    """Overwrite slot ``N-1`` with the reference value (a ``where`` mask, so the
    reference's read-instead-of-sample semantics
    (``/root/reference/src/pgas.jl:69-72``) stay inside the fused kernel).

    ``vals``: pytree with leading axis N; ``ref_val``: matching pytree for one
    particle.
    """
    if ref_mask is None or ref_val is None:
        return vals

    def one(v, r):
        m = ref_mask.reshape(ref_mask.shape + (1,) * (v.ndim - 1))
        return jnp.where(m, jnp.asarray(r)[None], v)

    return jax.tree_util.tree_map(one, vals, ref_val)


def _ref_slice(ref, t):
    if ref is None:
        return None
    return jax.tree_util.tree_map(lambda a: a[t], ref)


def sweep(
    key: jax.Array,
    kernel: SweepKernel,
    n_particles: int,
    resampler: ResampleWithESSThreshold,
    ref: Any = None,
    ancestor_sampling: bool = False,
    store_states: bool = True,
) -> SweepResult:
    """Run one particle sweep (bootstrap SMC, or conditional SMC when ``ref`` given).

    Single-chip version; the sharded variant lives in
    :mod:`advancedps_tpu.parallel.sharded`.  Everything here is jit-compatible:
    the ESS gate is a branchless ``where`` (SURVEY.md §7 hard part (c)), shapes are
    static, and the time loop is ``lax.scan``.
    """
    n = n_particles
    T = kernel.num_steps
    has_ref = ref is not None
    if ancestor_sampling and not has_ref:
        raise ValueError("ancestor_sampling requires a reference trajectory")

    ref_mask = None
    if has_ref:
        ref_mask = jnp.arange(n) == (n - 1)

    gids = jnp.arange(n)

    # --- t = 0: sample initial states, weight with y_0.  The reference's leading
    # resample_propagate! acts on weightless fresh particles (uniform weights, no
    # state), so it is a statistical no-op; we skip it (call stack SURVEY.md §3.1).
    rng0 = rngmod.StepRng(key=rngmod.step_key(key, rngmod.INIT, 0), gids=gids)
    state, logw = kernel.init(rng0, _ref_slice(ref, 0), ref_mask)

    snap0 = kernel.snapshot(state)
    do_store = store_states and snap0 is not None

    iota = jnp.arange(n, dtype=jnp.int32)
    ln_n = jnp.log(jnp.asarray(float(n)))
    n_resample = n - 1 if has_ref else n  # reference draws n-1 ancestors with a ref
    # (``/root/reference/src/container.jl:181-182``)

    # Log-evidence bookkeeping (Del Moral estimator,
    # ``/root/reference/src/container.jl:332-359``): each step contributes
    # ``logsumexp(logw_after) − logsumexp(logw_before)``.  ``logw_before`` is
    # either the previous step's ``logw_after`` (no resample) or the zero vector
    # (resample ⇒ logsumexp = log n) — so instead of two logsumexps per step we
    # carry ``pending`` = the base to subtract when the *next* logsumexp is
    # available, and compute one (max, Σe, Σe²) reduction family per step that
    # also feeds the softmax and the ESS gate.  At 1M particles this removes
    # ~3 full passes over the weights per step.
    #
    # Always-resample specialization: with ``threshold >= 1.0`` (the PGAS
    # default, reference ``/root/reference/src/smc.jl:99``) the gate is
    # statically true (ESS <= N always), so the ``lax.cond`` — whose [N]-state
    # operands and results XLA must keep copy-consistent across both branches —
    # and the carried ``pending`` base are elided at trace time (``pending`` is
    # the constant ``log n``).  The ESS diagnostic stays exact: Σe² fuses into
    # the same elementwise pass as Σe.
    always_resample = float(resampler.threshold) >= 1.0

    def body(carry, t):
        state, logw, log_z, pending = carry

        # ---- one fused reduction family over the weights.
        m = jnp.max(logw)
        e = jnp.exp(logw - m)
        s1 = jnp.sum(e)
        s2 = jnp.sum(e * e)
        lse = m + jnp.log(s1)
        log_z = log_z + (lse - pending)

        # ---- ESS gate (reference ``/root/reference/src/container.jl:233-251``).
        ess = (s1 * s1) / s2
        do_rs = jnp.asarray(True) if always_resample else (
            ess <= resampler.threshold * n
        )

        # ---- resample under lax.cond: the ancestor computation and the state
        # gather only execute on steps where the gate fires (the jit-compatible
        # form of the reference's if/else, SURVEY.md §7 hard part (c)).
        def resample_branch(operand):
            state, logw = operand
            weights = e / s1  # normalised only on resampling steps
            rs_key = rngmod.step_key(key, rngmod.RESAMPLE, t)

            anc = resampler.resampler(rs_key, weights, n_resample)
            if has_ref:
                # The reference slot N-1 keeps its own ancestor: N-1 for PG;
                # for PGAS a draw ∝ logW_i + log f_t(ref_t | state_i)
                # (the reference's math, src/pgas.jl:39-46,113-128).
                # Gumbel-max draw: no softmax, no cumsum — one elementwise
                # pass + argmax.
                ref_anc = jnp.asarray(n - 1, dtype=jnp.int32)
                if ancestor_sampling:
                    ref_t = _ref_slice(ref, t)
                    anc_logw = logw + kernel.transition_logprob(t, state, ref_t)
                    anc_key = rngmod.step_key(key, rngmod.ANCESTOR, t)
                    ref_anc = randcat_gumbel(anc_key, anc_logw, gids)
                anc = jnp.concatenate([anc, ref_anc[None]])
            return anc, _gather(state, anc), jnp.zeros_like(logw)

        def skip_branch(operand):
            state, logw = operand
            return iota, state, logw

        with jax.named_scope("aps_resample"):
            if always_resample:
                anc, state_rs, logw_pre = resample_branch((state, logw))
                pending_new = pending  # statically ln_n every step
            else:
                anc, state_rs, logw_pre = lax.cond(
                    do_rs, resample_branch, skip_branch, (state, logw)
                )
                pending_new = jnp.where(do_rs, ln_n, lse)

        # ---- propagate + score: the fused hot kernel
        # (reference hot loop /root/reference/src/container.jl:259-302 +
        # /root/reference/src/pgas.jl:53-89, now one vectorised op).
        rng_t = propagate_rng(key, t, gids)
        with jax.named_scope("aps_propagate_score"):
            state_new, score = kernel.step(
                t, rng_t, state_rs, _ref_slice(ref, t), ref_mask
            )
        logw_new = logw_pre + score

        out = (
            kernel.snapshot(state_new) if do_store else None,
            anc,
            ess,
            do_rs,
        )
        return (state_new, logw_new, log_z, pending_new), out

    (state, logw, log_z, pending), (snaps, ancs, esss, rss) = lax.scan(
        body, (state, logw, ln_n * 0.0, ln_n), jnp.arange(1, T)
    )
    # Close the pending base with the final weights' logsumexp.  (The t=0
    # normaliser ``− log n`` is the first iteration's ``pending`` init.)
    log_z = log_z + (jax.scipy.special.logsumexp(logw) - pending)

    # Prepend t=0 entries.
    if do_store:
        states = jax.tree_util.tree_map(
            lambda s0, ss: jnp.concatenate([s0[None], ss], axis=0), snap0, snaps
        )
    else:
        states = None
    ancestors = jnp.concatenate([iota[None], ancs], axis=0)
    ess0 = jnp.asarray(float(n), dtype=esss.dtype)
    ess = jnp.concatenate([ess0[None], esss])
    resampled = jnp.concatenate([jnp.zeros((1,), dtype=bool), rss])

    return SweepResult(
        log_evidence=log_z,
        log_weights=logw,
        states=states,
        ancestors=ancestors,
        final_state=state,
        ess=ess,
        resampled=resampled,
    )


def lineages(ancestors: jax.Array) -> jax.Array:
    """Full lineage matrix from the ancestor trace.

    ``lineage[t, i]`` = the slot at time ``t`` of the particle that occupies slot
    ``i`` at the final time.  Backward pass over the genealogy — the dense
    replacement for the reference's per-particle ``deepcopy`` forks.
    """
    T, n = ancestors.shape
    idx_final = jnp.arange(n, dtype=ancestors.dtype)

    def back(idx, anc_next):
        return anc_next[idx], idx

    first, rest = lax.scan(back, idx_final, ancestors[1:], reverse=True)
    return jnp.concatenate([first[None], rest], axis=0)


def replay_trajectory(key, kernel, ancestors, index, ref=None):
    """Retained trajectory WITHOUT stored states — genealogy compaction.

    The dense sweep stores per-step snapshots ``[T, N, D]``; at N ~ 1e6 with
    vector states that walls HBM (SURVEY.md §7 hard part (d); the dense
    analogue of the reference's don't-store-Nx·T concern,
    ``/root/reference/src/container.jl:220-221``).  Because ALL sweep
    randomness is positional — a pure function of ``(sweep key, stream, step,
    global particle id)`` (rng.py) — a single trajectory can be *re-sampled*
    exactly from the genealogy alone: backward-walk ``ancestors`` to the slot
    ``s_t`` the retained particle occupied at each step, then re-run the
    kernel forward with one-particle slices whose gid is ``s_t``.  This is the
    array-native form of the reference's seed-tree replay
    (``/root/reference/src/rng.jl:49-53``): O(T) work and O(T·D) memory, no
    ``[T, N, D]`` storage.

    Exactness: the replay consumes the identical positional counters, so the
    genealogy, every ancestor draw and every retained-index draw are identical
    to the dense path; the replayed *states* agree to XLA float-op-reordering
    tolerance (~1 ulp per op — the one-particle program fuses mul/add into
    FMAs differently than the N-particle program), pinned by
    tests/test_pg_pgas.py.

    ``key`` must be the same key given to :func:`sweep`; ``ancestors`` is the
    sweep's ``[T, N]`` trace; ``index`` the retained final slot; ``ref`` the
    same reference trajectory (so reference-slot reads replay correctly).
    """
    T, n = ancestors.shape
    has_ref = ref is not None

    # Backward walk: slots[t] = slot of the retained lineage at step t.
    idx = jnp.asarray(index, ancestors.dtype)

    def back(i, anc_next):
        return anc_next[i], i

    first, rest = lax.scan(back, idx, ancestors[1:], reverse=True)
    slots = jnp.concatenate([first[None], rest])  # [T]

    def mask_of(gids):
        return (gids == (n - 1)) if has_ref else None

    g0 = slots[0][None]
    rng0 = rngmod.StepRng(key=rngmod.step_key(key, rngmod.INIT, 0), gids=g0)
    state, _ = kernel.init(rng0, _ref_slice(ref, 0), mask_of(g0))
    snap0 = kernel.snapshot(state)
    if snap0 is None:
        raise ValueError("replay requires a kernel with per-step snapshots")

    def body(state, t):
        gids = slots[t][None]
        rng_t = propagate_rng(key, t, gids)
        state, _ = kernel.step(t, rng_t, state, _ref_slice(ref, t), mask_of(gids))
        return state, kernel.snapshot(state)

    _, snaps = lax.scan(body, state, jnp.arange(1, T))
    traj = jax.tree_util.tree_map(
        lambda s0, ss: jnp.concatenate([s0[None], ss], axis=0), snap0, snaps
    )
    # Drop the singleton particle axis: [T, 1, ...] → [T, ...].
    return jax.tree_util.tree_map(lambda a: a[:, 0], traj)


def reconstruct(states: Any, ancestors: jax.Array, index) -> Any:
    """Trajectory (or trajectories) through the genealogy.

    ``index`` scalar → pytree ``[T, ...]``; ``index`` absent/None → all N
    trajectories ``[T, N, ...]`` (what the reference's ``SMCSample.trajectories``
    materialises via per-particle ``X`` vectors).
    """
    T = ancestors.shape[0]
    if index is None:
        lin = lineages(ancestors)  # [T, N]
        gather = lambda s: s[jnp.arange(T)[:, None], lin]
        return jax.tree_util.tree_map(gather, states)
    # Scalar index: backward walk carrying ONE slot id — O(T) scalar
    # dynamic-slices instead of the [T, N] lineage matrix (T full-population
    # gathers), which matters at N ~ 1e6 where each gather costs milliseconds.
    idx = jnp.asarray(index, ancestors.dtype)

    def back(i, anc_next):
        return anc_next[i], i

    first, rest = lax.scan(back, idx, ancestors[1:], reverse=True)
    idx_t = jnp.concatenate([first[None], rest])  # [T]
    gather = lambda s: s[jnp.arange(T), idx_t]
    return jax.tree_util.tree_map(gather, states)
