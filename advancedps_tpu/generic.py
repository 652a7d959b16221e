"""Generic-model front-end — the array-native replacement for the Libtask extension.

The reference runs *arbitrary Julia programs* as particles by executing them as
copyable coroutines: ``advance!`` is ``Libtask.consume`` which resumes a task until
the next ``AdvancedPS.observe`` → ``Libtask.produce(loglikelihood)``
(``/root/reference/ext/AdvancedPSLibtaskExt.jl:116-122,156-159``), and forking a
particle deep-copies the task tape (``:71-79,125-131``).

Coroutines cannot exist inside an XLA program, so the same *capability* — latent
``sample`` statements interleaved with ``observe`` statements in an ordinary program —
is delivered as a **trace-once / execute-many** front-end (SURVEY.md §2.9):

* The model is a Python function ``f(ctx)`` calling ``ctx.sample(dist)`` and
  ``ctx.observe(dist, value)`` in a *static* order (the probabilistic-program
  analogue of a static computation graph).
* At build time the function is traced once eagerly to discover every sample site
  (shape, dtype, segment = index of the next observe) and the number of observes T.
* During a sweep, step ``t`` executes **only segment ``t``'s slice** of the program:
  ``lax.switch(t, branches)`` dispatches to a per-segment closure in which sites of
  earlier segments read their stored values, segment-``t`` sites draw fresh samples
  (position-derived keys), later sites are dead constants, and only the ``t``-th
  observe contributes the log-weight.  Because each branch is traced with a *static*
  segment index, XLA dead-code-eliminates everything outside the dependency cone of
  step ``t`` — per-step work is O(cone of segment ``t`` over stored site values)
  rather than O(whole program), matching the reference coroutine's O(T)-total sweep
  (``/root/reference/ext/AdvancedPSLibtaskExt.jl:116-122``) for Markov-structured
  programs.  State stays a dense ``[N, S]`` value matrix — no tasks, no tape
  copies: forking is the engine's ancestor gather.
* Sample sites appearing *after the last observe* (segment == T) are drawn during
  the final step, so trajectories materialise every site's value — the analogue of
  the reference's trailing ``replay`` pass
  (``/root/reference/ext/AdvancedPSLibtaskExt.jl:240-252``).

The reference's ``replay`` pass (``ext/AdvancedPSLibtaskExt.jl:240-252``), which
re-executes a trajectory to materialise its values, is unnecessary: values are stored
densely and the final value matrix *is* the trajectory.

Data-dependent control flow (e.g. a random number of observes, rejected by the
reference at ``/root/reference/src/container.jl:291-299``) is rejected here at trace
time with the same diagnosis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .engine import SweepKernel, inject_ref
from .utils.trees import pytree_dataclass, static_field

__all__ = ["GenericModel", "GenericSSMKernel", "observe", "sample_site"]


class _TraceError(RuntimeError):
    pass


_MISALIGNED = (
    "mis-aligned execution traces: the model's sample/observe structure depends on "
    "sampled values (e.g. a random number of observations). The posterior for such "
    "models is not well-defined — make the number and order of sample/observe "
    "statements deterministic. (Reference guard: "
    "/root/reference/src/container.jl:291-299.)"
)


@dataclasses.dataclass(frozen=True)
class _Site:
    name: str
    shape: tuple
    dtype: Any
    segment: int  # index of the observe that follows this site
    offset: int  # position in the flat value vector
    size: int


class _TracerCtx:
    """Eager, single-run context used once at model build to discover structure."""

    def __init__(self, key):
        self._key = key
        self.sites = []
        self.n_observes = 0
        self._offset = 0

    def sample(self, dist, name: Optional[str] = None):
        s = len(self.sites)
        val = dist.sample(jax.random.fold_in(self._key, s))
        val = jnp.asarray(val)
        size = int(np.prod(val.shape)) if val.shape else 1
        self.sites.append(
            _Site(
                name=name or f"site_{s}",
                shape=tuple(val.shape),
                dtype=val.dtype,
                segment=self.n_observes,
                offset=self._offset,
                size=size,
            )
        )
        self._offset += size
        return val

    def observe(self, dist, value):
        self.n_observes += 1
        return dist.log_prob(value)


class _SegmentCtx:
    """Per-particle, per-**static**-segment interpretation context.

    One instance interprets the program for segment ``t`` (a Python int, fixed at
    trace time), so everything outside segment ``t``'s dependency cone traces to
    dead code and is eliminated by XLA:

    ``mode='sample'``: segment-``t`` sites draw fresh values (persisted); earlier
    segments replay stored values; later sites return dead zero constants (they
    execute after the ``t``-th observe, so they cannot feed it).  Sites *after the
    last observe* (segment == T) are drawn during the final segment ``T-1``.
    ``mode='score'``: every live site replays its stored value; only the ``t``-th
    observe's log-density is evaluated.
    ``mode='step'``: the FUSED form the sweep kernel uses (round-5, closing the
    2-pass inefficiency identified in docs/design.md): one pass both draws
    segment-``t`` sites and scores the ``t``-th observe.  The per-particle
    ``is_ref`` scalar makes the reference slot *keep* its (pre-injected) stored
    value instead of the fresh draw — a ``where``, so the whole population still
    runs one branch; the fresh draw is still traced, keeping RNG consumption
    identical to the two-pass form (bitwise-stable sweeps).
    """

    def __init__(self, model, t: int, key, values, mode, is_ref=None):
        self.model = model
        self.t = t  # static Python int — one traced branch per segment
        self.key = key
        self.values_out = values
        self.mode = mode
        self.is_ref = is_ref
        self.logw = jnp.zeros((), dtype=values.dtype)
        self._site_idx = 0
        self._obs_idx = 0

    def _read(self, site):
        flat = self.values_out[site.offset : site.offset + site.size]
        return flat.reshape(site.shape).astype(site.dtype)

    def sample(self, dist, name: Optional[str] = None):
        s = self._site_idx
        self._site_idx += 1
        if s >= len(self.model.sites):
            raise _TraceError(_MISALIGNED)
        site = self.model.sites[s]
        last = self.model.num_steps - 1
        # Trailing sites (segment == T, after the final observe) are materialised
        # in the final segment, mirroring the reference's replay
        # (/root/reference/ext/AdvancedPSLibtaskExt.jl:240-252).
        seg = min(site.segment, last)
        if seg < self.t:
            return self._read(site)
        if seg > self.t:
            # Executes after this segment's observe — can never feed it.  A dead
            # constant keeps program execution going and traces to nothing.
            return jnp.zeros(site.shape, site.dtype)
        if self.mode == "score":
            return self._read(site)
        fresh = dist.sample(jax.random.fold_in(self.key, s))
        fresh = jnp.asarray(fresh, dtype=site.dtype).reshape(site.shape)
        if self.mode == "step":
            # Reference slot replays its injected value; others take the draw.
            fresh = jnp.where(self.is_ref, self._read(site), fresh)
        self.values_out = self.values_out.at[
            site.offset : site.offset + site.size
        ].set(fresh.reshape((site.size,)).astype(self.values_out.dtype))
        return fresh

    def observe(self, dist, value):
        o = self._obs_idx
        self._obs_idx += 1
        if o >= self.model.num_steps:
            raise _TraceError(_MISALIGNED)
        if o != self.t:
            return jnp.zeros((), dtype=self.logw.dtype)
        lp = jnp.asarray(dist.log_prob(value), dtype=self.logw.dtype)
        lp = jnp.sum(lp)  # scalar score per observe (batched observes sum)
        self.logw = self.logw + lp
        return lp


# Module-level convenience mirroring ``AdvancedPS.observe`` — the context-method
# form is primary; these exist for API discoverability.
def observe(ctx, dist, value):
    return ctx.observe(dist, value)


def sample_site(ctx, dist, name=None):
    return ctx.sample(dist, name)


class GenericModel:
    """A probabilistic program with static sample/observe structure.

    Reference capability: ``AbstractGenericModel`` + ``LibtaskModel``
    (``/root/reference/src/AdvancedPS.jl:17``, ``ext/AdvancedPSLibtaskExt.jl:35-47``).

    ``fn(ctx)`` is any Python callable using ``ctx.sample(dist[, name])`` and
    ``ctx.observe(dist, value)``.  The number of observes defines the sweep length T.
    """

    def __init__(self, fn: Callable, seed: int = 0):
        self.fn = fn
        tracer = _TracerCtx(jax.random.key(seed))
        try:
            fn(tracer)
        except jax.errors.TracerBoolConversionError as e:  # pragma: no cover
            raise _TraceError(_MISALIGNED) from e
        self.sites = tuple(tracer.sites)
        self.num_steps = tracer.n_observes
        self.flat_size = sum(s.size for s in self.sites)
        if self.num_steps == 0:
            raise ValueError("generic model must contain at least one observe")

    # -- interpretation ----------------------------------------------------
    def _run_segment(self, t: int, key, values, mode: str, is_ref=None):
        ctx = _SegmentCtx(self, t, key, values, mode, is_ref)
        try:
            self.fn(ctx)
        except jax.errors.TracerBoolConversionError as e:
            raise _TraceError(_MISALIGNED) from e
        if ctx._site_idx != len(self.sites) or ctx._obs_idx != self.num_steps:
            raise _TraceError(_MISALIGNED)
        return ctx

    def run_sample(self, t, key, values):
        """One particle: draw segment-``t`` sites, return updated value vector.

        ``t`` may be traced — ``lax.switch`` dispatches to the per-segment branch,
        each traced with a static segment index so only segment ``t``'s dependency
        cone executes (the O(T)-total sweep property)."""
        branches = [
            lambda key, values, _t=_t: self._run_segment(
                _t, key, values, "sample"
            ).values_out
            for _t in range(self.num_steps)
        ]
        return jax.lax.switch(t, branches, key, values)

    def run_score(self, t, values):
        """One particle: replay stored values, return observe-``t`` log-weight."""
        branches = [
            lambda values, _t=_t: self._run_segment(_t, None, values, "score").logw
            for _t in range(self.num_steps)
        ]
        return jax.lax.switch(t, branches, values)

    def run_step(self, t, key, values, is_ref):
        """One particle, FUSED: draw segment-``t`` sites AND score observe ``t``
        in a single pass → ``(values_out, logw)``.

        This is the sweep kernel's path: one ``lax.switch`` dispatch per step
        instead of two (the [N, S] buffer streams once, and the host-side
        trace executes the program T times per sweep instead of 2T — the
        trace cost of the T-branch switch is O(T²) in program executions, so
        the constant matters at the reference-example T=200).  ``is_ref``
        (per-particle bool) makes the reference slot replay its pre-injected
        value instead of the fresh draw."""
        branches = [
            lambda key, values, is_ref, _t=_t: (
                lambda ctx: (ctx.values_out, ctx.logw)
            )(self._run_segment(_t, key, values, "step", is_ref))
            for _t in range(self.num_steps)
        ]
        return jax.lax.switch(t, branches, key, values, is_ref)

    # -- value decoding ----------------------------------------------------
    def decode(self, values: jax.Array) -> dict:
        """Flat value vector (or stacked batch ``[..., S]``) → name→array dict."""
        out = {}
        for s in self.sites:
            flat = values[..., s.offset : s.offset + s.size]
            out[s.name] = flat.reshape(values.shape[:-1] + s.shape).astype(s.dtype)
        return out


@pytree_dataclass
class GenericSSMKernel(SweepKernel):
    """Sweep-engine kernel over a :class:`GenericModel`.

    State = dense value matrix ``[N, S]``; snapshot = the value matrix itself, so a
    retained PG trajectory is the per-step ``[T, S]`` stack and its final row holds
    every site's value (no replay needed, unlike
    ``/root/reference/ext/AdvancedPSLibtaskExt.jl:240-252``).

    PGAS is unsupported — ancestor sampling needs transition densities, which only
    the structured SSM path provides (the reference's ``update_ref!`` likewise
    dispatches on ``SSMTrace`` only, ``/root/reference/src/pgas.jl:113``).
    """

    model: GenericModel = static_field()

    @property
    def num_steps(self) -> int:
        return self.model.num_steps

    def _advance(self, t, rng, values, ref_t, ref_mask):
        # Fused single-pass form (see GenericModel.run_step): inject the ref
        # row BEFORE the pass; its segment-t sites then replay the injected
        # values via the per-particle is_ref select, and the observe scores
        # the selected values — identical semantics and RNG consumption to
        # the old sample→inject→score two-pass, at half the switch traffic.
        values = inject_ref(ref_mask, ref_t, values)
        keys = rng.particle_keys()
        is_ref = (
            ref_mask
            if ref_mask is not None
            else jnp.zeros(values.shape[0], bool)
        )
        new_vals, logw = jax.vmap(
            lambda k, v, r: self.model.run_step(t, k, v, r)
        )(keys, values, is_ref)
        return new_vals, logw

    def init(self, rng, ref0, ref_mask):
        values = jnp.zeros((rng.n, self.model.flat_size), dtype=jnp.result_type(float))
        values = inject_ref(ref_mask, ref0, values)
        # t = 0 is static here: run segment 0 directly (no switch dispatch).
        keys = rng.particle_keys()
        is_ref = (
            ref_mask
            if ref_mask is not None
            else jnp.zeros(values.shape[0], bool)
        )

        def one(k, v, r):
            ctx = self.model._run_segment(0, k, v, "step", r)
            return ctx.values_out, ctx.logw

        return jax.vmap(one)(keys, values, is_ref)

    def step(self, t, rng, state, ref_t, ref_mask):
        return self._advance(t, rng, state, ref_t, ref_mask)

    def snapshot(self, state):
        return state
