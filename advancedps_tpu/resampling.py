"""Vectorised resampling schemes.

The reference implements four ancestor-index samplers as sequential CDF walks
(``/root/reference/src/resampling.jl``: ``resample_systematic`` :149-183,
``resample_stratified`` :98-131, ``resample_multinomial`` :31-35,
``resample_residual`` :53-81, plus ``randcat`` :11-21 and the ESS-threshold wrapper
:193-204).  Those are O(N) scalar loops — exactly the shape accelerators are
worst at.

Here each scheme is a single vectorised expression over the particle axis.
The math is identical: sample ``x_i = j`` iff ``u_i ∈ [cum_{j-1}, cum_j)``.
Where the positions lie on a grid (systematic, stratified, residual's
deterministic copies) the number of positions below each CDF entry has a
closed form, the *extents*, and :func:`_decode_extents` turns them into
ancestors with one scatter and one cumulative max, with no search.  Where
the positions are iid (multinomial, the residual tail, ``randcat``) there is
no closed form and :func:`_inverse_cdf` runs a batched binary search.

All resamplers share the signature ``resampler(key, weights, n) -> int32[n]`` where
``weights`` are normalised probabilities.  They are jit/vmap/shard_map-safe (fixed
shapes, no data-dependent control flow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils.trees import pytree_dataclass, static_field

__all__ = [
    "randcat",
    "randcat_gumbel",
    "resample_systematic",
    "resample_stratified",
    "resample_multinomial",
    "resample_residual",
    "stratified_extents",
    "DEFAULT_RESAMPLER",
    "ResampleWithESSThreshold",
    "effective_sample_size",
]


def _inverse_cdf(weights: jax.Array, us: jax.Array) -> jax.Array:
    """Map ordered or unordered uniforms ``us`` through the weight CDF.

    Returns ``idx`` with ``idx_i = j`` iff ``u_i ∈ [cum_{j-1}, cum_j)`` — the same
    selection rule as the reference's sequential walks
    (``/root/reference/src/resampling.jl:149-183``), computed as a batched binary
    search instead of a scalar loop.  The search's levels are unrolled: a
    rolled loop costs one device loop iteration per level.
    """
    cdf = jnp.cumsum(weights)
    # Clamp: floating cumsum of normalised weights may end slightly below 1.
    idx = jnp.searchsorted(cdf, us, side="right", method="scan_unrolled")
    return jnp.clip(idx, 0, weights.shape[0] - 1).astype(jnp.int32)


def _decode_extents(f: jax.Array, n: int) -> jax.Array:
    """Ancestors from extents: ``anc[k] = #{j : f_j <= k}`` for ``k < n``.

    ``f`` (int32, length ``m``) is nondecreasing with values in ``[0, n]``:
    ``f_j`` counts the output positions that fall below CDF entry ``j``, so
    particle ``j`` fills output slots ``[f_{j-1}, f_j)``.  Each nonempty run
    writes its particle index at its first slot; a cumulative max fills the
    run.  Slots at or past ``f[-1]`` repeat the last nonempty run, so callers
    that need every slot drawn set ``f[-1] = n``.
    """
    m = f.shape[0]
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), f[:-1]])
    j = jnp.arange(m, dtype=jnp.int32)
    # Nonempty runs start at distinct slots; empty runs are dropped.  The
    # indices are unique, but declaring them so (``unique_indices``) gave
    # run-to-run different results on an H100; a plain scatter-max is exact
    # and deterministic there.
    tgt = jnp.where(f > starts, starts, n)
    s = jnp.zeros((n,), jnp.int32).at[tgt].max(j, mode="drop")
    return jax.lax.cummax(s)


def randcat(key: jax.Array, weights: jax.Array) -> jax.Array:
    """One categorical draw by CDF inversion (reference ``randcat``,
    ``/root/reference/src/resampling.jl:11-21``)."""
    u = jax.random.uniform(key, dtype=weights.dtype)
    return _inverse_cdf(weights, u)


def randcat_gumbel(key: jax.Array, log_weights: jax.Array, gids=None) -> jax.Array:
    """One categorical draw ∝ ``exp(log_weights)`` by the Gumbel-max trick.

    Same distribution as :func:`randcat` ∘ softmax, but with no normalisation
    and no prefix scan: one positional-uniform pass, one Gumbel transform, one
    argmax.  At N ~ 1e6 this replaces a softmax (3 passes) + ``cumsum``
    (log-depth passes) with a single fused elementwise+reduce — the fast form
    for the per-step PGAS ancestor draw.  The per-element Gumbel is a pure
    function of ``(key, gids[i])`` (see :mod:`advancedps_tpu.rng`), and argmax
    tie-breaking is first-occurrence, so the draw is bit-identical between
    single-chip and sharded layouts (the sharded form is a local argmax plus
    two scalar collectives — see ``parallel/sharded.py``).
    """
    from . import rng as rngmod

    if gids is None:
        gids = jnp.arange(log_weights.shape[0])
    u = rngmod.pos_uniform(key, gids)
    # u = 0 (prob 2^-24 per element) ⇒ gumbel = -inf ⇒ that slot is excluded
    # from this draw — a O(2^-24) total-variation perturbation, harmless.
    z = log_weights - jnp.log(-jnp.log(u))
    return jnp.argmax(z).astype(jnp.int32)


def resample_systematic(key: jax.Array, weights: jax.Array, n: int) -> jax.Array:
    """Systematic resampling: one shared uniform, positions ``(u + k) / n``.

    Reference: ``src/resampling.jl:149-183``.  The extents are
    ``f_j = ceil(n·cdf_j − u)``.  In float32, ``n·cdf`` rounds at the ~0.06 ulp
    level for n ~ 1e6, which flips ~0.2% of indices by one slot relative to
    exact arithmetic — the same class as the float32 ``cumsum`` rounding that
    every formulation shares.
    """
    return _systematic(jax.random.uniform(key, dtype=weights.dtype), weights, n)


def _systematic(u, weights, n):
    f = jnp.clip(jnp.ceil(n * jnp.cumsum(weights) - u), 0, n).astype(jnp.int32)
    return _decode_extents(f.at[-1].set(n), n)


def stratified_extents(key: jax.Array, c: jax.Array, n: int) -> jax.Array:
    """Stratified extents ``f_j = #{k : (k + u_k)/n < cdf_j}`` from the scaled
    CDF ``c = n·cdf``, with one positional-cipher evaluation per particle.

    Because ``u_k`` is a pure function of ``(key, k)``
    (:func:`advancedps_tpu.rng.pos_uniform`), the count has the closed form
    ``f_j = ⌊c_j⌋ + [u_{⌊c_j⌋} < c_j − ⌊c_j⌋]``: every stratum fully below
    ``c_j`` contributes 1, and the boundary stratum contributes its own
    uniform's indicator, evaluated at the data-dependent stratum index.
    Nondecreasing by construction (the same uniform at equal boundary strata).
    """
    from . import rng as rngmod

    c = jnp.clip(c, 0.0, float(n))
    kj = jnp.minimum(jnp.floor(c), float(n - 1))
    ku = rngmod.pos_uniform(key, kj.astype(jnp.int32))
    f = jnp.where(c >= float(n), float(n), kj + (ku < c - kj))
    return f.astype(jnp.int32)


def resample_stratified(key: jax.Array, weights: jax.Array, n: int) -> jax.Array:
    """Stratified resampling: position ``k`` draws ``(k + u_k)/n`` with its own
    uniform ``u_k``.

    Reference: ``/root/reference/src/resampling.jl:98-131``.  ``u_k`` is
    *positional* (a pure function of ``(key, k)``), so a sharded layout
    consumes the same randomness as a single device, and the extents have the
    closed form of :func:`stratified_extents`.
    """
    f = stratified_extents(key, n * jnp.cumsum(weights), n)
    return _decode_extents(f.at[-1].set(n), n)


def resample_multinomial(key: jax.Array, weights: jax.Array, n: int) -> jax.Array:
    """Multinomial resampling: n iid categorical draws.

    Reference: ``/root/reference/src/resampling.jl:31-35``.  Uniforms are
    positional (pure functions of ``(key, k)``).
    """
    from . import rng as rngmod

    us = rngmod.pos_uniform(key, jnp.arange(n)).astype(weights.dtype)
    return _inverse_cdf(weights, us)


def resample_residual(key: jax.Array, weights: jax.Array, n: int) -> jax.Array:
    """Residual resampling: ``floor(n·w_i)`` deterministic copies of particle ``i``,
    remaining slots multinomial on the residual weights.

    Reference: ``/root/reference/src/resampling.jl:53-81``.  Vectorised formulation:
    with ``c = cumsum(floor(n·w))`` the deterministic copies occupy output slots
    ``k < c[-1]`` and slot ``k`` holds ``#{j : c_j <= k}`` (the extents decode of
    ``c``); the remaining slots draw from the residual distribution.  Fixed
    shapes throughout (the data-dependent count of deterministic copies
    becomes a mask, not a shape).
    """
    scaled = n * weights
    floors = jnp.floor(scaled)
    residuals = scaled - floors
    counts_cdf = jnp.cumsum(floors)
    n_det = counts_cdf[-1]  # number of deterministic copies (traced scalar)

    # The deterministic copies' extents are the integer counts themselves.
    det_idx = _decode_extents(jnp.clip(counts_cdf, 0, n).astype(jnp.int32), n)

    res_total = jnp.sum(residuals)
    # Guard the fully-deterministic case (all residuals zero).
    safe = jnp.where(res_total > 0, res_total, 1.0)
    res_weights = residuals / safe
    res_idx = resample_multinomial(key, res_weights, n)

    slots = jnp.arange(n, dtype=weights.dtype)
    return jnp.where(slots < n_det, det_idx, res_idx)


DEFAULT_RESAMPLER = resample_systematic


def effective_sample_size(weights: jax.Array) -> jax.Array:
    """ESS = 1 / Σ wᵢ² of normalised weights
    (reference ``effectiveSampleSize``, ``/root/reference/src/container.jl:116-119``)."""
    return 1.0 / jnp.sum(jnp.square(weights))


@pytree_dataclass
class ResampleWithESSThreshold:
    """Resample with ``resampler`` iff ESS ≤ ``threshold · n``.

    Reference: ``/root/reference/src/resampling.jl:193-204`` with defaults
    (systematic, 0.5) and the gate ``ess ≤ threshold * n`` in
    ``/root/reference/src/container.jl:242-244``.  Inside ``jit`` the gate is a
    branchless select in the sweep engine — both the resampled ancestor indices and
    the identity permutation are cheap, so we compute the indices and ``where`` on
    the gate (SURVEY.md §7 hard part (c)).
    """

    resampler: object = static_field(default=DEFAULT_RESAMPLER)
    threshold: float = static_field(default=0.5)

    def __call__(self, key, weights, n):
        return self.resampler(key, weights, n)

    def should_resample(self, weights, n):
        return effective_sample_size(weights) <= self.threshold * n


def as_gated_resampler(resampler) -> ResampleWithESSThreshold:
    """Normalise a bare resampler function to an always-on gated resampler."""
    if isinstance(resampler, ResampleWithESSThreshold):
        return resampler
    # A bare function resamples every step (threshold 1.0 ⇒ ESS ≤ N always holds).
    return ResampleWithESSThreshold(resampler=resampler, threshold=float("inf"))
