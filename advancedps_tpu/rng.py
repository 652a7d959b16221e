"""Counter-based key discipline — the array-native replacement for the reference's
seed tree.

The reference keeps a mutable ``TracedRNG`` per particle: a Philox counter-based
generator plus a per-step ``keys`` history, so a trajectory can be *replayed* instead of
stored (``/root/reference/src/rng.jl:9-18,38-42,49-53``), and an alternative ``refseed``
stream so reference-particle children can never collide with stored keys
(``/root/reference/src/rng.jl:96-106``).

In this framework particle states are stored **densely**, so replay is unnecessary, and
all randomness is a *pure function of position*: the key used by particle ``i`` at step
``t`` of a sweep is ``fold_in(fold_in(fold_in(sweep_key, tag), t), i)``.  This gives all
three seed-tree invariants (divergence of siblings, exact reproducibility, no
ref-stream collisions — see SURVEY.md §3.5) statically, with zero carried state:

* children of one parent diverge immediately — their slots ``i`` differ;
* a sweep replays bitwise from ``sweep_key`` alone;
* streams with different ``tag`` (propagation / resampling / ancestor draws / final
  trajectory draw) never collide.

``jax.random`` keys are already Threefry/Philox counter-based generators — the same
family the reference uses (``/root/reference/src/rng.jl:2``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "PROPAGATE",
    "RESAMPLE",
    "ANCESTOR",
    "DRAW",
    "INIT",
    "step_key",
    "particle_keys",
    "StepRng",
    "threefry2x32",
    "pos_uniform_pair",
    "pos_uniform",
    "pos_normal",
    "pos_normals",
]

# Stream tags: disjoint randomness streams within one sweep.
PROPAGATE = 0  # latent transition sampling
RESAMPLE = 1  # ancestor-index draws (resampling)
ANCESTOR = 2  # PGAS reference-ancestor draw
DRAW = 3  # final retained-trajectory draw (PG/PGAS)
INIT = 4  # initial-state sampling


def step_key(key: jax.Array, tag: int, t) -> jax.Array:
    """Key for stream ``tag`` at sweep step ``t`` (t may be traced)."""
    return jax.random.fold_in(jax.random.fold_in(key, tag), t)


# ---------------------------------------------------------------------------
# Positional counter-based draws (Threefry-2x32)
# ---------------------------------------------------------------------------
#
# The fast sampling path: the j-th draw of the particle with global id
# ``g`` at a given (stream, step) is a pure function of ``(step_key, j, g)`` —
# one Threefry-2x32 block evaluation with the step key as cipher key and
# ``(j, g)`` as the counter.  This is the same counter-based construction as
# the reference's Philox generators (``/root/reference/src/rng.jl:2``), realised
# with explicit counters so that
#
# * a batched draw over a particle slice equals the per-particle draws
#   elementwise (bit-exact layout independence: sharded == single-chip), and
# * one particle's draw can be recomputed in O(1) without materialising the
#   batch (the O(T) retained-trajectory replay, the dense analogue of the
#   reference's seed-tree replay ``/root/reference/src/rng.jl:49-53``).
#
# The implementation is plain ``jnp`` uint32 arithmetic, so any kernel that
# reimplements it draws identical randomness to the engine path.

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)  # Threefry-2x32 rotation schedule
# Key-schedule parity constant (Skein/Threefry).  A plain int, NOT a
# jnp scalar: materialising a jax array at import time initialises the
# XLA backend, which breaks jax.distributed.initialize() for any
# process that imports this package first (parallel/mesh.py).
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (Salmon et al., SC'11) on uint32 arrays.

    ``(k0, k1)`` key words, ``(c0, c1)`` counter words (broadcastable arrays).
    Returns two uint32 arrays of the broadcast shape.  20 rounds matches the
    Random123 default (13 is the BigCrush minimum); ``jax.random`` uses the
    same cipher for its keys, so statistical quality matches the host RNG.
    """
    x0 = jnp.asarray(c0, jnp.uint32)
    x1 = jnp.asarray(c1, jnp.uint32)
    ks0 = jnp.asarray(k0, jnp.uint32)
    ks1 = jnp.asarray(k1, jnp.uint32)
    ks2 = ks0 ^ ks1 ^ jnp.uint32(_PARITY)

    x0 = x0 + ks0
    x1 = x1 + ks1
    ks = (ks1, ks2, ks0)
    for i in range(rounds // 4):
        for r in _ROT[:4] if i % 2 == 0 else _ROT[4:]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[i % 3]
        x1 = x1 + ks[(i + 1) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _key_words(key: jax.Array):
    """uint32 key words of a jax PRNG key (typed or raw uint32[2])."""
    data = jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key
    return data[..., 0].astype(jnp.uint32), data[..., 1].astype(jnp.uint32)


def _bits_to_unit(bits):
    """uint32 → float32 uniform in [0, 1) with 24-bit resolution (jax convention)."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def pos_uniform_pair(key: jax.Array, gids, draw: int = 0):
    """Two independent U[0,1) streams, element ``i`` a pure function of
    ``(key, draw, gids[i])``.  ``gids`` may be any uint/int array (traced ok)."""
    k0, k1 = _key_words(key)
    c1 = jnp.asarray(gids).astype(jnp.uint32)
    c0 = jnp.full_like(c1, jnp.uint32(draw))
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    return _bits_to_unit(b0), _bits_to_unit(b1)


def pos_uniform(key: jax.Array, gids, draw: int = 0):
    """One U[0,1) draw per global id — paired counter layout (ids ``2p`` and
    ``2p+1`` take the two output words of the block with counter ``p``; see
    :func:`pos_normal`)."""
    g = jnp.asarray(gids)
    u0, u1 = pos_uniform_pair(key, g >> 1, draw)
    return jnp.where((g & 1) == 0, u0, u1)


_TWO_PI = 6.283185307179586


def pos_normal_pair(key: jax.Array, gids, draw: int = 0):
    """Two independent N(0,1) draws per global id via Box–Muller on one
    Threefry block (both output words consumed — one cipher call per pair)."""
    u1, u2 = pos_uniform_pair(key, gids, draw)
    # 1 - u1 ∈ (0, 1]: log argument never 0.
    r = jnp.sqrt(-2.0 * jnp.log1p(-u1))
    theta = _TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def pos_normal(key: jax.Array, gids, draw: int = 0):
    """One N(0,1) draw per global id — **paired counter layout**.

    Ids ``2p`` and ``2p+1`` share ONE Threefry block (counter ``p``) and take
    the two Box–Muller outputs.  Box–Muller pairs are exactly independent, and
    element ``i`` remains a pure function of ``(key, draw, gids[i])``.  Do not
    mix with :func:`pos_normals` at the same ``(key, draw)`` — the pair blocks
    overlap across the two layouts.

    Note: a "half-cost" strided batch form (one cipher + Box–Muller per two
    ids, interleave + slice) was tried and REMOVED — the traced-offset
    ``dynamic_slice`` + stack/reshape interleave broke XLA fusion and ran far
    slower than this fully-fused per-id form.  The cipher is not the
    bottleneck; fusion is.
    """
    g = jnp.asarray(gids)
    z0, z1 = pos_normal_pair(key, g >> 1, draw)
    return jnp.where((g & 1) == 0, z0, z1)


def pos_normals(key: jax.Array, gids, d: int, draw0: int = 0):
    """``[n, d]`` standard normals, element ``(i, j)`` a pure function of
    ``(key, draw0 + j//2, gids[i])`` — consecutive Box–Muller pairs."""
    cols = []
    for j in range(0, d, 2):
        z0, z1 = pos_normal_pair(key, gids, draw=draw0 + j // 2)
        cols.append(z0)
        if j + 1 < d:
            cols.append(z1)
    return jnp.stack(cols, axis=-1)


def particle_keys(key: jax.Array, tag: int, t, n: int) -> jax.Array:
    """[n] keys: one per particle slot for stream ``tag`` at step ``t``.

    Pure function of (key, tag, t, slot) — the dense analogue of the reference's
    ``split``-based seed tree (``/root/reference/src/rng.jl:38-42``).
    """
    base = step_key(key, tag, t)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(n))


from .utils.trees import pytree_dataclass  # noqa: E402  (avoid cycle at top)


@pytree_dataclass
class StepRng:
    """Per-(stream, step) randomness handed to a sweep kernel.

    ``key`` is already folded with (tag, t); ``gids`` are the **global** particle
    ids covered by this kernel invocation (``arange(N)`` single-chip, the local
    shard's slice under ``shard_map``).

    Both consumption styles are **positional** — element ``i`` is a pure
    function of ``(key, gids[i])``, never of the slice layout — so sharded and
    single-chip sweeps draw bit-identical randomness, and any one particle's
    stream can be re-derived in O(1) for retained-trajectory replay:

    * :meth:`uniform` / :meth:`normal` / :meth:`normals` — direct counter-mode
      draws (one Threefry block per element; the fast path used by
      ``vectorized`` distributions via ``sample_positional``).
    * :meth:`particle_keys` — one jax PRNG key per particle (general path for
      kernels whose per-particle computation cannot be expressed in counted
      draws, e.g. Lévy jump paths or GP history solves).
    """

    key: jax.Array
    gids: jax.Array

    def particle_keys(self) -> jax.Array:
        return jax.vmap(lambda i: jax.random.fold_in(self.key, i))(self.gids)

    def uniform(self, draw: int = 0) -> jax.Array:
        return pos_uniform(self.key, self.gids, draw)

    def normal(self, draw: int = 0) -> jax.Array:
        return pos_normal(self.key, self.gids, draw)

    def normal_pair(self, draw: int = 0):
        return pos_normal_pair(self.key, self.gids, draw)

    def normals(self, d: int) -> jax.Array:
        return pos_normals(self.key, self.gids, d)

    @property
    def n(self) -> int:
        return self.gids.shape[0]
