"""The resampling path every backend runs: resamplers, state move, reference slot.

Each of the four schemes (the reference treats them as first-class peers,
``src/resampling.jl:31-35,53-81,98-131,149-183``) is pinned
against the native C++ sequential CDF walk fed the identical uniforms, over
weight profiles from flat to degenerate.  Mismatches are allowed only in the
float32 boundary-flip class: the position lies on a CDF step to float32
cumsum accuracy, so either neighbour is a correct answer.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedps_tpu import rng as rngmod
from advancedps_tpu.engine import _gather, sweep
from advancedps_tpu.ops import native
from advancedps_tpu.resampling import (
    ResampleWithESSThreshold,
    _decode_extents,
    resample_multinomial,
    resample_residual,
    resample_stratified,
    resample_systematic,
    stratified_extents,
)

SCHEMES = {
    "systematic": resample_systematic,
    "stratified": resample_stratified,
    "multinomial": resample_multinomial,
    "residual": resample_residual,
}


def _profile(name):
    """Normalised float32 weights ``[m]`` for one named weight profile."""
    rng = np.random.default_rng(PROFILES.index(name))
    m = 4096
    if name == "uniform":
        w = np.ones(m)
    elif name == "single_survivor":
        w = np.zeros(m)
        w[777] = 1.0
    elif name == "long_flat_run":
        # one particle owns almost everything: its offspring run spans
        # nearly the whole output
        w = np.full(m, 1e-9)
        w[3] = 1.0
    elif name == "spiky":
        w = np.full(m, 1e-12)
        w[rng.integers(m, size=5)] = 1.0
    elif name == "random":
        w = np.abs(rng.standard_normal(m))
    elif name == "skewed":
        w = rng.gamma(0.05, size=m)
    elif name == "two_ends":
        w = np.zeros(m)
        w[0] = w[-1] = 0.5
    elif name == "large_n":
        w = rng.gamma(1.0, size=1 << 17)
    return (w / w.sum()).astype(np.float32)


PROFILES = [
    "uniform", "single_survivor", "long_flat_run", "spiky", "random", "skewed",
    "two_ends", "large_n",
]


def _native_uniforms(scheme, key, n):
    """The uniforms the JAX scheme consumes, in the native oracle's layout."""
    if scheme == "systematic":
        return float(jax.random.uniform(key, dtype=jnp.float32))
    return np.asarray(rngmod.pos_uniform(key, jnp.arange(n)), np.float32)


def _boundary_flips_only(got, want, w, positions, tol=1e-4):
    """Every mismatch is a position within ``tol`` of the CDF step between
    the two answers (float32 vs float64 cumsum rounding)."""
    bad = np.nonzero(got != want)[0]
    cdf = np.cumsum(w.astype(np.float64))
    lo = np.minimum(got[bad], want[bad])
    hi = np.maximum(got[bad], want[bad])
    p = positions[bad]
    return bool(
        (np.abs(cdf[lo] - p) < tol).all() and (np.abs(cdf[hi - 1] - p) < tol).all()
    )


@pytest.mark.skipif(not native.available(), reason="g++ unavailable")
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_resampler_matches_native_oracle(scheme, profile):
    w = _profile(profile)
    n = w.shape[0]
    key = jax.random.key(len(profile) * 31 + len(scheme))
    got = np.asarray(SCHEMES[scheme](key, jnp.asarray(w), n))
    us = _native_uniforms(scheme, key, n)
    want = getattr(native, scheme)(us, w, n)
    assert got.shape == (n,) and got.dtype == np.int32
    assert got.min() >= 0 and got.max() < n
    # float32 cumsum error grows with n; at n = 2^17 it reaches ~1/4 of the
    # 1/n position spacing, so a few tenths of a percent of slots flip.
    agree = (got == want).mean()
    assert agree > 0.99, agree
    if scheme == "residual":
        # Deterministic copies use floor(n·w) in float32 here and in float64
        # in the oracle; the tail then draws with the same uniforms.
        return
    if scheme == "systematic":
        positions = (us + np.arange(n)) / n
    elif scheme == "stratified":
        positions = (us.astype(np.float64) + np.arange(n)) / n
    else:
        positions = us.astype(np.float64)
    assert _boundary_flips_only(got, want, w, positions)


# --- the extents decode ---------------------------------------------------------


@pytest.mark.parametrize(
    "f,n,want",
    [
        # counts 0,2,0,3,3,0,0,0 over n=8
        ([0, 2, 2, 5, 8, 8, 8, 8], 8, [1, 1, 3, 3, 3, 4, 4, 4]),
        # one particle owns every slot
        ([0, 0, 6, 6], 6, [2, 2, 2, 2, 2, 2]),
        # identity
        ([1, 2, 3, 4], 4, [0, 1, 2, 3]),
        # slots past f[-1] repeat the last nonempty run
        ([2, 3, 3], 5, [0, 0, 1, 1, 1]),
    ],
    ids=["runs", "single_owner", "identity", "short_extents"],
)
def test_decode_extents_runlength(f, n, want):
    got = _decode_extents(jnp.asarray(f, jnp.int32), n)
    np.testing.assert_array_equal(np.asarray(got), want)


# --- stratified: closed-form extents -----------------------------------------


def _np_weights(m, seed):
    w = np.abs(np.random.default_rng(seed).standard_normal(m)).astype(np.float32)
    return w / w.sum()


@pytest.mark.parametrize("m,n", [(2048, 2048), (1000, 4096), (5000, 3000)])
def test_stratified_extents_match_searchsorted_formulation(m, n):
    key = jax.random.key(m + n)
    w = jnp.asarray(_np_weights(m, seed=m))
    c = n * jnp.cumsum(w)
    f = np.asarray(stratified_extents(key, c, n))
    # reference: count positions (k + u_k)/n <= cdf_j directly
    us = np.asarray(rngmod.pos_uniform(key, jnp.arange(n)))
    pos = (us + np.arange(n)) / n
    cdf = np.asarray(jnp.cumsum(w))
    want = np.searchsorted(np.sort(pos), cdf, side="right")
    # f32 n*cdf rounding: ±1 flips at stratum boundaries only
    diff = np.abs(f.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    assert (np.diff(f) >= 0).all() and f.min() >= 0 and f.max() <= n


def test_resample_stratified_positional_searchsorted_agrees_with_extents():
    # The standalone searchsorted form and the extents form consume the SAME
    # positional uniforms — they must agree up to ±1 boundary flips.
    m = n = 3000
    key = jax.random.key(5)
    w = jnp.asarray(_np_weights(m, seed=9))
    got_search = np.asarray(resample_stratified(key, w, n))
    c = n * jnp.cumsum(w)
    f = stratified_extents(key, c, n)
    anc = np.searchsorted(np.asarray(f), np.arange(n), side="right")
    anc = np.clip(anc, 0, m - 1)
    assert (got_search == anc).mean() > 0.999


def test_stratified_extents_degenerate_weights():
    # single survivor: every position lands in its stratum
    m = n = 2048
    key = jax.random.key(0)
    w = jnp.zeros(m).at[777].set(1.0)
    c = n * jnp.cumsum(w)
    f = np.asarray(stratified_extents(key, c, n))
    assert f[776] == 0 and f[777] == n and f[-1] == n


# --- the state move: one gather of the whole particle state ------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int32])
@pytest.mark.parametrize("width", [1, 2, 17, 256])
def test_gather_moves_exact_copies(width, dtype):
    n = 1000
    rng = np.random.default_rng(width)
    x = rng.standard_normal((n, width)) * 1e3
    x = jnp.asarray(x.astype(np.int32) if dtype == jnp.int32 else x.astype(np.float32))
    idx = jnp.asarray(np.sort(rng.integers(0, n, size=n)).astype(np.int32))
    moved = _gather(x, idx)
    assert moved.dtype == x.dtype and moved.shape == x.shape
    np.testing.assert_array_equal(np.asarray(moved), np.asarray(x)[np.asarray(idx)])


def test_gather_moves_pytree_and_int_leaves():
    n = 257
    rng = np.random.default_rng(0)
    state = {
        "x": jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32)),
        "count": jnp.arange(n, dtype=jnp.int32),
        "flag": jnp.asarray(rng.random(n) < 0.5),
        "hist": (jnp.asarray(rng.standard_normal((n, 4, 2)).astype(np.float32)),),
    }
    idx = jnp.asarray(rng.integers(0, n, size=n).astype(np.int32))
    moved = _gather(state, idx)
    np_idx = np.asarray(idx)
    leaves = zip(jax.tree_util.tree_leaves(moved), jax.tree_util.tree_leaves(state))
    for got, orig in leaves:
        assert got.dtype == orig.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(orig)[np_idx])


# --- conditional sweeps: slot N-1 holds the reference ------------------------


@pytest.mark.parametrize("ancestor_sampling", [False, True], ids=["pg", "pgas"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_reference_slot_holds_reference_row(scheme, ancestor_sampling):
    # Slot N-1 carries the reference row at every step, and its recorded
    # ancestor is N-1 (PG) or the drawn ancestor (PGAS) — the genealogy splice
    # of the reference's src/pgas.jl:113-128.
    import advancedps_tpu as aps
    from advancedps_tpu.smc import SSMKernel

    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, 10)
    kernel = SSMKernel(ssm=aps.TracedSSM(model, ys))
    ref = jnp.linspace(-2.0, 2.0, 10)
    n = 64
    res = sweep(
        jax.random.key(5),
        kernel,
        n,
        ResampleWithESSThreshold(SCHEMES[scheme], float("inf")),
        ref=ref,
        ancestor_sampling=ancestor_sampling,
    )
    np.testing.assert_array_equal(np.asarray(res.states[:, -1]), np.asarray(ref))
    anc = np.asarray(res.ancestors)
    if not ancestor_sampling:
        assert (anc[:, -1] == n - 1).all()
    else:
        # The drawn ancestor is a real slot, and over 9 firings the draw
        # leaves slot N-1 at least once (probability 1 - O(1/N^9) otherwise).
        assert ((anc[1:, -1] >= 0) & (anc[1:, -1] < n)).all()
        assert (anc[1:, -1] != n - 1).any()
    # Non-reference slots descend from the drawn population only.
    assert (anc[1:, :-1] < n).all()


# --- engine integration (statistical) ----------------------------------------


def test_engine_sweep_with_each_scheme_matches_kalman():
    # All four schemes through the public sweep: logZ must approximate the
    # exact Kalman evidence.
    import advancedps_tpu as aps

    a, q, r = 0.9, 0.32, 1.0
    sigma0 = math.sqrt(q * q / (1 - a * a))
    model = aps.models.stationary_lgssm(a=a, q=q, r=r)
    key = jax.random.key(7)
    _, ys = aps.simulate(key, model, 25)
    traced = aps.TracedSSM(model, ys)
    kf = aps.utils.kalman_filter(np.asarray(ys), a, 0.0, q, 1.0, r, 0.0, sigma0)
    for scheme in SCHEMES.values():
        smc = aps.SMC(2000, resampler=ResampleWithESSThreshold(resampler=scheme))
        out = aps.sample(jax.random.fold_in(key, 1), traced, smc)
        assert abs(float(out.log_evidence) - float(kf.log_likelihood)) < 0.5, (
            scheme.__name__,
            float(out.log_evidence),
            float(kf.log_likelihood),
        )
