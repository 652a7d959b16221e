"""Native (C++) oracle vs the vectorised JAX resamplers.

Same uniforms in, same semantics out: the sequential CDF walks in
``cpp/resampling.cpp`` and the searchsorted/scatter formulations in
``advancedps_tpu/resampling.py`` (extents decode, batched search) must agree
(up to float32 cumsum reduction-order at CDF boundaries — a tiny fraction of
indices by ±1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedps_tpu.ops import native
from advancedps_tpu.resampling import _inverse_cdf, _systematic

pytestmark = pytest.mark.skipif(
    not native.available(), reason="g++ unavailable; native oracle not built"
)


def _weights(n, seed=0):
    w = np.abs(np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    return w / w.sum()


def _agreement(a, b):
    return (np.asarray(a) == np.asarray(b)).mean()


@pytest.mark.parametrize("m,n", [(100, 100), (1000, 500), (4096, 4096)])
def test_systematic_matches_native(m, n):
    w = _weights(m)
    u = 0.37
    want = native.systematic(u, w, n)
    got = _systematic(jnp.float32(u), jnp.asarray(w), n)
    assert _agreement(got, want) > 0.999


@pytest.mark.parametrize("m", [1000, 8192])
def test_systematic_scatter_matches_native(m):
    w = _weights(m, seed=1)
    u = 0.61
    want = native.systematic(u, w, m)
    got = _systematic(jnp.float32(u), jnp.asarray(w), m)
    assert _agreement(got, want) > 0.995  # f32 n*cdf rounding: rare ±1 flips


def test_stratified_matches_native():
    m = n = 2048
    w = _weights(m, seed=2)
    us = np.random.default_rng(3).random(n).astype(np.float32)
    want = native.stratified(us, w, n)
    pos = (jnp.asarray(us) + jnp.arange(n, dtype=jnp.float32)) / n
    got = _inverse_cdf(jnp.asarray(w), pos)
    assert _agreement(got, want) > 0.999


def test_multinomial_matches_native():
    m = n = 2048
    w = _weights(m, seed=4)
    us = np.random.default_rng(5).random(n).astype(np.float32)
    want = native.multinomial(us, w, n)
    got = _inverse_cdf(jnp.asarray(w), jnp.asarray(us))
    assert _agreement(got, want) > 0.999


def test_residual_counts_match_native():
    # Residual: deterministic copies must agree exactly; compare count vectors.
    m = n = 1024
    w = _weights(m, seed=6)
    us = np.random.default_rng(7).random(n).astype(np.float32)
    want = native.residual(us, w, n)
    floor_counts = np.floor(n * w.astype(np.float64)).astype(int)
    native_counts = np.bincount(want, minlength=m)
    assert (native_counts >= floor_counts - 1).all()

    # JAX residual with its own RNG: statistical agreement of count moments.
    from advancedps_tpu.resampling import resample_residual

    got = resample_residual(jax.random.key(0), jnp.asarray(w), n)
    jax_counts = np.bincount(np.asarray(got), minlength=m)
    assert (jax_counts >= floor_counts - 1).all()


def test_native_lgssm_sweep_matches_kalman():
    # The native sequential sweep is bench.py's single-core baseline; its logZ
    # must agree with the exact Kalman marginal likelihood.
    import math

    import advancedps_tpu as aps

    a, q, r = 0.9, 0.32, 1.0
    sigma0 = math.sqrt(q * q / (1 - a * a))
    model = aps.models.stationary_lgssm(a=a, q=q, r=r)
    _, ys = aps.simulate(jax.random.key(0), model, 40)
    ys = np.asarray(ys)
    n, T = 20_000, len(ys)
    rng = np.random.default_rng(0)
    lz = native.lgssm_sweep(
        ys,
        rng.standard_normal(n).astype(np.float32),
        rng.standard_normal((T - 1) * n).astype(np.float32),
        rng.random(T).astype(np.float32),
        n,
        a,
        q,
        r,
        sigma0,
    )
    kf = aps.utils.kalman_filter(ys, a, 0.0, q, 1.0, r, 0.0, sigma0)
    assert abs(lz - float(kf.log_likelihood)) < 0.5
