"""Sweep-engine algebra: genealogy reconstruction and the container contracts.

Mirrors the reference's container suite (``/root/reference/test/container.jl``):
weights/logZ/ESS algebra with a constant-log-density fake model
(``LogPModel``, ``/root/reference/test/container.jl:4-18``), reference-particle
survival in the last slot (``:91``), and weight-reset semantics.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

import advancedps_tpu as aps
from advancedps_tpu.distributions import Normal, Uniform
from advancedps_tpu.engine import lineages, reconstruct, sweep
from advancedps_tpu.resampling import ResampleWithESSThreshold
from advancedps_tpu.smc import SSMKernel
from advancedps_tpu.utils.trees import pytree_dataclass


# --- fake model: constant observation log-density (LogPModel analogue) ----------
@pytree_dataclass
class _ConstObs(aps.ObservationProcess):
    logp: jax.Array

    def distribution(self, step, state):
        raise NotImplementedError

    def log_prob(self, step, state, y):
        return jnp.asarray(self.logp)

    def sample(self, key, step, state):
        return jnp.zeros(())


@pytree_dataclass
class _UniformPrior(aps.StatePrior):
    def distribution(self):
        return Uniform(0.0, 1.0)


@pytree_dataclass
class _UniformDyn(aps.LatentDynamics):
    def distribution(self, step, state):
        return Uniform(0.0, 1.0)


def _logp_model(logp: float, T: int) -> aps.TracedSSM:
    ssm = aps.StateSpaceModel(
        prior=_UniformPrior(),
        dynamics=_UniformDyn(),
        observation=_ConstObs(logp=logp),
    )
    return aps.TracedSSM(ssm, jnp.zeros(T))


def test_constant_logp_weights_and_logz():
    # With constant per-step score logp and no resampling triggered (weights stay
    # uniform), final logW_i = T·logp and logZ = T·logp exactly
    # (reference algebra /root/reference/test/container.jl:44-68).
    logp, T, n = -0.7, 10, 16
    model = _logp_model(logp, T)
    kernel = SSMKernel(ssm=model)
    res = sweep(
        jax.random.key(0), kernel, n, ResampleWithESSThreshold(threshold=0.5)
    )
    np.testing.assert_allclose(
        np.asarray(res.log_weights), np.full(n, T * logp), rtol=1e-5
    )
    np.testing.assert_allclose(float(res.log_evidence), T * logp, rtol=1e-5)
    # Uniform weights → ESS = n at every step, never resampled.
    np.testing.assert_allclose(np.asarray(res.ess), np.full(T, float(n)), rtol=1e-4)
    assert not bool(res.resampled.any())


def test_always_resample_resets_weights():
    logp, T, n = -0.3, 5, 8
    model = _logp_model(logp, T)
    kernel = SSMKernel(ssm=model)
    res = sweep(
        jax.random.key(0), kernel, n, ResampleWithESSThreshold(threshold=float("inf"))
    )
    # Weights reset each resampling step; final logW = last step's score only.
    np.testing.assert_allclose(
        np.asarray(res.log_weights), np.full(n, logp), rtol=1e-5
    )
    # log-evidence is unchanged by resampling (unbiasedness bookkeeping).
    np.testing.assert_allclose(float(res.log_evidence), T * logp, rtol=1e-5)
    assert bool(res.resampled[1:].all())


def test_lineages_and_reconstruct():
    # Hand-built genealogy: T=3, N=3.
    #   t=0: states [0, 1, 2], ancestors identity
    #   t=1: states [10, 11, 12], ancestors [2, 2, 0]
    #   t=2: states [20, 21, 22], ancestors [1, 0, 1]
    states = jnp.array([[0.0, 1, 2], [10, 11, 12], [20, 21, 22]])
    anc = jnp.array([[0, 1, 2], [2, 2, 0], [1, 0, 1]], dtype=jnp.int32)
    lin = lineages(anc)
    # final slot 0: at t=2 slot 0, parent at t=1 is 1, whose parent at t=0 is 2.
    np.testing.assert_array_equal(np.asarray(lin[:, 0]), [2, 1, 0])
    np.testing.assert_array_equal(np.asarray(lin[:, 1]), [2, 0, 1])
    np.testing.assert_array_equal(np.asarray(lin[:, 2]), [2, 1, 2])

    traj0 = reconstruct(states, anc, 0)
    np.testing.assert_allclose(np.asarray(traj0), [2.0, 11.0, 20.0])
    all_traj = reconstruct(states, anc, None)
    assert all_traj.shape == (3, 3)
    np.testing.assert_allclose(np.asarray(all_traj[:, 0]), [2.0, 11.0, 20.0])


def test_reference_particle_survives_and_is_injected():
    # Conditional sweep: slot N-1 must follow the provided trajectory exactly
    # (reference /root/reference/test/container.jl:91 and src/pgas.jl:69-72).
    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    xs, ys = aps.simulate(jax.random.key(0), model, 6)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)
    ref = jnp.linspace(-1.0, 1.0, 6)  # arbitrary retained trajectory
    res = sweep(
        jax.random.key(1),
        kernel,
        8,
        ResampleWithESSThreshold(threshold=float("inf")),
        ref=ref,
    )
    # The last slot's stored states equal the reference trajectory at every step.
    np.testing.assert_allclose(np.asarray(res.states[:, -1]), np.asarray(ref), rtol=1e-6)
    # And the genealogy keeps slot N-1's ancestor = N-1 (guaranteed survival).
    assert bool((res.ancestors[:, -1] == 7).all())


def test_smc_log_evidence_matches_kalman_closely():
    # 1k particles on a T=25 LGSSM: logZ within a few percent of the exact
    # marginal likelihood (gold-standard oracle, SURVEY.md §4).
    a, q, r = 0.9, 0.32, 1.0
    model = aps.models.stationary_lgssm(a=a, q=q, r=r)
    xs, ys = aps.simulate(jax.random.key(0), model, 25)
    traced = aps.TracedSSM(model, ys)
    out = aps.sample(jax.random.key(1), traced, aps.SMC(1000))
    kf = aps.utils.kalman_filter(
        ys, a, 0.0, q, 1.0, r, 0.0, math.sqrt(q * q / (1 - a * a))
    )
    assert abs(float(out.log_evidence) - float(kf.log_likelihood)) < 0.25


def test_always_resample_specialization_matches_gated_path():
    # threshold >= 1.0 statically elides the lax.cond and pending bookkeeping
    # (engine.py round-4 specialization); threshold just below 1.0 keeps the
    # gated program but fires on every step (ESS < N strictly, a.s.).  The
    # two differently-compiled programs must agree exactly.
    model = aps.models.stationary_lgssm(a=0.8, q=0.5, r=0.7)
    _, ys = aps.simulate(jax.random.key(3), model, 12)
    kernel = SSMKernel(ssm=aps.TracedSSM(model, ys))
    key = jax.random.key(7)
    spec = sweep(key, kernel, 64, ResampleWithESSThreshold(threshold=1.0))
    gated = sweep(
        key, kernel, 64, ResampleWithESSThreshold(threshold=1.0 - 1e-9)
    )
    assert bool(gated.resampled[1:].all()), "premise: gate fires every step"
    np.testing.assert_array_equal(
        np.asarray(spec.ancestors), np.asarray(gated.ancestors)
    )
    np.testing.assert_allclose(
        float(spec.log_evidence), float(gated.log_evidence), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(spec.states), np.asarray(gated.states)
    )
    np.testing.assert_array_equal(
        np.asarray(spec.resampled), np.asarray(gated.resampled)
    )
