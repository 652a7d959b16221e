"""Multi-device equivalence: the sharded sweep vs the single-chip engine.

This is oracle (5) from SURVEY.md §4 — single-host vs multi-host equivalence on a
faked 8-device CPU mesh.  The sharded path derives identical per-particle keys and
resampler uniforms, so in exact arithmetic the sweeps coincide; in float32,
compiler-chosen reduction orders can differ by 1 ulp and flip an occasional
ancestor index at a CDF boundary (see ``advancedps_tpu/parallel/sharded.py``
module docstring).  We therefore assert: near-total ancestor agreement, close
log-evidence, and bitwise determinism of each path individually.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import advancedps_tpu as aps
from advancedps_tpu.distributions import Normal
from advancedps_tpu.engine import sweep
from advancedps_tpu.utils.trees import pytree_dataclass
from advancedps_tpu.parallel import particle_mesh, sharded_sweep
from advancedps_tpu.resampling import (
    ResampleWithESSThreshold,
    resample_multinomial,
    resample_stratified,
    resample_systematic,
)
from advancedps_tpu.smc import SSMKernel

N = 64
T = 12


# Non-vectorized LGSSM components: these use the per-particle-key (vmap) path.
# Both this path and the vectorized (``sample_positional`` counter-mode) path
# derive randomness as a pure function of the *global* particle id, so the
# sharded sweep reproduces the single-chip sweep almost exactly (up to f32
# reduction-order flips at CDF boundaries).  The built-in vectorized models are
# bit-checked in ``test_vectorized_models_bit_exact`` below.
@pytree_dataclass
class _Prior(aps.StatePrior):
    sigma: jax.Array = 0.678

    def distribution(self):
        return Normal(0.0, self.sigma)


@pytree_dataclass
class _Dyn(aps.LatentDynamics):
    a: jax.Array = 0.9
    q: jax.Array = 0.32

    def distribution(self, step, state):
        return Normal(self.a * state, self.q)


@pytree_dataclass
class _Obs(aps.ObservationProcess):
    r: jax.Array = 0.5

    def distribution(self, step, state):
        return Normal(state, self.r)


def _kernel(ys):
    ssm = aps.StateSpaceModel(prior=_Prior(), dynamics=_Dyn(), observation=_Obs())
    return SSMKernel(ssm=aps.TracedSSM(ssm, ys))


@pytest.fixture(scope="module")
def setup():
    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=0.5)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    return _kernel(ys)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual CPU devices"
    return particle_mesh(8)


def _assert_equivalent(single, sharded):
    anc_s = np.asarray(single.ancestors)
    anc_m = np.asarray(sharded.ancestors)
    agreement = (anc_s == anc_m).mean()
    assert agreement > 0.99, f"ancestor agreement {agreement}"
    np.testing.assert_array_equal(
        np.asarray(single.resampled), np.asarray(sharded.resampled)
    )
    np.testing.assert_allclose(
        float(single.log_evidence), float(sharded.log_evidence), atol=0.05
    )
    np.testing.assert_allclose(
        np.asarray(single.ess), np.asarray(sharded.ess), rtol=1e-4
    )


@pytest.mark.parametrize(
    "resampler",
    [resample_systematic, resample_stratified, resample_multinomial],
)
def test_sharded_matches_single_chip(setup, mesh, resampler):
    kernel = setup
    gated = ResampleWithESSThreshold(resampler, 0.5)
    key = jax.random.key(42)
    _assert_equivalent(
        sweep(key, kernel, N, gated), sharded_sweep(key, kernel, N, gated, mesh)
    )


def test_vectorized_models_bit_exact(mesh):
    # The production fast path: built-in (vectorized=True) models sample via
    # positional counter-mode draws (rng.pos_* — element i depends only on the
    # global particle id), so the sharded sweep is bit-identical to the
    # single-chip sweep in its randomness; log-evidence matches to reduction-
    # order tolerance and ancestors agree entirely.
    import math

    a, q, r = 0.9, 0.32, 0.5
    model = aps.models.stationary_lgssm(a=a, q=q, r=r)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    kernel = SSMKernel(ssm=aps.TracedSSM(model, ys))
    gated = ResampleWithESSThreshold()
    single = sweep(jax.random.key(2), kernel, 512, gated)
    sharded = sharded_sweep(jax.random.key(2), kernel, 512, gated, mesh)
    _assert_equivalent(single, sharded)
    anc_agreement = (
        np.asarray(single.ancestors) == np.asarray(sharded.ancestors)
    ).mean()
    assert anc_agreement == 1.0
    np.testing.assert_allclose(
        np.asarray(single.states), np.asarray(sharded.states), atol=1e-5
    )
    # Both runs must also sit within MC error of the exact marginal likelihood.
    kf = aps.utils.kalman_filter(
        np.asarray(ys), a, 0.0, q, 1.0, r, 0.0, math.sqrt(q * q / (1 - a * a))
    )
    exact = float(kf.log_likelihood)
    assert abs(float(single.log_evidence) - exact) < 0.5
    assert abs(float(sharded.log_evidence) - exact) < 0.5


def test_sharded_longer_horizon(setup, mesh):
    # Long sweep: once a single ulp flips one ancestor index, the two runs diverge
    # chaotically into *different but equally valid* SMC runs — so the long-horizon
    # contract is statistical: log-evidence and final filtering moments agree
    # within Monte-Carlo tolerance.
    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, 50)
    kernel = _kernel(ys)
    gated = ResampleWithESSThreshold()
    key = jax.random.key(1)
    single = sweep(key, kernel, 512, gated)
    sharded = sharded_sweep(key, kernel, 512, gated, mesh)
    np.testing.assert_allclose(
        float(single.log_evidence), float(sharded.log_evidence), atol=0.1
    )

    def final_mean(res):
        w = np.asarray(jax.nn.softmax(res.log_weights))
        return (w * np.asarray(res.states)[-1]).sum()

    assert abs(final_mean(single) - final_mean(sharded)) < 0.05


def test_sharded_path_is_deterministic(setup, mesh):
    kernel = setup
    gated = ResampleWithESSThreshold()
    a = sharded_sweep(jax.random.key(5), kernel, N, gated, mesh)
    b = sharded_sweep(jax.random.key(5), kernel, N, gated, mesh)
    np.testing.assert_array_equal(np.asarray(a.ancestors), np.asarray(b.ancestors))
    np.testing.assert_array_equal(np.asarray(a.states), np.asarray(b.states))
    assert float(a.log_evidence) == float(b.log_evidence)


def test_sharded_conditional_sweep_with_ancestor_sampling(setup, mesh):
    kernel = setup
    gated = ResampleWithESSThreshold(threshold=1.0)
    key = jax.random.key(3)
    ref = jnp.linspace(-0.5, 0.5, T)

    single = sweep(key, kernel, N, gated, ref=ref, ancestor_sampling=True)
    sharded = sharded_sweep(
        key, kernel, N, gated, mesh, ref=ref, ancestor_sampling=True
    )
    _assert_equivalent(single, sharded)
    # Reference slot follows the retained trajectory on the last shard, exactly.
    np.testing.assert_allclose(np.asarray(sharded.states)[:, -1], np.asarray(ref))
    # Reference-slot survival: PG would pin ancestor N-1; PGAS redraws it, but it
    # must always point at a valid slot.
    anc_ref = np.asarray(sharded.ancestors)[:, -1]
    assert ((0 <= anc_ref) & (anc_ref < N)).all()


def test_sharded_store_states_false(setup, mesh):
    kernel = setup
    gated = ResampleWithESSThreshold()
    res = sharded_sweep(jax.random.key(1), kernel, N, gated, mesh, store_states=False)
    assert res.states is None
    single = sweep(jax.random.key(1), kernel, N, gated, store_states=False)
    np.testing.assert_allclose(
        float(single.log_evidence), float(res.log_evidence), atol=0.05
    )


def test_uneven_shard_rejected(setup, mesh):
    with pytest.raises(ValueError, match="divisible"):
        sharded_sweep(
            jax.random.key(0), setup, 60, ResampleWithESSThreshold(), mesh
        )


class TestChainParticleMesh:
    """2-D (chains × particles) mesh: K independent chains, each sweep sharded
    over its own particle group (SURVEY.md §2.12's free second axis)."""

    def _setup(self):
        import advancedps_tpu as aps
        from advancedps_tpu.smc import SSMKernel

        model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
        _, ys = aps.simulate(jax.random.key(0), model, 8)
        return aps, SSMKernel(ssm=aps.TracedSSM(model, ys))

    def test_matches_vmap_chains_and_deterministic(self):
        aps, kernel = self._setup()
        from advancedps_tpu.parallel import chain_particle_mesh, sharded_chains_pg

        mesh = chain_particle_mesh(2, 4)  # 2 chain rows × 4 particle shards
        sampler = aps.PGAS(16)
        key = jax.random.key(7)
        trajs, lzs = sharded_chains_pg(key, kernel, sampler, mesh, 4, 5)
        assert trajs.shape == (4, 5, 8)
        assert lzs.shape == (4, 5)
        assert bool(jnp.isfinite(lzs).all())

        # determinism
        trajs2, lzs2 = sharded_chains_pg(key, kernel, sampler, mesh, 4, 5)
        assert bool((np.asarray(trajs) == np.asarray(trajs2)).all())

        # independence: distinct chains produce distinct trajectories
        t = np.asarray(trajs)
        assert not np.allclose(t[0], t[1])
        assert not np.allclose(t[1], t[2])

        # layout-independence: the single-chip vmap driver draws the same
        # randomness (fold_in(key, chain) → fold_in(·, iter)); trajectories
        # agree to reduction-order tolerance.
        from advancedps_tpu.parallel import sample_chains

        ref = sample_chains(key, kernel.ssm, sampler, 5, 4)
        assert np.allclose(t, np.asarray(ref.trajectory), atol=1e-4), (
            np.abs(t - np.asarray(ref.trajectory)).max()
        )

    def test_chain_counts_validated(self):
        aps, kernel = self._setup()
        from advancedps_tpu.parallel import chain_particle_mesh, sharded_chains_pg

        mesh = chain_particle_mesh(2, 4)
        with pytest.raises(ValueError, match="n_chains"):
            sharded_chains_pg(jax.random.key(0), kernel, aps.PG(16), mesh, 3, 2)
        with pytest.raises(ValueError, match="n_particles"):
            sharded_chains_pg(jax.random.key(0), kernel, aps.PG(18), mesh, 2, 2)


# --- O(L·D) neighbour exchange (parallel/sharded.py exchange=...) -----------
#
# Systematic ancestors are monotone, so each chip's L output slots are owned
# by ≤ L+1 contiguous source rows; the "neighbor" exchange ships only the two
# adjacent shards' rows via ppermute and must reproduce the all_gather
# exchange bitwise whenever the replicated boundary predicate holds.


class TestNeighborExchange:
    def _sweep(self, kernel, key, mesh, **kw):
        gated = ResampleWithESSThreshold(resample_systematic, 0.5)
        return sharded_sweep(key, kernel, N, gated, mesh, **kw)

    def test_modes_bitwise_identical_when_predicate_holds(self, setup, mesh):
        kernel = setup
        key = jax.random.key(7)
        rs = [self._sweep(kernel, key, mesh, exchange=m)
              for m in ("allgather", "neighbor", "auto")]
        fired = int(np.asarray(rs[0].resampled).sum())
        assert fired > 0, "test must exercise the exchange"
        for other in rs[1:]:
            np.testing.assert_array_equal(
                np.asarray(rs[0].ancestors), np.asarray(other.ancestors)
            )
            np.testing.assert_array_equal(
                np.asarray(rs[0].states), np.asarray(other.states)
            )
            assert float(rs[0].log_evidence) == float(other.log_evidence)

    def test_matches_single_chip(self, setup, mesh):
        kernel = setup
        key = jax.random.key(11)
        gated = ResampleWithESSThreshold(resample_systematic, 0.5)
        _assert_equivalent(
            sweep(key, kernel, N, gated),
            self._sweep(kernel, key, mesh, exchange="auto"),
        )

    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_windows_equal_slices_of_full_decode(self, setup, k):
        # Each shard's window decode over its 3L-row extents equals its slice
        # of the replicated full-population decode (the all_gather path), on
        # every firing of an always-resample sweep.
        kernel = setup
        key = jax.random.key(100 + k)
        gated = ResampleWithESSThreshold(resample_systematic, float("inf"))
        mesh_k = particle_mesh(k)
        nb, ag = (
            sharded_sweep(key, kernel, 256, gated, mesh_k, exchange=m)
            for m in ("neighbor", "allgather")
        )
        assert bool(np.asarray(ag.resampled)[1:].all())
        np.testing.assert_array_equal(np.asarray(nb.ancestors), np.asarray(ag.ancestors))
        np.testing.assert_array_equal(np.asarray(nb.states), np.asarray(ag.states))

    def test_auto_falls_back_on_heavy_skew(self, mesh):
        # A severely misspecified observation noise makes every step nearly
        # degenerate (one dominant particle at a random slot), so ancestor
        # ranges leave the 3-shard window and the predicate must route to the
        # all_gather branch.  "auto" then matches it bitwise; the fallback-free
        # "neighbor" mode provably diverges — evidence the predicate really
        # fired (if it never fired, this test's premise is broken).
        model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=0.5)
        _, ys = aps.simulate(jax.random.key(0), model, T)
        skewed = aps.StateSpaceModel(
            prior=_Prior(), dynamics=_Dyn(), observation=_Obs(r=0.01)
        )
        kernel = SSMKernel(ssm=aps.TracedSSM(skewed, ys))
        key = jax.random.key(3)
        auto = self._sweep(kernel, key, mesh, exchange="auto")
        ag = self._sweep(kernel, key, mesh, exchange="allgather")
        np.testing.assert_array_equal(
            np.asarray(auto.ancestors), np.asarray(ag.ancestors)
        )
        np.testing.assert_array_equal(
            np.asarray(auto.states), np.asarray(ag.states)
        )
        nb = self._sweep(kernel, key, mesh, exchange="neighbor")
        assert not np.array_equal(
            np.asarray(nb.ancestors), np.asarray(ag.ancestors)
        ), "skew never left the neighbour window; predicate untested"

    def test_neighbor_collective_footprint(self, setup, mesh):
        # Enforce the scaling claim structurally: the fallback-free neighbor
        # program must move state via ppermute, and its only all_gathers are
        # K-scalar (shard sums) — nothing O(N)-sized crosses the mesh.  The
        # allgather program is the control: no ppermute there.
        kernel = setup
        gated = ResampleWithESSThreshold(resample_systematic, 0.5)

        def jx(mode):
            return str(
                jax.make_jaxpr(
                    lambda k: sharded_sweep(
                        k, kernel, N, gated, mesh,
                        exchange=mode, store_states=False,
                    ).ancestors
                )(jax.random.key(0))
            )

        nb, ag = jx("neighbor"), jx("allgather")
        assert "ppermute" in nb and "ppermute" not in ag
        import re

        for shapes in re.findall(r"all_gather[^\n]*?\[([0-9, x]*)\]", nb):
            dims = [int(d) for d in re.split(r"[,x ]+", shapes) if d]
            assert all(d <= 8 for d in dims), (
                f"O(N) all_gather survives in neighbor mode: [{shapes}]"
            )

    def test_pgas_step_collective_count_budget(self, setup, mesh):
        # The flagship config (always-resample PGAS, neighbor exchange): pin
        # not just payload sizes but the COUNT of collectives — on a real
        # interconnect each scalar collective is a serial latency round.  The
        # scan body appears once in the jaxpr text, so these counts are
        # per-step budgets: one fused (Σe, Σe²) psum (plus the
        # close-out psum after the scan), two pmax (weight max + ancestor-draw
        # vmax, plus close-out), one pmin (ancestor owner-select), four
        # ppermutes (extents + D=1 state, left and right), and only K-sized
        # all_gathers.  A regression that splits the fused psum or adds an
        # unconditional collective fails loudly here.
        import re

        kernel = setup
        model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
        xs, _ = aps.simulate(jax.random.key(5), model, T)
        always = ResampleWithESSThreshold(resample_systematic, 1.0)
        jx = str(
            jax.make_jaxpr(
                lambda k: sharded_sweep(
                    k, kernel, N, always, mesh, ref=xs,
                    ancestor_sampling=True, exchange="neighbor",
                    store_states=False,
                ).ancestors
            )(jax.random.key(0))
        )
        counts = {
            p: len(re.findall(p, jx))
            for p in ("ppermute", "all_gather", "psum", "pmax", "pmin")
        }
        budget = {"ppermute": 4, "all_gather": 4, "psum": 2, "pmax": 3, "pmin": 1}
        for p, b in budget.items():
            assert counts[p] <= b, f"{p}: {counts[p]} > budget {b} ({counts})"
        for shapes in re.findall(r"all_gather[^\n]*?\[([0-9, x]*)\]", jx):
            dims = [int(d) for d in re.split(r"[,x ]+", shapes) if d]
            assert all(d <= 8 for d in dims), (
                f"O(N) all_gather in PGAS neighbor step: [{shapes}]"
            )

    def test_chains_driver_rejects_neighbor_exchange(self, setup):
        # ppermute under the per-chain gate would deadlock the
        # collective-permute rendezvous (participants = all devices); the
        # chains driver must refuse it loudly rather than hang.
        from advancedps_tpu.parallel import chain_particle_mesh, sharded_chains_pg

        mesh = chain_particle_mesh(2, 4)
        with pytest.raises(ValueError, match="allgather"):
            sharded_chains_pg(
                jax.random.key(0), setup, aps.PG(16), mesh, 2, 2,
                exchange="auto",
            )

    def test_sharded_pg_replay_matches_dense(self, setup, mesh):
        # Sharded genealogy compaction: replay storage must reproduce the
        # dense one-hot-contraction trajectory (same genealogy and draws;
        # values to float-reordering tolerance).
        from advancedps_tpu.parallel import sharded_step_pg

        kernel = setup
        sampler = aps.PGAS(N)
        key = jax.random.key(21)
        st_d = st_r = None
        for i in range(3):
            k = jax.random.fold_in(key, i)
            smp_d, st_d = sharded_step_pg(k, kernel, sampler, mesh, st_d)
            smp_r, st_r = sharded_step_pg(
                k, kernel, sampler, mesh, st_r, trajectory_storage="replay"
            )
            assert float(smp_d.log_evidence) == float(smp_r.log_evidence)
            np.testing.assert_allclose(
                np.asarray(smp_d.trajectory),
                np.asarray(smp_r.trajectory),
                rtol=2e-5, atol=2e-5,
            )


def test_sharded_sample_smc_matches_single_chip():
    # API-parity driver (round 4): same SMCSample as inference.sample_smc.
    import advancedps_tpu as aps
    from advancedps_tpu.inference import sample_smc
    from advancedps_tpu.parallel import particle_mesh, sharded_sample_smc
    from advancedps_tpu.smc import SSMKernel

    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, 12)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)
    key = jax.random.key(4)
    single = sample_smc(key, traced, aps.SMC(256))
    sharded = sharded_sample_smc(key, kernel, aps.SMC(256), particle_mesh(8))
    # Cross-path contract (module docstring of parallel/sharded.py): each path
    # is bitwise deterministic; across paths an occasional f32 reduction-order
    # ulp can flip an ancestor at a CDF boundary, after which that particle's
    # trajectory follows a different (equally valid) lineage.
    tr_s = np.asarray(single.trajectories)
    tr_m = np.asarray(sharded.trajectories)
    # states agree to FMA-reordering ulps where lineages coincide
    close = np.isclose(tr_s, tr_m, atol=1e-5).mean()
    assert close > 0.95, close
    np.testing.assert_allclose(
        float(single.log_evidence), float(sharded.log_evidence), atol=0.05
    )
    np.testing.assert_array_equal(
        np.asarray(single.diagnostics["resampled"]),
        np.asarray(sharded.diagnostics["resampled"]),
    )
    # and the sharded driver is itself bitwise deterministic
    again = sharded_sample_smc(key, kernel, aps.SMC(256), particle_mesh(8))
    np.testing.assert_array_equal(tr_m, np.asarray(again.trajectories))
