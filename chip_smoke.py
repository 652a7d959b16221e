"""Smoke test of the main path on NVIDIA GPUs, through the public entry points.

One process drives the flagship workload (stationary LGSSM a=0.9, q=0.32,
r=1.0, T=100, N=1,000,000) through SMC, every resampling scheme, PGAS, the
generic front-end, a precision check (MvNormal and the GP-SSM predictive) and
a determinism check.  Each phase is compared with the repository's own oracle
(exact Kalman evidence, the RTS smoother, analytic evidence, float64 NumPy)
and prints its compile time, its warm time (median of 5 runs, each ended by
``block_until_ready``), the device's peak memory so far and each comparison
beside its limit.

    python chip_smoke.py            # one GPU: every single-device phase
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Without a GPU it exits non-zero before printing a result.  The last line of
standard output is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
T_FLAGSHIP = 100
N_FLAGSHIP = 1_000_000
N_MULTI = 4_000_000
MULTI_DEVICES = 4


def log(msg: str) -> None:
    print(msg, flush=True)


# --- measurement helpers ------------------------------------------------------


def timed(fn, *args, reps: int = 5):
    """Compile the jitted ``fn`` for ``args``, run it once, then time ``reps``
    warm runs.  Returns ``(output, compile_s, warm_median_s, compiled)``."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, compile_s, statistics.median(times), compiled


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def report(name: str, compile_s: float, warm_s: float, checks) -> None:
    """Print one phase line; raise if any ``(label, value, limit, ok)`` failed."""
    parts = [f"{label} {value!r} (limit {limit}) {'ok' if ok else 'FAIL'}"
             for label, value, limit, ok in checks]
    log(f"[{name}] compile {compile_s:.3f} s | warm {warm_s * 1e3:.3f} ms | "
        f"peak {peak_bytes()} B | " + "; ".join(parts))
    failed = [label for label, _, _, ok in checks if not ok]
    if failed:
        raise AssertionError(f"{name}: {', '.join(failed)} out of limit")


# --- the flagship model and its oracles --------------------------------------


def flagship(T: int):
    """The stationary LGSSM with ``T`` simulated observations (seeded)."""
    import jax
    import advancedps_tpu as aps

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    return aps.TracedSSM(model, ys), np.asarray(ys)


def kalman_logz(ys) -> float:
    import advancedps_tpu as aps

    kf = aps.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    return float(kf.log_likelihood)


def rts_zrms(chain_trajs, ys, burn: int) -> float:
    """RMS z-score of the pooled post-burn-in trajectory mean against the RTS
    smoother means.  ``chain_trajs``: ``[chains, iterations, T]`` retained
    trajectories of independent chains, which are draws from the smoothing
    distribution.  The standard error comes from the chain means (iterates
    within one chain are autocorrelated), floored at the posterior sd over all
    post-burn-in iterates."""
    import advancedps_tpu as aps

    sm = aps.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    cm = np.asarray(chain_trajs)[:, burn:].mean(axis=1)  # [chains, T]
    c, kept = cm.shape[0], np.asarray(chain_trajs).shape[1] - burn
    sd = np.sqrt(np.asarray(sm.variances))
    se = np.maximum(cm.std(axis=0, ddof=1) / math.sqrt(c), sd / math.sqrt(c * kept))
    return float(np.sqrt(np.mean(((cm.mean(0) - np.asarray(sm.means)) / se) ** 2)))


# --- single-device phases -----------------------------------------------------


def phase_smc(n: int = N_FLAGSHIP, T: int = T_FLAGSHIP, tol: float = 0.1):
    """Adaptive systematic SMC (ESS 0.5) through ``aps.sample`` vs Kalman."""
    import jax
    import advancedps_tpu as aps

    traced, ys = flagship(T)
    fn = jax.jit(lambda key: aps.sample(key, traced, aps.SMC(n)).log_evidence)
    lz, c, w, _ = timed(fn, jax.random.key(1))
    err = abs(float(lz) - kalman_logz(ys))
    report(f"smc n={n}", c, w, [("|logZ - kalman|", err, tol, err < tol)])


def phase_schemes(n: int = N_FLAGSHIP, T: int = T_FLAGSHIP, tol: float = 0.15):
    """Every scheme as a bare (always-resample) resampler through ``sweep``:
    T-1 firings per sweep."""
    import jax
    from advancedps_tpu import resampling as rs
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel

    traced, ys = flagship(T)
    kernel = SSMKernel(ssm=traced)
    ref = kalman_logz(ys)
    for scheme in (rs.resample_systematic, rs.resample_stratified,
                   rs.resample_multinomial, rs.resample_residual):
        gated = rs.as_gated_resampler(scheme)
        fn = jax.jit(lambda key, g=gated: sweep(
            key, kernel, n, g, store_states=False).log_evidence)
        lz, c, w, _ = timed(fn, jax.random.key(2))
        err = abs(float(lz) - ref)
        report(f"always-resample {scheme.__name__} n={n}", c, w,
               [("|logZ - kalman|", err, tol, err < tol)])


def phase_pgas(n: int = N_FLAGSHIP, T: int = T_FLAGSHIP, iters: int = 8,
               burn: int = 4, n_chains: int = 6, z_limit: float = 3.0,
               n_pair: int = 65_536, traj_tol: float = 1e-4):
    """PGAS with replay storage vs the RTS smoother; replay vs dense storage."""
    import jax
    import jax.numpy as jnp
    import advancedps_tpu as aps

    traced, ys = flagship(T)

    def chain(n_particles, storage):
        return jax.jit(lambda key: aps.sample(
            key, traced, aps.PGAS(n_particles), iters,
            trajectory_storage=storage))

    _, c, w, run = timed(chain(n, "replay"), jax.random.key(1))
    zrms = rts_zrms([run(jax.random.fold_in(jax.random.key(9), i)).trajectory
                     for i in range(n_chains)], ys, burn)

    key = jax.random.key(3)
    rep = chain(n_pair, "replay")(key)
    den = chain(n_pair, "dense")(key)
    same_lz = bool(jnp.array_equal(rep.log_evidence, den.log_evidence))
    dtraj = float(jnp.max(jnp.abs(rep.trajectory - den.trajectory)))
    report(f"pgas n={n} iters={iters}", c, w, [
        ("RMS z vs RTS", zrms, z_limit, zrms < z_limit),
        (f"replay==dense logZ n={n_pair}", same_lz, "equal", same_lz),
        (f"max|replay-dense traj| n={n_pair}", dtraj, traj_tol, dtraj < traj_tol),
    ])


def bernoulli_program(ctx):
    """Two observations of Bernoulli(x/2) with x ≡ 1: evidence (1/2)·(1/2)."""
    from advancedps_tpu.distributions import Bernoulli

    x = ctx.sample(Bernoulli(1.0), name="x")
    ctx.observe(Bernoulli(x / 2.0), 1.0)
    ctx.observe(Bernoulli(x / 2.0), 0.0)


def phase_generic(n: int = 4096, iters: int = 4):
    """Generic front-end: SMC gives logZ = -2 log 2 exactly; a PG chain runs."""
    import jax
    import jax.numpy as jnp
    import advancedps_tpu as aps

    gm = aps.GenericModel(bernoulli_program)
    want = jnp.float32(-2.0 * math.log(2.0))
    fn = jax.jit(lambda key: aps.sample(key, gm, aps.SMC(n)).log_evidence)
    lz, c, w, _ = timed(fn, jax.random.key(4))
    chain = jax.jit(lambda key: aps.sample(key, gm, aps.PG(n), iters))(
        jax.random.key(5))
    x_final = gm.decode(np.asarray(chain.trajectory)[:, -1])["x"]
    smc_exact = bool(lz == want)
    pg_exact = bool(jnp.all(chain.log_evidence == want))
    pg_x = bool((x_final == 1.0).all())
    report(f"generic n={n}", c, w, [
        ("SMC logZ == -2 log 2", float(lz), float(want), smc_exact),
        (f"PG({n}) x{iters} logZ == -2 log 2", pg_exact, "all", pg_exact),
        ("PG retained x == 1", pg_x, "all", pg_x),
    ])


def phase_precision(d: int = 64, batch: int = 4096, rtol: float = 1e-5):
    """MvNormal log-density and positional sample at D=``d``, and the GP-SSM
    predictive over a length-``d`` history, vs float64 NumPy.

    The limit is relative to the largest magnitude compared: float32 Cholesky
    and triangular solves at D=64 stay near 1e-6; a float32 product that runs
    in TF32 (10-bit mantissa) lands near 1e-3 and fails it.
    """
    import jax
    import jax.numpy as jnp
    from advancedps_tpu import rng as rngmod
    from advancedps_tpu.distributions import MvNormal

    g = np.random.default_rng(64)
    b = g.standard_normal((d, d))
    cov = b @ b.T / d + np.eye(d)
    loc = g.standard_normal(d)
    x = loc + g.standard_normal((batch, d)) @ np.linalg.cholesky(cov).T
    dist = MvNormal(jnp.asarray(loc, jnp.float32), jnp.asarray(cov, jnp.float32))
    key = jax.random.key(6)
    gids = jnp.arange(batch)
    fn = jax.jit(lambda xs: (jax.vmap(dist.log_prob)(xs),
                             dist.sample_positional(key, gids)))
    (lp, smp), c, w, _ = timed(fn, jnp.asarray(x, jnp.float32))

    chol = np.linalg.cholesky(cov)
    z = np.linalg.solve(chol, (x - loc).T).T
    lp_ref = (-0.5 * (z * z).sum(-1) - np.log(np.diag(chol)).sum()
              - 0.5 * d * math.log(2 * math.pi))
    eps = np.asarray(rngmod.pos_normals(key, gids, d), np.float64)
    smp_ref = loc + eps @ chol.T
    def rel_err(got, ref):
        return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())

    lp_err, smp_err = rel_err(lp, lp_ref), rel_err(smp, smp_ref)
    report(f"precision MvNormal D={d}", c, w, [
        ("log_prob rel err", lp_err, rtol, lp_err < rtol),
        ("sample rel err", smp_err, rtol, smp_err < rtol),
    ])

    # GP-SSM predictive at step ``t`` of a length-``d`` history, batched over
    # particles as the sweep runs it.  Its variance k - v.v cancels; float32
    # lands near 1e-7 here, a TF32 dot product near 1e-3.
    from advancedps_tpu.models.gp_ssm import GPDynamics
    from advancedps_tpu.ssm import History

    t = (5 * d) // 8
    dyn = GPDynamics(num_steps=d)
    hist = g.standard_normal((batch, d))
    fn = jax.jit(jax.vmap(lambda h: (lambda p: (p.loc, p.scale))(
        dyn.distribution(t, None, History(states=h, length=t)))))
    (mean, sd), c, w, _ = timed(fn, jnp.asarray(hist, jnp.float32))

    ti = np.arange(t, dtype=np.float64)
    k_past = np.exp(-0.5 * (ti[:, None] - ti[None, :]) ** 2) + dyn.jitter * np.eye(t)
    k_star = np.exp(-0.5 * (ti - t) ** 2)
    w_ref = np.linalg.solve(k_past, k_star)
    mean_ref = hist[:, :t] @ w_ref
    sd_ref = np.full(batch, math.sqrt(max(1.0 - k_star @ w_ref, dyn.jitter)))
    mean_err, sd_err = rel_err(mean, mean_ref), rel_err(sd, sd_ref)
    report(f"precision GP-SSM predictive T={d} t={t}", c, w, [
        ("mean rel err", mean_err, rtol, mean_err < rtol),
        ("sd rel err", sd_err, rtol, sd_err < rtol),
    ])


def phase_determinism(n: int = N_FLAGSHIP, T: int = T_FLAGSHIP):
    """The same key twice gives bitwise-identical ancestors and logZ."""
    import jax
    import jax.numpy as jnp
    import advancedps_tpu as aps
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel

    traced, _ = flagship(T)
    kernel = SSMKernel(ssm=traced)
    fn = jax.jit(lambda key: (lambda r: (r.ancestors, r.log_evidence))(
        sweep(key, kernel, n, aps.SMC(n).resampler, store_states=False)))
    (anc1, lz1), c, w, compiled = timed(fn, jax.random.key(7))
    anc2, lz2 = compiled(jax.random.key(7))
    same_anc = bool(jnp.array_equal(anc1, anc2))
    same_lz = bool(jnp.array_equal(lz1, lz2))
    report(f"determinism n={n}", c, w, [
        ("ancestors bitwise equal", same_anc, "equal", same_anc),
        ("logZ bitwise equal", same_lz, "equal", same_lz),
    ])


SINGLE_PHASES = {
    "smc": phase_smc,
    "schemes": phase_schemes,
    "pgas": phase_pgas,
    "generic": phase_generic,
    "precision": phase_precision,
    "determinism": phase_determinism,
}


# --- four-device phases -------------------------------------------------------


def phase_sharded_sweep(n: int = N_MULTI, T: int = T_FLAGSHIP, k: int = MULTI_DEVICES,
                        lz_tol: float = 0.05, kalman_tol: float = 0.1,
                        slot_tol: int = 16, near_min: float = 0.99,
                        n_witness: int = 65_536, exact_min: float = 0.99):
    """``sharded_sweep`` over ``k`` devices vs the single-device ``sweep``
    under the same key, for both exchange strategies (always-resample
    systematic: T-1 exchanges per sweep).

    The two programs sum the weights in different orders, so a CDF entry
    differs between them by a few float32 roundings, and a position that
    falls in that gap draws the neighbouring ancestor.  The share of such
    flips at the first firing, where both programs start from identical
    particles, grows with n: at ``n_witness`` exact agreement must reach
    ``exact_min``, which a window or exchange off by even one slot would
    miss.  At the full ``n`` a CDF entry is only good to a few grid spacings
    ``1/n``: ancestors must lie within ``slot_tol`` slots of the single
    device's (a wrong shard misses by ``n/k``), and exact agreement is
    printed.  A moved ancestor changes that particle's next weight, which
    shifts every later CDF entry, and the sweeps decorrelate: the whole sweep
    is compared through its log-evidence, at the full ``n`` only.  At
    ``n_witness`` two decorrelated sweeps differ by their Monte-Carlo error
    (sd near 0.08 each at 65,536), too wide for a useful limit, so there the
    log-evidence errors are printed."""
    import jax
    import jax.numpy as jnp
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.parallel import particle_mesh, sharded_sweep
    from advancedps_tpu.resampling import as_gated_resampler, resample_systematic
    from advancedps_tpu.smc import SSMKernel

    traced, ys = flagship(T)
    kernel = SSMKernel(ssm=traced)
    gated = as_gated_resampler(resample_systematic)
    mesh = particle_mesh(k)
    key = jax.random.key(11)
    kal = kalman_logz(ys)
    failed = []
    for size in (n_witness, n):
        single = jax.jit(lambda key, m=size: sweep(
            key, kernel, m, gated, store_states=False))
        ref, c, w, _ = timed(single, key)
        err = abs(float(ref.log_evidence) - kal)
        full = size == n
        report(f"single-device sweep n={size}", c, w,
               [("|logZ - kalman|", err, kalman_tol if full else "printed",
                 err < kalman_tol or not full)])
        for exchange in ("auto", "allgather"):
            fn = jax.jit(lambda key, m=size, ex=exchange: sharded_sweep(
                key, kernel, m, gated, mesh, store_states=False, exchange=ex))
            res, c, w, _ = timed(fn, key)
            if full:
                for name in ("final_state", "log_weights", "ancestors"):
                    log(f"  {exchange}: {name} sharding {getattr(res, name).sharding}")
            dz = abs(float(res.log_evidence) - float(ref.log_evidence))
            d1 = jnp.abs(res.ancestors[1] - ref.ancestors[1])
            exact = float(jnp.mean(d1 == 0))
            near = float(jnp.mean(d1 <= slot_tol))
            if full:
                checks = [
                    ("|logZ - single|", dz, lz_tol, dz < lz_tol),
                    (f"first firing: share within {slot_tol} slots", near,
                     near_min, near >= near_min),
                    ("first firing: exact agreement", exact, "printed", True),
                ]
            else:
                checks = [
                    ("|logZ - single|", dz, "printed", True),
                    ("first firing: exact agreement", exact, exact_min,
                     exact >= exact_min),
                ]
            checks += [
                ("first firing: max slot offset", int(jnp.max(d1)), "printed", True),
                ("whole sweep: exact agreement",
                 float(jnp.mean(res.ancestors == ref.ancestors)), "printed", True),
            ]
            try:
                report(f"sharded_sweep exchange={exchange} n={size} devices={k}",
                       c, w, checks)
            except AssertionError as e:
                failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))


def phase_sharded_pgas(n: int = MULTI_DEVICES * 65_536, T: int = T_FLAGSHIP,
                       k: int = MULTI_DEVICES, iters: int = 8, burn: int = 4,
                       n_chains: int = 4, z_limit: float = 3.0,
                       n_exact: int = 8 * MULTI_DEVICES, T_exact: int = 6,
                       lz_exact: float = 1e-3, traj_exact: float = 1e-4):
    """Sharded PGAS on ``k`` devices and chains on a 2-D mesh.

    At ``n`` particles the sharded and single-device chains decorrelate for
    the reason given in :func:`phase_sharded_sweep`, so they are held to the
    RTS smoother.  Exact agreement with the single-device step and with the
    vmapped chains is checked at ``n_exact`` particles, where no boundary
    flip occurs."""
    import jax
    import jax.numpy as jnp
    import advancedps_tpu as aps
    from advancedps_tpu.inference import step_pg
    from advancedps_tpu.parallel import (
        chain_particle_mesh, particle_mesh, sample_chains, sharded_chains_pg,
        sharded_sample_pg, sharded_step_pg)
    from advancedps_tpu.smc import SSMKernel

    mesh = particle_mesh(k)
    mesh2 = chain_particle_mesh(2, k // 2)

    # Exactness at small n: one PGAS step and two chains vs the single device.
    traced, _ = flagship(T_exact)
    kernel = SSMKernel(ssm=traced)
    small = aps.PGAS(n_exact)
    st = jax.jit(lambda key: sharded_step_pg(key, kernel, small, mesh, None)[1])(
        jax.random.key(0))
    smp = jax.jit(lambda key, st: sharded_step_pg(key, kernel, small, mesh, st)[0])(
        jax.random.key(1), st)
    st1 = step_pg(jax.random.key(0), traced, small, None)[1]
    smp1 = step_pg(jax.random.key(1), traced, small, st1)[0]
    dz = abs(float(smp.log_evidence) - float(smp1.log_evidence))
    dt = float(jnp.max(jnp.abs(smp.trajectory - smp1.trajectory)))
    trajs, _ = sharded_chains_pg(jax.random.key(2), kernel, small, mesh2, 2, 3)
    ref = sample_chains(jax.random.key(2), traced, small, 3, 2)
    dc = float(jnp.max(jnp.abs(trajs - ref.trajectory)))
    report(f"sharded PGAS exactness n={n_exact} T={T_exact} devices={k}", 0.0, 0.0, [
        ("step |logZ - single|", dz, lz_exact, dz < lz_exact),
        ("step max|traj - single|", dt, traj_exact, dt < traj_exact),
        ("chains max|traj - vmap|", dc, traj_exact, dc < traj_exact),
    ])

    # Full width: sharded PGAS chains and 2-D-mesh chains vs the RTS smoother.
    traced, ys = flagship(T)
    kernel = SSMKernel(ssm=traced)
    sampler = aps.PGAS(n)
    run = jax.jit(lambda key: sharded_sample_pg(
        key, kernel, sampler, mesh, iters, trajectory_storage="replay"))
    out, c, w, run = timed(run, jax.random.key(3))
    log(f"  sharded_sample_pg: trajectory sharding {out.trajectory.sharding}")
    zrms = rts_zrms([run(jax.random.fold_in(jax.random.key(9), i)).trajectory
                     for i in range(n_chains)], ys, burn)
    report(f"sharded PGAS n={n} iters={iters} devices={k}", c, w,
           [("RMS z vs RTS", zrms, z_limit, zrms < z_limit)])

    chains = jax.jit(lambda key: sharded_chains_pg(
        key, kernel, sampler, mesh2, n_chains, iters))
    (trajs, _), c, w, _ = timed(chains, jax.random.key(4))
    log(f"  sharded_chains_pg: trajectories sharding {trajs.sharding}")
    zrms = rts_zrms(trajs, ys, burn)
    report(f"sharded_chains_pg {n_chains} chains on 2 x {k // 2} n={n}", c, w,
           [("RMS z vs RTS", zrms, z_limit, zrms < z_limit)])


MULTI_PHASES = {
    "sharded_sweep": phase_sharded_sweep,
    "sharded_pgas": phase_sharded_pgas,
}


# --- entry point --------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"run only the sharded paths on {MULTI_DEVICES} GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    need = MULTI_DEVICES if args.multi else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)", file=sys.stderr)
        return 1

    from compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log("nvidia-smi name, power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line)
    log(f"jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}")

    phases = MULTI_PHASES if args.multi else SINGLE_PHASES
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            phases[name]()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s wall)")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
