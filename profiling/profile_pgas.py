"""PGAS-iteration phase profile at headline size (N=1M, T=100) on one GPU.

Decomposes one always-resample conditional sweep + retained-trajectory
machinery into:

    propagate+score (ref-masked) / weight reductions / resample (systematic
    decode + state gather) / ancestor draw (transition logpdf + Gumbel-max) /
    ref-row splice / replay + retained draw

and checks the parts explain the measured iteration (same faithfulness rule as
profile_sweep.py).  All StepRng construction goes through the engine's own
helpers.  Amortised-timing method as profile_sweep.py (one scalar fetch per
measurement).

Run from the repository root:  python profiling/profile_pgas.py
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 1_000_000
T = 100
A, Q, R_OBS = 0.9, 0.32, 1.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    reps = args.reps

    import jax
    import jax.numpy as jnp

    import advancedps_tpu as aps
    from advancedps_tpu import rng as rngmod
    from advancedps_tpu.engine import _gather, propagate_rng, sweep
    from advancedps_tpu.inference import step_pg
    from advancedps_tpu.pg import PGState
    from advancedps_tpu.resampling import randcat_gumbel
    from advancedps_tpu.smc import SSMKernel
    from bench import gpu_or_exit
    from compile_cache import enable_compile_cache

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R_OBS)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)
    sampler = aps.PGAS(N)
    xs_ref, _ = aps.simulate(jax.random.key(42), model, T)  # a ref trajectory
    ref_state = PGState(trajectory=xs_ref)

    gids = jnp.arange(N)
    ref_mask = gids == (N - 1)

    def amortized(one_rep):
        @jax.jit
        def f(key):
            def body(acc, i):
                return acc + one_rep(jax.random.fold_in(key, i)), ()

            acc, _ = jax.lax.scan(body, 0.0, jnp.arange(reps))
            return acc

        return f

    def measure(one_rep, label):
        f = amortized(one_rep)
        t0 = time.perf_counter()
        float(f(jax.random.key(0)))
        log(f"  [{label}] compile+first: {time.perf_counter()-t0:.1f}s")
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            float(f(jax.random.key(i + 1)))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def dt_of(one_rep, label):
        return measure(one_rep, label) / reps

    # --- whole-iteration and whole-sweep measurements -----------------------
    def full_iter(key):
        smp, _ = step_pg(key, traced, sampler, ref_state, "replay")
        return smp.log_evidence

    def cond_sweep(key):
        res = sweep(
            key,
            kernel,
            N,
            sampler.resampler,
            ref=xs_ref,
            ancestor_sampling=True,
            store_states=False,
        )
        return res.log_evidence + jnp.sum(res.ancestors[T - 1]) * 1e-12

    # --- components, each scanned over the T-1 steps ------------------------
    def propagate_only(key):
        def body(c, t):
            x, lw = c
            rng_t = propagate_rng(key, t, gids)
            x, score = kernel.step(t, rng_t, x, xs_ref[t], ref_mask)
            return (x, lw + score), ()

        x0 = jax.random.uniform(key, (N,))
        (x, lw), _ = jax.lax.scan(body, (x0, jnp.zeros((N,))), jnp.arange(1, T))
        return jnp.sum(lw) * 1e-6

    def reductions_only(key):
        def body(c, t):
            lw, z = c
            m = jnp.max(lw)
            e = jnp.exp(lw - m)
            s1 = jnp.sum(e)
            s2 = jnp.sum(e * e)
            return (lw * 0.9999 + 1e-7 * t, z + m + jnp.log(s1) + 1e-30 * s2), ()

        lw0 = jax.random.uniform(key, (N,))
        (lw, z), _ = jax.lax.scan(body, (lw0, 0.0), jnp.arange(1, T, dtype=jnp.float32))
        return z

    def resample_only(key):
        x0 = jax.random.uniform(key, (N,))
        w = jax.nn.softmax(x0)

        def body(x, t):
            rs_key = rngmod.step_key(key, rngmod.RESAMPLE, t)
            anc = sampler.resampler.resampler(rs_key, w, N - 1)
            moved = _gather(x, anc)
            return jnp.concatenate([moved, x[-1:]]) * 0.9999999, ()

        x, _ = jax.lax.scan(body, x0, jnp.arange(1, T))
        return jnp.sum(x) * 1e-6

    def ancestor_draw_only(key):
        x = jax.random.uniform(key, (N,))

        def body(c, t):
            x, z = c
            anc_logw = x + kernel.transition_logprob(t, x, xs_ref[t])
            anc_key = rngmod.step_key(key, rngmod.ANCESTOR, t)
            j = randcat_gumbel(anc_key, anc_logw, gids)
            return (x * 0.9999999, z + j * 1e-9), ()

        (x, z), _ = jax.lax.scan(body, (x, 0.0), jnp.arange(1, T))
        return z

    def ref_splice_only(key):
        # gather one ref row, concat onto the moved block
        x = jax.random.uniform(key, (N,))

        def body(c, t):
            x = c
            ref_anc = (t * 7919) % N
            moved = jax.lax.slice(x, (0,), (N - 1,))
            ref_row = x[ref_anc][None]
            x2 = jnp.concatenate([moved, ref_row])
            return x2, ()

        x, _ = jax.lax.scan(body, x, jnp.arange(1, T))
        return jnp.sum(x) * 1e-6

    def replay_and_draw(key):
        from advancedps_tpu.engine import replay_trajectory

        anc = jnp.tile(jnp.arange(N, dtype=jnp.int32)[None], (T, 1))
        lw = jax.random.uniform(key, (N,))
        idx = randcat_gumbel(rngmod.step_key(key, rngmod.DRAW, 0), lw)
        traj = replay_trajectory(key, kernel, anc, idx, ref=xs_ref)
        return jnp.sum(traj) * 1e-6

    rows = []
    per_step = {}
    for label, fn, steps in [
        ("FULL PGAS iteration (replay)", full_iter, T - 1),
        ("conditional sweep only", cond_sweep, T - 1),
        ("propagate+score (ref-masked)", propagate_only, T - 1),
        ("weight reductions", reductions_only, T - 1),
        ("resample: decode + gather (D=1)", resample_only, T - 1),
        ("ancestor draw (logpdf+gumbel)", ancestor_draw_only, T - 1),
        ("ref-row splice (slice+concat)", ref_splice_only, T - 1),
        ("replay + retained draw", replay_and_draw, 1),
    ]:
        dt = dt_of(fn, label)
        per = dt / steps
        per_step[label] = dt
        rows.append((label, dt * 1e3, f"{per*1e6:9.1f}us/step" if steps > 1 else ""))

    log("")
    log(f"{'phase':<32}{'device total':>14}  {'per-step':>16}")
    for name, ms, per in rows:
        log(f"{name:<32}{ms:>12.2f}ms  {per:>16}")

    whole = per_step["conditional sweep only"]
    parts = sum(
        per_step[k]
        for k in (
            "propagate+score (ref-masked)",
            "weight reductions",
            "resample: decode + gather (D=1)",
            "ancestor draw (logpdf+gumbel)",
            "ref-row splice (slice+concat)",
        )
    )
    ratio = parts / whole if whole > 0 else float("nan")
    log("")
    log(f"faithfulness: components/conditional sweep = {ratio:.2f}")
    if not (0.5 <= ratio <= 1.5):
        log(
            f"WARNING: components explain {ratio:.0%} of the conditional sweep "
            "— the profiler is measuring a different path than the engine takes."
        )
    iter_total = per_step["FULL PGAS iteration (replay)"]
    log(
        f"iteration = sweep + replay/draw: {whole*1e3:.1f} + "
        f"{per_step['replay + retained draw']*1e3:.1f} = "
        f"{(whole + per_step['replay + retained draw'])*1e3:.1f}ms "
        f"(measured {iter_total*1e3:.1f}ms)"
    )


if __name__ == "__main__":
    main()
