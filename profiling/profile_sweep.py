"""Profiling harness (SURVEY.md §5.1): break down where the headline sweep's time
goes on one GPU.

Measurement method: every number comes from a jitted program that runs the
workload ``R`` times back-to-back (keys folded per rep, results summed so
nothing is dead code), with ONE scalar fetch at the end:

    device_time = wall(R reps) / R

Two modes:

* default — component timing table (whole sweep, no-resample sweep, propagate /
  RNG / reduction / gather micro-scans at headline N).
* ``--trace DIR`` — capture a ``jax.profiler`` trace of one sweep (perfetto dump,
  viewable in tensorboard / ui.perfetto.dev).

Run from the repository root:  python profiling/profile_sweep.py
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
REPS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, help="directory for jax.profiler trace")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import advancedps_tpu as aps
    from advancedps_tpu.engine import propagate_rng, sweep
    from advancedps_tpu.smc import SSMKernel
    from advancedps_tpu import rng as rngmod

    from bench import gpu_or_exit
    from compile_cache import enable_compile_cache

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R_OBS)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)
    gated = aps.SMC(N).resampler
    never = aps.ResampleWithESSThreshold(threshold=0.0)

    reps = args.reps

    def amortized(one_rep):
        """jit program: run one_rep(key_i) `reps` times, sum scalar results."""

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
        float(f(jax.random.key(0)))  # compile + warm
        log(f"  [{label}] compile+first: {time.perf_counter()-t0:.1f}s")
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            float(f(jax.random.key(i + 1)))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def dt_of(one_rep, label):
        return measure(one_rep, label) / reps

    gids = jnp.arange(N)

    def full(key):
        return sweep(key, kernel, N, gated, store_states=False).log_evidence

    def no_resample(key):
        return sweep(key, kernel, N, never, store_states=False).log_evidence

    def propagate_only(key):
        # CRITICAL: build the StepRng via the engine's own helper so this
        # micro-bench can never again profile a path the engine doesn't take
        # (the round-2 regression shipped exactly that way).
        def body(c, t):
            x, lw = c
            rng_t = propagate_rng(key, t, gids)
            x, score = kernel.step(t, rng_t, x, None, None)
            return (x, lw + score), ()

        x0 = jax.random.uniform(key, (N,))
        (x, lw), _ = jax.lax.scan(
            body, (x0, jnp.zeros((N,))), jnp.arange(1, T)
        )
        return jnp.sum(lw) * 1e-6

    def rng_only(key):
        def body(x, t):
            kb = jax.random.fold_in(rngmod.step_key(key, 0, t), 0)
            return x * 0.9 + jax.random.normal(kb, (N,)) * 0.32, ()

        x, _ = jax.lax.scan(body, jax.random.uniform(key, (N,)), jnp.arange(1, T))
        return jnp.sum(x) * 1e-6

    def reductions_only(key):
        def body(c, t):
            lw, z = c
            m = jnp.max(lw)
            e = jnp.exp(lw - m)
            s1 = jnp.sum(e)
            s2 = jnp.sum(e * e)
            return (lw * 0.9999 + 1e-7 * t, z + m + jnp.log(s1) + 1e-30 * s2), ()

        lw0 = jax.random.uniform(key, (N,))
        (lw, z), _ = jax.lax.scan(
            body, (lw0, 0.0), jnp.arange(1, T, dtype=jnp.float32)
        )
        return z

    def gather_only(key):
        def body(x, t):
            idx = jnp.argsort(x[:8]).astype(jnp.int32)[0] + jnp.arange(N, dtype=jnp.int32)
            idx = jnp.clip(idx, 0, N - 1)
            return jnp.take(x, idx, axis=0) * 0.9999, ()

        x, _ = jax.lax.scan(body, jax.random.uniform(key, (N,)), jnp.arange(1, T))
        return jnp.sum(x) * 1e-6

    rows = []
    for label, fn in [
        ("full sweep (ESS-gated)", full),
        ("no-resample sweep", no_resample),
        ("propagate+score scan", propagate_only),
        ("rng normal(1M) scan", rng_only),
        ("weight-reduction scan", reductions_only),
        ("dynamic-gather scan", gather_only),
    ]:
        dt = dt_of(fn, label)
        rows.append((label, dt * 1e3, f"{dt/(T-1)*1e6:8.1f}us/step"))

    log("")
    log(f"{'component':<28}{'device total':>14}  {'per-step':>14}")
    for name, ms, per in rows:
        log(f"{name:<28}{ms:>12.2f}ms  {per:>14}")

    # Faithfulness check: the measured components must explain the sweep they
    # claim to decompose.  The no-resample sweep is (propagate+score) +
    # (weight reductions) plus scan overhead; if the parts sum to less than
    # half of the whole, some engine cost is not being profiled — exactly the
    # failure mode that let the round-2 RNG regression ship silently.
    by = {name: ms for name, ms, _ in rows}
    whole = by["no-resample sweep"]
    parts = by["propagate+score scan"] + by["weight-reduction scan"]
    ratio = parts / whole if whole > 0 else float("nan")
    log("")
    log(f"faithfulness: components/no-resample sweep = {ratio:.2f}")
    if not (0.5 <= ratio <= 1.5):
        log(
            "WARNING: component micro-benches explain "
            f"{ratio:.0%} of the no-resample sweep — the profiler is "
            "measuring a different path than the engine takes. Fix this "
            "before trusting any number above."
        )

    if args.trace:
        f = jax.jit(full)
        float(f(jax.random.key(9)))
        with jax.profiler.trace(args.trace):
            float(f(jax.random.key(10)))
        log(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
