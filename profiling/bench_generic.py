"""Generic front-end benchmark on one GPU.

This harness runs the SAME T=50 LGSSM twice at N=100k on the device —

  * as a GenericModel program (50 sample sites / 50 observes, executed via the
    per-step ``lax.switch`` segment slicing), and
  * as the structured :class:`SSMKernel` equivalent —

and reports compile time and steady-state sweep throughput for both, guarding
the ``lax.switch`` compile-scaling story (generic.py) with on-device numbers.

Run from the repository root:  python profiling/bench_generic.py
"""

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 100_000
T = 50
A, Q, R_OBS = 0.9, 0.32, 1.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--T", type=int, default=T)
    args = ap.parse_args()
    n, T_ = args.n, args.T

    import jax
    import jax.numpy as jnp

    import advancedps_tpu as aps
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel
    from advancedps_tpu.inference import make_kernel

    from bench import gpu_or_exit
    from compile_cache import enable_compile_cache

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R_OBS)
    _, ys = aps.simulate(jax.random.key(0), model, T_)
    ys_np = np.asarray(ys)
    sigma0 = math.sqrt(Q * Q / (1 - A * A))

    # The same model as a generic program: T sample sites + T observes.
    def prog(ctx):
        x = ctx.sample(aps.Normal(0.0, sigma0), name="x0")
        ctx.observe(aps.Normal(x, R_OBS), float(ys_np[0]))
        for t in range(1, T_):
            x = ctx.sample(aps.Normal(A * x, Q), name=f"x{t}")
            ctx.observe(aps.Normal(x, R_OBS), float(ys_np[t]))

    gated = aps.SMC(n).resampler
    results = {}
    for label, kernel in [
        ("structured SSMKernel", SSMKernel(ssm=aps.TracedSSM(model, ys))),
        ("generic lax.switch", make_kernel(aps.GenericModel(prog))),
    ]:
        @jax.jit
        def run(key, kernel=kernel):
            def body(c, i):
                r = sweep(
                    jax.random.fold_in(key, i), kernel, n, gated,
                    store_states=False,
                )
                return c + r.log_evidence * 1e-6, ()

            c, _ = jax.lax.scan(body, 0.0, jnp.arange(args.reps))
            return c

        t0 = time.perf_counter()
        float(run(jax.random.key(1)))
        compile_s = time.perf_counter() - t0
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            float(run(jax.random.key(2 + i)))
            ts.append(time.perf_counter() - t0)
        wall = float(np.median(ts))
        per_sweep = wall / args.reps
        rate = n * T_ / per_sweep
        results[label] = (compile_s, per_sweep, rate)
        log(
            f"[{label:>22}] compile+first {compile_s:6.1f}s   "
            f"{per_sweep*1e3:7.1f} ms/sweep   {rate/1e6:8.1f} M particle-steps/s"
        )

    s = results["structured SSMKernel"][2]
    g = results["generic lax.switch"][2]
    log(f"generic/structured throughput ratio: {g/s:.2f}x")


if __name__ == "__main__":
    main()
