"""In-engine A/B of the resampling schemes at the flagship scale on one GPU.

Times the FULL 1M-particle LGSSM sweep (bench.py's exact methodology: K
sweeps per jitted ``lax.map`` batch, fresh keys per repetition, medians)
under an ALWAYS-RESAMPLE gate so every one of the T−1=99 steps fires the
resampler — the per-firing cost of a scheme is then
``(t_scheme − t_propagate_only) / 99`` with the propagate+score base
common to all schemes.

Run from the repository root:  python profiling/bench_schemes.py
"""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


N = 1_000_000
T = 100
A, Q, R = 0.9, 0.32, 1.0
K = 5


def main():
    import jax

    import advancedps_tpu as aps
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.resampling import (
        ResampleWithESSThreshold,
        resample_multinomial,
        resample_residual,
        resample_stratified,
        resample_systematic,
    )
    from advancedps_tpu.smc import SSMKernel

    from bench import gpu_or_exit
    from compile_cache import enable_compile_cache

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    kernel = SSMKernel(ssm=aps.TracedSSM(model, ys))

    schemes = {
        "systematic": resample_systematic,
        "stratified": resample_stratified,
        "multinomial": resample_multinomial,
        "residual": resample_residual,
    }

    kf_ll = None

    def measure(name, gated, reps=3, k=K):
        nonlocal kf_ll

        def run(key):
            return sweep(key, kernel, N, gated, store_states=False).log_evidence

        run_batch = jax.jit(lambda keys: jax.lax.map(run, keys))

        def batch_keys(rep):
            return jax.random.split(
                jax.random.fold_in(jax.random.key(77), rep), k
            )

        t0 = time.perf_counter()
        lzs = run_batch(batch_keys(0))
        lzs.block_until_ready()
        log(f"{name}: compile+first {time.perf_counter()-t0:.1f}s")
        # correctness anchor per scheme
        if kf_ll is None:
            kf = aps.utils.kalman_filter(
                np.asarray(ys), A, 0.0, Q, 1.0, R, 0.0,
                math.sqrt(Q * Q / (1 - A * A)),
            )
            kf_ll = float(kf.log_likelihood)
        err = abs(float(lzs[0]) - kf_ll)
        assert err < 1.0, (name, float(lzs[0]), kf_ll)
        times = []
        for rep in range(1, reps + 1):
            keys_r = batch_keys(rep)
            t0 = time.perf_counter()
            run_batch(keys_r).block_until_ready()
            times.append((time.perf_counter() - t0) / k)
        med = float(np.median(times))
        log(
            f"{name}: per-sweep {[f'{t*1e3:.1f}ms' for t in times]} "
            f"median {med*1e3:.1f}ms  logZ err {err:.3f}"
        )
        return med

    results = {}
    # Base: adaptive gate never fires (threshold 0) — propagate+score only.
    base = measure(
        "no-resample base",
        ResampleWithESSThreshold(resample_systematic, 0.0),
    )
    results["base"] = base
    for name, fn in schemes.items():
        t = measure(name, ResampleWithESSThreshold(fn, float("inf")))
        results[name] = t
        log(
            f"{name}: per-firing {(t-base)/ (T-1) * 1e3:.2f} ms "
            f"(sweep {t*1e3:.1f} vs base {base*1e3:.1f})"
        )

    if "systematic" in results:
        sys_firing = max(results["systematic"] - base, 1e-9)
        for name in ("stratified", "multinomial", "residual"):
            if name in results:
                ratio = (results[name] - base) / sys_firing
                log(f"{name} per-firing vs systematic: {ratio:.2f}x")


if __name__ == "__main__":
    main()
