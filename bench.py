"""Headline benchmark: particles/sec/chip on a 1M-particle LGSSM bootstrap sweep.

The reference publishes no speed numbers (BASELINE.md); the baseline for
``vs_baseline`` is therefore a native single-core C++ implementation of the same
bootstrap particle filter (``cpp/resampling.cpp::aps_lgssm_sweep`` — the closest
stand-in for the reference's compiled single-process Julia loop,
``/root/reference/src/container.jl:316-363``), measured on this machine at a
smaller N and compared by per-particle-step throughput.  Falls back to a
vectorised NumPy implementation if g++ is unavailable.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
     "device_kind": "...", "device_count": N, "power_limit": "... W"}
Diagnostics go to stderr.  Exits non-zero without a GPU.
"""

import json
import math
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gpu_or_exit():
    """The first JAX device, which must be a GPU: a measurement never falls
    back to the CPU.  Returns ``(device, n_devices, nvidia_smi_line)``."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"needs a GPU; JAX found {devs[0].platform}")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return devs[0], len(devs), smi


def device_record(dev, n_devices, smi):
    """The device fields every JSON line carries."""
    return {
        "device_kind": dev.device_kind,
        "device_count": n_devices,
        "power_limit": smi.split(",")[-1].strip(),
    }


# --- config (headline: 1M particles, T=100 — BASELINE.json) ---------------------
N = 1_000_000
T = 100
A, Q, R = 0.9, 0.32, 1.0
N_NUMPY = 100_000  # baseline measured here, throughput is N-linear (checked)


def native_baseline_rate(ys: np.ndarray, sigma0: float) -> float:
    """Single-core C++ bootstrap sweep (cpp/resampling.cpp).

    Best of 3 runs — a single cold run is noisy (±30%) on a shared host and
    that noise would leak straight into ``vs_baseline``.
    """
    from advancedps_tpu.ops import native

    n = N_NUMPY
    T = len(ys)
    rng = np.random.default_rng(0)
    init_noise = rng.standard_normal(n).astype(np.float32)
    step_noise = rng.standard_normal((T - 1) * n).astype(np.float32)
    res_u = rng.random(T).astype(np.float32)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native.lgssm_sweep(ys, init_noise, step_noise, res_u, n, A, Q, R, sigma0)
        best = min(best, time.perf_counter() - t0)
    return n * T / best


def numpy_baseline_rate(ys: np.ndarray) -> float:
    """Vectorised NumPy bootstrap filter (adaptive systematic resampling)."""
    rng = np.random.default_rng(0)
    sigma0 = math.sqrt(Q * Q / (1 - A * A))
    n = N_NUMPY

    def run():
        x = rng.standard_normal(n) * sigma0
        logw = -0.5 * ((ys[0] - x) / R) ** 2 - math.log(R) - 0.5 * math.log(2 * math.pi)
        log_z = 0.0
        for t in range(1, T):
            m = logw.max()
            w = np.exp(logw - m)
            sw = w.sum()
            wn = w / sw
            ess = 1.0 / np.square(wn).sum()
            if ess <= 0.5 * n:
                u = rng.random()
                pos = (u + np.arange(n)) / n
                idx = np.searchsorted(np.cumsum(wn), pos, side="right").clip(0, n - 1)
                x = x[idx]
                logw = np.zeros(n)
            x = A * x + rng.standard_normal(n) * Q
            logw = logw - 0.5 * ((ys[t] - x) / R) ** 2 - math.log(R) - 0.5 * math.log(2 * math.pi)
        return log_z

    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    return n * T / dt


def main():
    import jax
    import jax.numpy as jnp

    dev, n_devices, smi = gpu_or_exit()

    import advancedps_tpu as aps
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel
    from compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)
    gated = aps.SMC(N).resampler

    @jax.jit
    def run(key):
        res = sweep(key, kernel, N, gated, store_states=False)
        return res.log_evidence

    # Compile and first run, split so set-up time is visible.
    t0 = time.perf_counter()
    lowered = run.lower(jax.random.key(1))
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    lz = float(compiled(jax.random.key(1)))
    t_first = time.perf_counter() - t0
    log(
        f"compile+first run: {t_lower+t_compile+t_first:.1f}s  logZ={lz:.3f}  "
        f"(trace+lower {t_lower:.1f}s, backend compile {t_compile:.1f}s, "
        f"first run {t_first:.1f}s)"
    )

    # Populate the jit wrapper's own cache (hits the persistent cache) so the
    # latency loop below measures runs, not a compile.
    run(jax.random.key(1)).block_until_ready()

    # correctness anchor vs exact Kalman
    kf = aps.utils.kalman_filter(
        np.asarray(ys), A, 0.0, Q, 1.0, R, 0.0, math.sqrt(Q * Q / (1 - A * A))
    )
    err = abs(lz - float(kf.log_likelihood))
    log(f"logZ error vs Kalman: {err:.4f}")
    assert err < 1.0, "bench run failed correctness anchor"

    # Per-call latency (diagnostic): one sweep per call, blocking each.
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        run(jax.random.key(2 + i)).block_until_ready()
        times.append(time.perf_counter() - t0)
    log(
        f"per-call latency: "
        f"{[f'{t*1e3:.1f}ms' for t in times]}  median {np.median(times)*1e3:.1f}ms"
    )

    # Headline: steady-state device throughput.  K sweeps run inside ONE jitted
    # call (lax.map over keys), so the device executes them back-to-back.
    K = 5

    @jax.jit
    def run_batch(keys):
        return jax.lax.map(run, keys)

    def batch_keys(rep: int):
        return jax.random.split(jax.random.fold_in(jax.random.key(7), rep), K)

    lzs = run_batch(batch_keys(0))  # compile + warmup
    lzs.block_until_ready()
    batch_times = []
    for rep in range(1, 4):
        keys_r = batch_keys(rep)
        t0 = time.perf_counter()
        run_batch(keys_r).block_until_ready()
        batch_times.append((time.perf_counter() - t0) / K)
    dt = float(np.median(batch_times))
    rate = N * T / dt
    log(f"batched per-sweep times: {[f'{t*1e3:.1f}ms' for t in batch_times]}  median {dt*1e3:.1f}ms")
    log(f"throughput: {rate/1e9:.3f} G particle-steps/s per device")

    from advancedps_tpu.ops import native

    sigma0 = math.sqrt(Q * Q / (1 - A * A))
    if native.available():
        np_rate = native_baseline_rate(np.asarray(ys), sigma0)
        log(f"native C++ baseline: {np_rate/1e6:.1f} M particle-steps/s")
    else:
        np_rate = numpy_baseline_rate(np.asarray(ys))
        log(f"numpy baseline: {np_rate/1e6:.1f} M particle-steps/s")

    print(
        json.dumps(
            {
                "metric": "lgssm_sweep_particle_steps_per_sec_per_chip",
                "value": rate,
                "unit": "particle-steps/s",
                "vs_baseline": rate / np_rate,
                **device_record(dev, n_devices, smi),
            }
        )
    )


if __name__ == "__main__":
    main()
