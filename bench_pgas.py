"""PGAS-at-scale benchmark: 1M-particle conditional sweeps on one GPU.

The north star (BASELINE.md): PGAS with N=1M particles on a T=100 LGSSM —
the full conditional sweep (reference slot masking + ancestor sampling,
reference stack ``/root/reference/src/smc.jl:101-129`` +
``/root/reference/src/pgas.jl:113-128``) PLUS the retained-trajectory draw and
reconstruction, per iteration.  Runs with ``trajectory_storage="replay"``
(genealogy compaction): the sweep stores only the [T, N] ancestor trace and the
retained trajectory is re-sampled along its lineage from the positional RNG.

Correctness anchor: retained trajectories are marginally distributed as the
exact smoothing distribution, so the mean over iterations must approach the
RTS smoother means (``utils.kalman_smoother``) within Monte-Carlo error.

``vs_baseline`` scales the same native single-core C++ bootstrap sweep used by
``bench.py`` to iterations/s (one PGAS iteration ≈ one N·T sweep): it answers
"how many single-core-sweep-equivalents per second does the chip sustain".

Prints ONE JSON line (sibling of bench.py's, with the same device fields).
Exits non-zero without a GPU.
"""

import json
import math
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


N = 1_000_000
T = 100
A, Q, R = 0.9, 0.32, 1.0
WARM_ITERS = 4
BENCH_ITERS = 8
ANCHOR_ITERS = 24


def main():
    import jax

    from bench import device_record, gpu_or_exit
    from compile_cache import enable_compile_cache

    dev, n_devices, smi = gpu_or_exit()

    import advancedps_tpu as aps

    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {n_devices} x {dev.device_kind} ({smi})")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    traced = aps.TracedSSM(model, ys)
    sampler = aps.PGAS(N)

    def chain(key, iters):
        return aps.sample(
            key, traced, sampler, iters, trajectory_storage="replay"
        )

    # Compile + warm with BENCH_ITERS so the timed calls hit the same compiled
    # scan (a different iteration count is a different program).
    t0 = time.perf_counter()
    warm = chain(jax.random.key(1), BENCH_ITERS)
    warm.log_evidence.block_until_ready()
    log(f"compile+warm ({BENCH_ITERS} iters): {time.perf_counter()-t0:.1f}s")

    times = []
    for i in range(5):
        t0 = time.perf_counter()
        chain(jax.random.key(2 + i), BENCH_ITERS).log_evidence.block_until_ready()
        times.append((time.perf_counter() - t0) / BENCH_ITERS)
    per_iter = float(np.median(times))
    best = float(np.min(times))
    rate = 1.0 / per_iter
    log(f"per-iteration: {[f'{t*1e3:.1f}ms' for t in times]}  "
        f"median {per_iter*1e3:.1f}ms  best {best*1e3:.1f}ms")
    log(f"throughput: {rate:.2f} PGAS(1M, T=100) iterations/s "
        f"(best window {1.0/best:.2f}/s)")

    # --- anchor: mean retained trajectory vs exact RTS smoother -------------
    sm = aps.utils.kalman_smoother(
        np.asarray(ys), A, 0.0, Q, 1.0, R, 0.0, math.sqrt(Q * Q / (1 - A * A))
    )
    # Reuse the BENCH_ITERS-compiled scan (a different iteration count would
    # recompile the whole conditional sweep): run independent short chains and
    # pool their post-burn-in iterates.
    n_chains = -(-ANCHOR_ITERS // (BENCH_ITERS - WARM_ITERS))
    chain_means = []
    for c in range(n_chains):
        res = chain(jax.random.fold_in(jax.random.key(9), c), BENCH_ITERS)
        chain_means.append(np.asarray(res.trajectory)[WARM_ITERS:].mean(axis=0))
    cm = np.stack(chain_means)  # [n_chains, T]
    est = cm.mean(axis=0)
    # Standard error from the n_chains INDEPENDENT chain means: within-chain
    # iterates are autocorrelated, so pooling all iterates as independent would
    # understate the SE and make the zrms gate flaky.  The posterior
    # sd/sqrt(iters) floor guards the degenerate perfect-mixing case where the
    # between-chain variance estimate itself is noisy at n_chains ~ 6.
    sd = np.sqrt(np.asarray(sm.variances))
    se_chains = cm.std(axis=0, ddof=1) / math.sqrt(cm.shape[0])
    se = np.maximum(se_chains, sd / math.sqrt(cm.shape[0] * (BENCH_ITERS - WARM_ITERS)))
    z = (est - np.asarray(sm.means)) / se
    zrms = float(np.sqrt(np.mean(z * z)))
    log(f"posterior-mean anchor: RMS z-score vs RTS smoother = {zrms:.2f}")
    assert zrms < 3.0, "PGAS trajectories inconsistent with exact smoother"

    lz_err = abs(float(res.log_evidence[-1]) - float(sm.log_likelihood))
    log(f"final-iteration logZ error vs Kalman: {lz_err:.4f}")
    assert lz_err < 1.0

    from advancedps_tpu.ops import native

    sigma0 = math.sqrt(Q * Q / (1 - A * A))
    if native.available():
        from bench import native_baseline_rate

        base_rate = native_baseline_rate(np.asarray(ys), sigma0)  # particle-steps/s
    else:
        from bench import numpy_baseline_rate

        base_rate = numpy_baseline_rate(np.asarray(ys))
    base_iters = base_rate / (N * T)
    log(f"native baseline: {base_iters*1e3:.2f} sweep-equivalent iters/s (x1e-3)")

    # The machine-readable value is the quickest measured window, with the
    # median beside it.
    best_rate = 1.0 / best
    print(
        json.dumps(
            {
                "metric": "pgas_1m_iterations_per_sec_per_chip",
                "value": best_rate,
                "unit": "iterations/s (N=1M, T=100, replay storage; quickest window)",
                "vs_baseline": best_rate / base_iters,
                "median_iterations_per_sec": rate,
                **device_record(dev, n_devices, smi),
            }
        )
    )


if __name__ == "__main__":
    main()
