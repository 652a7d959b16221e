"""Warm times of the main paths, for comparing two versions of the package.

Times, at the flagship width (stationary LGSSM a=0.9, q=0.32, r=1.0, T=100,
N=1,000,000): adaptive SMC through ``aps.sample``; each resampling scheme
always-resample through ``engine.sweep``; PGAS with 8 iterations and replay
storage through ``aps.sample`` (``--n`` sets N).  Each path's time is the median of ``--reps``
warm runs, each ended by ``block_until_ready``.  Only API that every version
of the package has is used, so ``--root`` can point at another checkout:

    git archive <commit> | tar -x -C _build/parent
    for r in _build/parent . . _build/parent; do
        python profiling/ab_paths.py --root $r; done

Prints one JSON line per run: the package's path and the medians in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

N = 1_000_000
T = 100
A, Q, R_OBS = 0.9, 0.32, 1.0
PGAS_ITERS = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=_REPO,
                    help="checkout whose advancedps_tpu package is timed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    n = args.n

    import jax

    from bench import device_record, gpu_or_exit
    from compile_cache import enable_compile_cache

    # The other checkout's package goes first on the path, after this
    # checkout's scripts are imported.
    sys.path.insert(0, os.path.abspath(args.root))
    import advancedps_tpu as aps
    from advancedps_tpu import resampling as rs
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"package: {aps.__file__}")

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R_OBS)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)

    paths = {"adaptive SMC": lambda k: aps.sample(k, traced, aps.SMC(n)).log_evidence}
    for scheme in (rs.resample_systematic, rs.resample_stratified,
                   rs.resample_multinomial, rs.resample_residual):
        gated = aps.ResampleWithESSThreshold(resampler=scheme, threshold=float("inf"))
        paths[f"always {scheme.__name__}"] = lambda k, g=gated: sweep(
            k, kernel, n, g, store_states=False).log_evidence
    paths[f"PGAS x{PGAS_ITERS} replay"] = lambda k: aps.sample(
        k, traced, aps.PGAS(n), PGAS_ITERS, trajectory_storage="replay").log_evidence

    key = jax.random.key(1)
    ms = {}
    for name, fn in paths.items():
        run = jax.jit(fn).lower(key).compile()
        jax.block_until_ready(run(key))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(key))
            times.append(time.perf_counter() - t0)
        ms[name] = statistics.median(times) * 1e3
        log(f"{name:<32} {ms[name]:9.3f} ms")
    print(json.dumps({"package": os.path.dirname(aps.__file__), "n": n, "ms": ms,
                      "nvidia_smi": smi, **device_record(dev, n_devices, smi)}),
          flush=True)


if __name__ == "__main__":
    main()
