"""A/B of the systematic decode forms and of the state gather on one GPU.

Times the flagship sweep (stationary LGSSM a=0.9, q=0.32, r=1.0, T=100,
N=1,000,000), always-resample and adaptive (ESS 0.5), with each form of the
systematic decode:

* ``scan``, ``scan_unrolled``, ``sort`` — ``jnp.searchsorted`` with that
  ``method`` over the positions ``(u + k) / N``;
* ``extents`` — the library's ``resample_systematic``: closed-form extents,
  one scatter-max and one cumulative max;
* ``extents_fill_gather`` — the same decode, but the state gather masks
  out-of-range rows with NaN (``jnp.take``'s default) instead of clamping as
  ``engine._gather`` does.

The cells run in turns: ``--rounds`` rounds, each running every cell
``--reps`` times, so drift of the card's clock spreads over all cells alike.
Prints per-round medians, the overall median and each cell's logZ error
against the Kalman filter.  ``--trace DIR`` then traces two warm sweeps of
the scan and extents cells and prints their reduction
(``profiling/trace_reduce.py``).

Run from the repository root:  python profiling/decode_ab.py [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 1_000_000
T = 100
A, Q, R_OBS = 0.9, 0.32, 1.0
MODES = {"always": float("inf"), "adaptive": 0.5}
TRACE_CELLS = ("scan/always", "scan/adaptive", "extents/always", "extents/adaptive")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def searchsorted_systematic(method: str):
    """Systematic resampling by ``jnp.searchsorted(..., method=method)``."""
    import jax
    import jax.numpy as jnp

    def resample(key, weights, n):
        u = jax.random.uniform(key, dtype=weights.dtype)
        us = (u + jnp.arange(n, dtype=weights.dtype)) / n
        idx = jnp.searchsorted(jnp.cumsum(weights), us, side="right", method=method)
        return jnp.clip(idx, 0, weights.shape[0] - 1).astype(jnp.int32)

    return resample


def fill_gather(state, idx):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), state)


@contextlib.contextmanager
def engine_gather(gather):
    """Trace the engine with ``gather`` in place of ``engine._gather``."""
    from advancedps_tpu import engine

    saved = engine._gather
    if gather is not None:
        engine._gather = gather
    try:
        yield
    finally:
        engine._gather = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None, help="directory for the traces")
    ap.add_argument("--json", default=None, help="also write the medians here")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    n = args.n

    import jax

    import advancedps_tpu as aps
    from advancedps_tpu import resampling as rs
    from advancedps_tpu.engine import sweep
    from advancedps_tpu.smc import SSMKernel
    from bench import device_record, gpu_or_exit
    from compile_cache import enable_compile_cache
    from trace_reduce import format_summary, newest_trace, reduce_trace

    dev, n_devices, smi = gpu_or_exit()
    log(f"compile cache: {enable_compile_cache()}")
    print(smi, flush=True)

    model = aps.models.stationary_lgssm(a=A, q=Q, r=R_OBS)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    kernel = SSMKernel(ssm=aps.TracedSSM(model, ys))
    kal = float(aps.utils.kalman_filter(
        ys, A, 0.0, Q, 1.0, R_OBS, 0.0, math.sqrt(Q * Q / (1 - A * A))
    ).log_likelihood)

    forms = {
        "scan": (searchsorted_systematic("scan"), None),
        "scan_unrolled": (searchsorted_systematic("scan_unrolled"), None),
        "sort": (searchsorted_systematic("sort"), None),
        "extents": (rs.resample_systematic, None),
        "extents_fill_gather": (rs.resample_systematic, fill_gather),
    }
    key = jax.random.key(1)
    cells = {}
    for form, (fn, gather) in forms.items():
        for mode, threshold in MODES.items():
            gated = aps.ResampleWithESSThreshold(resampler=fn, threshold=threshold)
            with engine_gather(gather):
                t0 = time.perf_counter()
                run = jax.jit(lambda k, g=gated: sweep(
                    k, kernel, n, g, store_states=False).log_evidence
                ).lower(key).compile()
                compile_s = time.perf_counter() - t0
            err = abs(float(run(key)) - kal)
            name = f"{form}/{mode}"
            cells[name] = run
            print(f"compile {name:<28} {compile_s:6.2f} s  |logZ - kalman| {err:.4f}",
                  flush=True)

    medians = {name: [] for name in cells}
    for _ in range(args.rounds):
        for name, run in cells.items():
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(run(key))
                times.append(time.perf_counter() - t0)
            medians[name].append(statistics.median(times) * 1e3)
    summary = {}
    for name, ms in medians.items():
        summary[name] = statistics.median(ms)
        print(f"{name:<30} round medians (ms) {[round(m, 3) for m in ms]}  "
              f"overall {summary[name]:.3f}", flush=True)

    if args.trace:
        for name in TRACE_CELLS:
            run = cells[name]
            jax.block_until_ready(run(key))
            out = os.path.join(args.trace, name.replace("/", "_"))
            with jax.profiler.trace(out):
                for _ in range(2):
                    jax.block_until_ready(run(key))
            print(f"== trace {name}\n{format_summary(reduce_trace(newest_trace(out)))}",
                  flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ms": summary, "n": n, "T": T, "nvidia_smi": smi,
                       **device_record(dev, n_devices, smi)}, f, indent=1)


if __name__ == "__main__":
    main()
