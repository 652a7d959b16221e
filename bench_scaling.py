"""Weak-scaling harness: sharded PGAS across an N-device mesh.

This harness runs the sharded conditional sweep at a fixed per-device
particle count over meshes of 1, 2, 4, … devices and reports throughput and
efficiency.

With ``--platform gpu`` it measures scaling over the host's GPUs (NCCL
collectives over NVLink) and fails if JAX finds no GPU.  By default it runs
on virtual CPU devices (`--platform cpu`, faking 8 devices) — that validates
the collective code paths and the harness itself; CPU-mesh timings are *not*
performance-representative (all "devices" share host cores).

Two modes:

* ``--mode weak`` (default): fixed particles PER DEVICE, growing total — the
  classic weak-scaling curve.  Meaningful on real chips; on the virtual CPU
  mesh it mostly measures the host running K× the work on the same cores.
* ``--mode overhead``: fixed TOTAL particles, growing device count — on the
  virtual CPU mesh the total compute is constant, so any slowdown vs 1 device
  IS the partitioning + collective overhead of the sharded sweep.  This is the
  honest single-host proxy for scaling quality: efficiency = t(1)/t(K).

Usage:
    python bench_scaling.py [--platform cpu|gpu] [--mode weak|overhead]
                            [--per-device 65536] [--steps 50]
"""

import argparse
import json
import os
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    p.add_argument("--mode", default="weak", choices=["weak", "overhead"])
    p.add_argument("--per-device", type=int, default=65536)
    p.add_argument("--total", type=int, default=262144,
                   help="total particles in --mode overhead")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument(
        "--exchange", default="auto", choices=["auto", "allgather", "neighbor"]
    )
    p.add_argument("--out", default=None, help="also write the JSON record here")
    args = p.parse_args()

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        print("--platform gpu needs a GPU", file=sys.stderr)
        sys.exit(1)

    import advancedps_tpu as aps
    from compile_cache import enable_compile_cache

    enable_compile_cache()
    from advancedps_tpu.parallel import particle_mesh, sharded_step_pg
    from advancedps_tpu.smc import SSMKernel

    n_dev = len(jax.devices())
    sizes = [k for k in (1, 2, 4, 8, 16) if k <= n_dev]
    print(f"devices: {n_dev} × {jax.devices()[0].platform}", file=sys.stderr)

    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, args.steps)
    traced = aps.TracedSSM(model, ys)
    kernel = SSMKernel(ssm=traced)

    results = {}
    for k in sizes:
        n = args.per_device * k if args.mode == "weak" else args.total
        mesh = particle_mesh(k)
        sampler = aps.PGAS(n)

        @jax.jit
        def step(key, st):
            smp, st = sharded_step_pg(
                key, kernel, sampler, mesh, st, exchange=args.exchange
            )
            return smp.log_evidence, st

        _, st = sharded_step_pg(
            jax.random.key(0), kernel, sampler, mesh, None, exchange=args.exchange
        )
        lz, st = step(jax.random.key(1), st)  # compile
        jax.block_until_ready(lz)
        t0 = time.perf_counter()
        for i in range(args.iters):
            lz, st = step(jax.random.fold_in(jax.random.key(2), i), st)
        jax.block_until_ready(lz)
        dt = (time.perf_counter() - t0) / args.iters
        rate = n * args.steps / dt
        results[k] = rate
        if 1 not in results:
            eff = 1.0
        elif args.mode == "weak":
            eff = rate / (results[1] * k)
        else:
            eff = rate / results[1]
        print(
            f"devices={k:2d}  N={n:>9,}  {dt*1e3:8.1f} ms/iter  "
            f"{rate/1e6:8.1f} M particle-steps/s  eff={eff:5.1%}",
            file=sys.stderr,
        )

    top = max(sizes)
    if args.mode == "weak":
        record = {
            "metric": f"pgas_weak_scaling_eff_{top}dev_{args.platform}",
            "value": results[top] / (results[1] * top),
            "unit": "efficiency",
            "per_device_particles": args.per_device,
            "steps": args.steps,
            "exchange": args.exchange,
            "particle_steps_per_sec_by_devices": {
                str(k): results[k] for k in sizes
            },
            "weak_efficiency_by_devices": {
                str(k): results[k] / (results[1] * k) for k in sizes
            },
            "note": (
                "CPU-mesh timings validate collective code paths, not hardware "
                "performance (virtual devices share host cores)"
                if args.platform == "cpu"
                else f"{jax.devices()[0].device_kind} x {top}, NCCL collectives"
            ),
        }
    else:
        record = {
            "metric": f"pgas_sharding_overhead_eff_{top}dev_{args.platform}",
            "value": results[top] / results[1],
            "unit": "efficiency (t_1dev / t_Kdev at fixed total N)",
            "total_particles": args.total,
            "steps": args.steps,
            "exchange": args.exchange,
            "particle_steps_per_sec_by_devices": {
                str(k): results[k] for k in sizes
            },
            "overhead_efficiency_by_devices": {
                str(k): results[k] / results[1] for k in sizes
            },
            "note": (
                "fixed total particles on one host: constant compute, so "
                "efficiency < 1 is exactly the partitioning + collective "
                "overhead of the sharded sweep"
            ),
        }
    line = json.dumps(record)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
