"""Process-spanning mesh: spawned 2-process CPU-backend equivalence test.

The north star's last layer (BASELINE.json: "1 chip, 1 host and N hosts") —
the reference has no distributed code at all (SURVEY.md §2.13), so this is
invented-layer territory: ``parallel.mesh.init_distributed`` glues
``jax.distributed.initialize`` + gloo CPU collectives, after which
``particle_mesh()`` spans processes and the sharded sweeps run unchanged.

This test spawns two REAL processes (4 virtual CPU devices each → one
8-device global mesh), runs the conditional sharded sweep with PGAS
ancestor sampling in both, and asserts both processes agree with each other
AND with the in-process single-chip sweep — the same contract
``dryrun_multichip`` pins single-process, across a process boundary.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "multiprocess_worker.py")
_NPROC = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(pid, port):
    env = dict(os.environ)
    env.update(
        # CPU workers import the package by path.
        PYTHONPATH=_REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_NUM_CPU_DEVICES="4",
    )
    return subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(_NPROC), str(port)],
        cwd=_REPO,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def test_two_process_mesh_matches_single_chip():
    port = _free_port()
    procs = [_spawn(i, port) for i in range(_NPROC)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append((p.returncode, out, err))

    results = []
    for rc, out, err in outs:
        if rc != 0:
            blob = (out + "\n" + err)[-2000:]
            if "distributed" in blob and (
                "not supported" in blob or "Unimplemented" in blob
            ):
                pytest.skip(f"jax distributed CPU unsupported here: {blob[-300:]}")
            pytest.fail(f"worker failed rc={rc}:\n{blob}")
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))

    a, b = results
    assert a["n_global_devices"] == b["n_global_devices"] == 8
    # Replicated outputs must be IDENTICAL across processes (same program,
    # same global mesh, deterministic collectives).
    assert a["log_z"] == b["log_z"]
    assert a["resampled"] == b["resampled"]
    np.testing.assert_array_equal(a["ess"], b["ess"])
    # And match the single-chip sweep to cross-shard reduction-order
    # tolerance (the single-process mesh tests' contract).
    for r in results:
        assert abs(r["log_z"] - r["log_z_single"]) < 0.05, r
