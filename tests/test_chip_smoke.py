"""``chip_smoke.py`` and the scripts that measure on the GPU.

On the CPU the phases run at tiny sizes with limits loosened for the Monte
Carlo error of so few particles; the full-width run needs a GPU.  The
scripts must refuse to run, and print no result, where JAX finds no GPU.  The
one test marked ``chip`` runs the full smoke script and skips unless a GPU is
visible to a fresh JAX process.
"""

import json
import os
import subprocess
import sys

import jax
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def _run_script(*args, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=_REPO, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize(
    "script",
    [["chip_smoke.py"], ["chip_smoke.py", "--multi"], ["bench.py"], ["bench_pgas.py"],
     ["profiling/decode_ab.py"], ["profiling/ab_paths.py"]],
    ids=["smoke", "smoke-multi", "bench", "bench_pgas", "decode_ab", "ab_paths"],
)
def test_script_refuses_cpu(script):
    out = _run_script(*script)
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_smoke_alone_fails(tmp_path):
    # A directory holding chip_smoke.py and nothing else of the repository.
    source = open(os.path.join(_REPO, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(source)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=dict(env, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("smc", dict(n=4096, T=20, tol=0.5)),
        ("schemes", dict(n=2048, T=20, tol=0.8)),
        ("pgas", dict(n=512, T=20, iters=6, burn=2, n_chains=3, n_pair=256)),
        ("generic", dict(n=64, iters=3)),
        ("precision", dict(d=64, batch=256)),
        ("determinism", dict(n=1024, T=20)),
    ],
)
def test_single_device_phase_passes_at_tiny_size(phase, kwargs):
    chip_smoke.SINGLE_PHASES[phase](**kwargs)


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("sharded_sweep", dict(n=4096, T=20, k=4, kalman_tol=0.5, n_witness=1024)),
        ("sharded_pgas", dict(n=4 * 256, T=20, k=4, iters=6, burn=2)),
    ],
)
def test_multi_device_phase_passes_on_cpu_mesh(phase, kwargs):
    assert len(jax.devices()) >= 4
    chip_smoke.MULTI_PHASES[phase](**kwargs)


def test_report_raises_on_a_failed_check(capsys):
    chip_smoke.report("probe", 0.0, 0.0, [("good", 1.0, 2.0, True)])
    with pytest.raises(AssertionError, match="bad"):
        chip_smoke.report("probe", 0.0, 0.0, [("bad", 3.0, 2.0, False)])
    assert "FAIL" in capsys.readouterr().out


# --- the trace reduction -------------------------------------------------------


def test_trace_reduce_busy_share_and_host_copies(tmp_path):
    sys.path.insert(0, os.path.join(_REPO, "profiling"))
    import gzip

    from trace_reduce import format_summary, newest_trace, reduce_trace

    meta = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 2, "tid": 7, "name": "thread_name",
         "args": {"name": "Stream #7(Compute)"}},
    ]
    spans = [  # µs; [0, 30) and [20, 40) overlap, then a gap, then [60, 70)
        (1, 0, 0.0, 1000.0, "host work"),
        (2, 7, 0.0, 30.0, "loop_fusion"),
        (2, 7, 20.0, 20.0, "loop_fusion"),
        (2, 7, 60.0, 5.0, "MemcpyD2H"),
        (2, 7, 65.0, 5.0, "input_reduce_fusion"),
        (2, 7, 90.0, 10.0, "loop_fusion"),
    ]
    events = meta + [{"ph": "X", "pid": p, "tid": t, "ts": ts, "dur": d, "name": n}
                     for p, t, ts, d, n in spans]
    run = tmp_path / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)

    (stream,) = reduce_trace(newest_trace(str(tmp_path)))
    assert stream["stream"] == "/device:GPU:0 / Stream #7(Compute)"
    assert stream["events"] == 5 and stream["d2h_copies"] == 1
    assert stream["window_ms"] == pytest.approx(0.1)
    assert stream["busy_ms"] == pytest.approx(0.06)
    assert stream["busy_share"] == pytest.approx(0.6)
    assert stream["top"][0] == ("loop_fusion", pytest.approx(0.06), 3)
    assert "60.00%" in format_summary([stream])


# --- the compile-cache helper --------------------------------------------------


def test_cache_helper_defaults_to_checkout(monkeypatch):
    import compile_cache as cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(_REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in open(os.path.join(_REPO, ".gitignore")).read().split()


def test_cache_helper_leaves_env_setting_alone(monkeypatch, tmp_path):
    import compile_cache as cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def gpu():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU visible to JAX")


@pytest.mark.chip
def test_chip_smoke_passes_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
