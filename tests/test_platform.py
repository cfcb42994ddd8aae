"""No fallback that hides the device: the CLI refuses an implicit CPU
run, bench.py refuses to measure without a GPU, and the compile cache
lands where the rules put it."""

import json
import re

import jax
import pytest

import bench
from fluid2d_tpu import cli
from fluid2d_tpu.utils import cache

# --- compile-cache placement ---------------------------------------------------


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_cache_env_var_leaves_directory_to_jax(backend):
    assert cache.cache_dir_for(backend, "/somewhere/else") is None


def test_cache_on_gpu_is_the_checkout_directory():
    got = cache.cache_dir_for("gpu", None)
    assert got == str(cache.CHECKOUT_CACHE_DIR)
    assert cache.CHECKOUT_CACHE_DIR.name == ".jax_cache"
    assert (cache.CHECKOUT_CACHE_DIR.parent / "fluid2d_tpu").is_dir()


def test_cache_path_is_fixed():
    """No pid, time or temporary name: the same path in every process."""
    got = cache.cache_dir_for("gpu", None)
    assert got == cache.cache_dir_for("gpu", "")
    assert not re.search(r"\d{4,}|tmp", got.removeprefix(str(cache.CHECKOUT_CACHE_DIR.parent)))


def test_cache_off_on_cpu():
    assert cache.cache_dir_for("cpu", None) is None


def test_enable_compile_cache_on_cpu_sets_nothing(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_reports_env_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


# --- the CLI refuses an implicit CPU fallback --------------------------------------


@pytest.mark.parametrize(("flag", "settings", "want"), [
    (True, (None, None), True),
    (False, ("cpu", None), True),
    (False, (None, "cpu"), True),
    (False, (None, "cpu,gpu"), True),
    (False, (None, "gpu,cpu"), False),
    (False, ("cuda", None), False),
    (False, (None, None), False),
    (False, ("", ""), False),
])
def test_cpu_requested(flag, settings, want):
    assert cli.cpu_requested(flag, *settings) is want


@pytest.fixture
def no_cpu_request(monkeypatch):
    """The process as a user would start it: no platform list anywhere
    (the backend stays the CPU this sandbox initialized)."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    saved = jax.config.jax_platforms
    jax.config.update("jax_platforms", None)
    yield
    jax.config.update("jax_platforms", saved)


def test_cli_refuses_implicit_cpu(no_cpu_request, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["-res", "16", "--steps", "1", "--output", str(tmp_path)])
    assert e.value.code == 2
    assert "no accelerator found" in capsys.readouterr().err


def test_cli_runs_on_cpu_when_asked(no_cpu_request, tmp_path, capsys):
    cli.main(["-cpu", "-res", "16", "--steps", "2", "--output", str(tmp_path)])
    assert "Device: cpu " in capsys.readouterr().out


# --- bench.py measures the GPU only ------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["--config", "1"], ["--res", "16", "--steps", "2"]])
def test_bench_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""  # no number printed


def test_bench_make_case_builds_preset_shapes():
    for n, p in bench.PRESETS.items():
        kw = dict(p["kw"], res=16)
        cfg, scene, state = bench.make_case(**kw)
        assert state.v.shape == (2, 32, 16), n
        assert cfg.scheme == p["kw"]["scheme"]


@pytest.mark.gpu
def test_bench_on_gpu():
    """One small bench line on the card, in a process of its own."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "bench.py", "--res", "64", "--steps", "20"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["device"]["platform"] == "gpu" and row["stable"] is True
