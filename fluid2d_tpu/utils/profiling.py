"""Performance measurement helpers: step timing, the step's byte floor,
trace capture, and the device a number was taken on."""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax
import jax.numpy as jnp

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.state import SimState

__all__ = ["sync", "time_steps", "step_min_bytes", "trace", "device_info"]


def sync(state: SimState) -> None:
    """Wait until every leaf of `state` is computed."""
    jax.block_until_ready(state)


def time_steps(run, state, scene, n: int) -> tuple[float, SimState]:
    """Seconds per step for a compiled `run(state, scene, n)`; compiles
    on a warmup call with the same static n."""
    state = run(state, scene, n)
    sync(state)
    t0 = time.perf_counter()
    state = run(state, scene, n)
    sync(state)
    return (time.perf_counter() - t0) / n, state


def step_min_bytes(cfg: SimConfig, x_rows: int, y_cols: int) -> int:
    """Lower bound on device-memory bytes one step must move: every
    carried array written once + each phase's inputs read once."""
    cell = x_rows * y_cols * jnp.dtype(cfg.dtype).itemsize
    if cfg.scheme == "cip":
        writes = 2 * 6  # v/vx/vy cur+na
        reads = 2 * 7 + 1  # v, p, v_alt, grads+alts, masks-ish
    else:
        writes = 2 * 2
        reads = 2 * 3 + 1
    if cfg.vor_eps is not None:
        writes += 2
        reads += 2
    # pressure: per iteration read p, p_alt, u, w; write pn, pc
    writes += 2 * cfg.n_pressure_iter
    reads += 4 * cfg.n_pressure_iter
    writes += 2  # limiter
    reads += 2
    if cfg.enable_dye:
        chans = 3
        if cfg.scheme == "cip":
            writes += chans * 6
            reads += chans * 6 + 2
        else:
            writes += chans * 2
            reads += chans * 2 + 2
    return (writes + reads) * cell


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace capture around a block (view with TensorBoard
    or xprof, or read with ``jax.profiler.ProfileData``)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_info() -> dict:
    """The device numbers are taken on: JAX's platform, kind and count,
    plus the first card's name and power limit as ``nvidia-smi`` reports
    them (``None`` where there is no ``nvidia-smi``)."""
    dev = jax.devices()[0]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    name, _, limit = out[0].rpartition(", ") if out else (None, None, None)
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "gpu_name": name or None,
        "power_limit": limit or None,
    }
