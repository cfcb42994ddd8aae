"""utils/profiling: the step's byte floor, trace capture, device record."""

import numpy as np

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.utils import profiling


def test_step_min_bytes_ordering():
    """The floor grows with enabled features and is strictly positive."""
    base = SimConfig.create(resolution=64, scheme="upwind", vor_eps=None, enable_dye=False)
    dye = SimConfig.create(resolution=64, scheme="upwind", vor_eps=None, enable_dye=True)
    cip = SimConfig.create(resolution=64, scheme="cip", vor_eps=5.0, enable_dye=True)
    b0 = profiling.step_min_bytes(base, 128, 64)
    b1 = profiling.step_min_bytes(dye, 128, 64)
    b2 = profiling.step_min_bytes(cip, 128, 64)
    assert 0 < b0 < b1 < b2


def test_trace_context_writes_profile(tmp_path):
    """jax.profiler capture around a block produces trace artifacts."""
    import jax.numpy as jnp

    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        float(np.asarray(jnp.arange(8.0).sum()))
    files = list(log_dir.rglob("*"))
    assert any(f.is_file() for f in files)


def test_step_min_bytes_halves_with_bf16_transport():
    f32 = SimConfig.create(resolution=64, scheme="cip", dtype="float32")
    bf16 = SimConfig.create(resolution=64, scheme="cip", dtype="bfloat16")
    assert profiling.step_min_bytes(f32, 128, 64) == 2 * profiling.step_min_bytes(bf16, 128, 64)


def test_time_steps_returns_positive_seconds_per_step():
    from fluid2d_tpu.models.simulator import make_run_fn
    from fluid2d_tpu.scenes.compile import get_scene
    from fluid2d_tpu.state import init_state

    cfg = SimConfig.create(resolution=16, scheme="upwind", enable_dye=False)
    scene = get_scene(1, 16)
    sec, state = profiling.time_steps(make_run_fn(cfg), init_state(scene, cfg), scene, 4)
    assert sec > 0
    assert int(state.step) == 8  # warm-up call + timed call


def test_device_info_names_the_device():
    info = profiling.device_info()
    assert info["platform"] == "cpu"
    assert info["count"] >= 1
    assert set(info) == {"platform", "device_kind", "count", "gpu_name", "power_limit"}
