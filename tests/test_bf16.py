"""bfloat16 transport mode (SimConfig.dtype).

The state's storage dtype is bfloat16 while all arithmetic stays
float32 — each phase upcasts on load and rounds once per phase store
(utils/dtypes.py). These tests pin the semantics on the CPU; speed is
measured on the GPU (bench.py --dtype bfloat16).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fluid2d_tpu import FluidSimulator
from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.simulator import make_run_fn, scene_for_dtype
from fluid2d_tpu.scenes.compile import get_scene
from fluid2d_tpu.state import init_state
from fluid2d_tpu.utils.metrics import diagnostics, has_nan

SCHEMES = ("upwind", "kk", "cip")


def _mk(scheme: str, dtype: str, res: int = 24, steps: int = 5):
    cfg = SimConfig.create(
        resolution=res, re=100.0, scheme=scheme, vor_eps=5.0,
        enable_dye=True, dtype=dtype,
    )
    scene = scene_for_dtype(get_scene(2, res), cfg)
    state = init_state(scene, cfg)
    state = make_run_fn(cfg)(state, scene, steps)
    return state, scene, cfg


def test_config_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="transport dtype"):
        SimConfig.create(resolution=24, dtype="float64")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_state_dtype_preserved_through_scan(scheme):
    state, _, _ = _mk(scheme, "bfloat16")
    for name, leaf in zip(state._fields, state):
        if name == "step" or leaf is None:
            continue
        assert leaf.dtype == jnp.bfloat16, name


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_tracks_f32(scheme):
    """bf16 transport only adds per-phase storage rounding: after a few
    steps the fields must track the f32 run to bf16-accumulation
    tolerance (and stay finite)."""
    s16, _, _ = _mk(scheme, "bfloat16")
    s32, _, _ = _mk(scheme, "float32")
    assert not has_nan(s16)
    for name in ("v", "p", "dye"):
        a = np.asarray(getattr(s16, name), np.float32)
        b = np.asarray(getattr(s32, name), np.float32)
        scale = max(np.abs(b).max(), 1e-3)
        err = np.abs(a - b).max() / scale
        assert err < 0.08, f"{name}: relative error {err:.4f}"


def test_bf16_simulator_end_to_end(tmp_path: Path):
    """Facade round trip: create → step → render → diagnostics →
    checkpoint → resume, all under bf16 transport."""
    sim = FluidSimulator.create(1, 24, re=100.0, scheme="cip", dtype="bfloat16")
    sim.step(4)
    assert sim.state.v.dtype == jnp.bfloat16
    assert sim.scene.bc_const.dtype == jnp.bfloat16
    rgb = sim.get_norm_field()
    assert rgb.dtype == np.float32 and np.isfinite(rgb).all()
    assert "div_rms" in diagnostics(sim.state, sim.scene, sim.cfg)

    path = tmp_path / "ckpt.npz"
    sim.save(path)
    restored = FluidSimulator.load(path, bc_num=1)
    assert restored.cfg.dtype == "bfloat16"
    assert restored.state.v.dtype == jnp.bfloat16
    # bf16 → f32 (npz) → bf16 is lossless
    np.testing.assert_array_equal(
        np.asarray(sim.state.v, np.float32), np.asarray(restored.state.v, np.float32)
    )
    restored.step(2)
    sim.step(2)
    np.testing.assert_array_equal(
        np.asarray(sim.state.v, np.float32), np.asarray(restored.state.v, np.float32)
    )


def test_bf16_field_dump_widens_to_f32():
    sim = FluidSimulator.create(1, 24, re=100.0, scheme="upwind", dtype="bfloat16")
    sim.step(2)
    fields = sim.field_to_numpy()
    assert fields["v"].dtype == np.float32
    assert fields["p"].dtype == np.float32


@pytest.mark.parametrize("path", ["gspmd", "halo"])
def test_bf16_sharded_matches_single_device(path):
    """bf16 transport under spatial decomposition: the shards hold bf16
    leaves, the ghost exchange ships bf16 rows (half the link bytes),
    and the result must track the single-device bf16 run. Tolerance is
    a few bf16 ulps: the two compilations reorder f32 arithmetic, and
    each phase-store rounding can then flip the nearest bf16."""
    from fluid2d_tpu.parallel.sharding import make_mesh, shard_pytree
    from fluid2d_tpu.utils.io import _cast_state
    from tests.test_parity import _random_fields, _seed_state

    res = 128 if path == "halo" else 32
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme="cip",
                           vor_eps=5.0, enable_dye=True, dtype="bfloat16")
    scene = scene_for_dtype(get_scene(2, res), cfg)
    fields = _random_fields(np.zeros(scene.shape, bool), True, True, seed=11)
    seed = lambda: _cast_state(  # noqa: E731 — identical bf16 start both runs
        _seed_state(init_state(scene, cfg), fields), cfg
    )

    ref = make_run_fn(cfg)(seed(), scene, 6)

    mesh = make_mesh(8)
    if path == "halo":
        from fluid2d_tpu.parallel.halo import ghost_width, make_sharded_run_halo

        assert 2 * res // 8 >= 2 * ghost_width(cfg)
        run_s = make_sharded_run_halo(cfg, mesh)
    else:
        run_s = make_run_fn(cfg)
    got = run_s(shard_pytree(seed(), mesh), shard_pytree(scene, mesh), 6)

    for name, a, b in zip(ref._fields, ref, got):
        if a is None or name == "step":
            continue
        assert b.dtype == a.dtype, name
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, atol=0.02 * scale, rtol=0, err_msg=name)


def test_dtype_is_part_of_cli_surface():
    from fluid2d_tpu.cli import build_parser

    args = build_parser().parse_args(["--dtype", "bfloat16"])
    assert args.dtype == "bfloat16"
    args = build_parser().parse_args([])
    assert not hasattr(args, "dtype")  # sentinel default (resume semantics)
