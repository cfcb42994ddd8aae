"""Simulator façade: API-surface parity with the reference + additions."""

from pathlib import Path

import numpy as np
import pytest

from fluid2d_tpu import FluidSimulator
from fluid2d_tpu.utils.metrics import diagnostics, divergence, has_nan
from fluid2d_tpu.utils.viz import visualize_hue, visualize_xy


@pytest.fixture(scope="module")
def sim():
    s = FluidSimulator.create(1, 24, re=100.0, scheme="cip", enable_dye=True)
    s.step(5)
    return s


def test_render_modes(sim):
    for getter in (sim.get_norm_field, sim.get_pressure_field,
                   sim.get_vorticity_field, sim.get_dye_field):
        rgb = getter()
        assert rgb.shape == (48, 24, 3)
        assert np.isfinite(rgb).all()
    # walls painted the reference's (0.5, 0.7, 0.5)
    wall = np.asarray(sim.scene.wall)
    rgb = sim.get_norm_field()
    expected = np.tile(np.array([0.5, 0.7, 0.5], np.float32), (int(wall.sum()), 1))
    np.testing.assert_allclose(rgb[wall], expected, atol=1e-6)


def test_field_dump_layout(sim):
    fields = sim.field_to_numpy()
    assert fields["v"].shape == (48, 24, 2)
    assert fields["p"].shape == (48, 24)
    assert fields["dye"].shape == (48, 24, 3)


def test_checkpoint_roundtrip(tmp_path: Path, sim):
    path = tmp_path / "ckpt.npz"
    sim.save(path)
    restored = FluidSimulator.load(path, bc_num=1)
    assert restored.step_count == sim.step_count
    for a, b in zip(sim.state, restored.state):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resumed stepping continues identically
    sim2 = FluidSimulator.load(path, bc_num=1)
    sim2.step(3)
    restored.step(3)
    np.testing.assert_array_equal(np.asarray(sim2.state.v), np.asarray(restored.state.v))


def test_load_bc_override_replaces_stored_mask_scene(tmp_path: Path):
    """An explicit bc_num override on load must NOT inherit the stored
    mask image: get_scene short-circuits on mask_image before reading
    bc_num, so inheriting it would silently keep the old obstacles."""
    sim = FluidSimulator.create(1, 36, re=100.0, mask_image="dragon")
    path = tmp_path / "ckpt.npz"
    sim.save(path)

    restored = FluidSimulator.load(path, bc_num=2)
    assert restored.scene_meta == {"bc_num": 2, "mask_image": None}
    assert not np.array_equal(
        np.asarray(restored.scene.mask), np.asarray(sim.scene.mask)
    )
    # Without an override the stored identity (dragon) is restored.
    inherited = FluidSimulator.load(path)
    assert inherited.scene_meta["mask_image"] == "dragon"
    np.testing.assert_array_equal(
        np.asarray(inherited.scene.mask), np.asarray(sim.scene.mask)
    )


@pytest.mark.parametrize("old_keys", [{"kernels": "pallas", "sor_fuse": 2},
                                      {"kernels": "auto"}])
def test_old_checkpoint_with_kernel_keys_loads(tmp_path: Path, sim, old_keys):
    """Checkpoints written while SimConfig still had the kernel-path
    selectors (`kernels`, `sor_fuse`) load; the keys are dropped."""
    import json

    path = tmp_path / "ckpt.npz"
    sim.save(path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__config__"].tobytes()).decode())
    meta["config"].update(old_keys)
    arrays["__config__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)

    restored = FluidSimulator.load(path)
    assert restored.cfg == sim.cfg
    assert restored.step_count == sim.step_count
    np.testing.assert_array_equal(np.asarray(restored.state.v), np.asarray(sim.state.v))
    restored.step(2)
    assert np.isfinite(np.asarray(restored.state.v)).all()


def test_orbax_checkpoint_roundtrip(tmp_path: Path, sim):
    """Directory path → orbax backend (per-shard writes for sharded runs)."""
    path = tmp_path / "ckpt_dir"
    sim.save(path)
    restored = FluidSimulator.load(path, bc_num=1)
    assert restored.step_count == sim.step_count
    np.testing.assert_array_equal(np.asarray(restored.state.v), np.asarray(sim.state.v))
    np.testing.assert_array_equal(np.asarray(restored.state.dyex), np.asarray(sim.state.dyex))


def test_reset(sim):
    s = FluidSimulator.create(1, 24, re=100.0, scheme="upwind", enable_dye=False)
    s.step(3)
    assert float(np.abs(np.asarray(s.state.v)).max()) > 0
    s.reset()
    assert s.step_count == 0
    assert float(np.abs(np.asarray(s.state.v)).max()) == 0


def test_screenshot(tmp_path: Path, sim):
    out = tmp_path / "shot.png"
    sim.screenshot(out, vis=0)
    from PIL import Image

    im = Image.open(out)
    assert im.size == (48, 24)  # (W=X, H=Y) in screen orientation


def test_no_dye_simulator_rejects_dye_vis():
    s = FluidSimulator.create(1, 24, enable_dye=False, scheme="upwind")
    with pytest.raises(ValueError, match="dye"):
        s.get_dye_field()


def test_metrics(sim):
    d = diagnostics(sim.state, sim.scene, sim.cfg)
    assert "div_rms=" in d and "max|v|=" in d
    assert not has_nan(sim.state)
    div = divergence(sim.state.v, sim.cfg.dx)
    assert div.shape == (48, 24)


def test_unused_colormaps():
    """visualize_hue / visualize_xy — kept for reference library parity
    (fs/visualization.py:26-56)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((2, 8, 8)).astype(np.float32) * 3
    hue = np.asarray(visualize_hue(v))
    assert hue.shape == (8, 8, 3)
    assert (hue >= 0).all() and (hue <= 1).all()
    xy = np.asarray(visualize_xy(v))
    np.testing.assert_array_equal(xy[..., 0], v[1])
    np.testing.assert_array_equal(xy[..., 2], v[0])
    np.testing.assert_array_equal(xy[..., 1], 0)
