"""Sharded ≡ single-device equivalence on the 8-virtual-device CPU mesh
(SURVEY.md §4.4): spatial domain decomposition must not change results
beyond FP reduction reordering (here: bitwise, since steps contain no
cross-shard reductions — only halo-exchange reads)."""

import jax
import numpy as np
import pytest

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.simulator import make_run_fn, step_fn_for
from fluid2d_tpu.parallel.sharding import make_mesh, shard_pytree
from fluid2d_tpu.scenes.compile import get_scene
from fluid2d_tpu.scenes.scenes import build_scene_arrays
from fluid2d_tpu.state import init_state
from tests.test_parity import _random_fields, _seed_state


@pytest.mark.parametrize("scheme", ["kk", "cip"])
def test_sharded_matches_single_device(scheme):
    res = 32  # grid (64, 32): X=64 divides 8
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme=scheme,
                           vor_eps=5.0, enable_dye=True)
    _, mask, _ = build_scene_arrays(2, res)
    scene = get_scene(2, res)
    # Smooth random init: avoids the vorticity-confinement 0/0 NaN branch,
    # whose discontinuity amplifies FP reordering to O(0.1) (PARITY.md §4)
    # — single- vs multi-device fusion boundaries reorder FP like any
    # other recompilation would.
    fields = _random_fields(mask, True, scheme == "cip", seed=11)
    state = _seed_state(init_state(scene, cfg), fields)
    run = make_run_fn(cfg)

    ref = run(state, scene, 8)

    mesh = make_mesh(8)
    state_s = shard_pytree(_seed_state(init_state(scene, cfg), fields), mesh)
    scene_s = shard_pytree(scene, mesh)
    got = run(state_s, scene_s, 8)

    for name, a, b in zip(ref._fields, ref, got):
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)


def test_sharded_2d_mesh_matches_single_device():
    """Two-axis (4×2 mesh) GSPMD decomposition ≡ single device: XLA
    derives halo exchange on BOTH grid axes from the shifted-slice
    reads. The layout for chip counts where 1-D X slabs would get
    thinner than the stencil ghost depth."""
    res = 32
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme="cip",
                           vor_eps=5.0, enable_dye=True)
    _, mask, _ = build_scene_arrays(2, res)
    scene = get_scene(2, res)
    fields = _random_fields(mask, True, True, seed=12)
    state = _seed_state(init_state(scene, cfg), fields)
    run = make_run_fn(cfg)

    ref = run(state, scene, 8)

    mesh = make_mesh(shape=(4, 2))
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"x": 4, "y": 2}
    state_s = shard_pytree(_seed_state(init_state(scene, cfg), fields), mesh)
    scene_s = shard_pytree(scene, mesh)
    # Grid (64, 32): both axes divisible → leaves are sharded on both.
    assert "y" in str(state_s.v.sharding.spec)
    got = run(state_s, scene_s, 8)

    for name, a, b in zip(ref._fields, ref, got):
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("scheme", ["cip", "kk"])
def test_halo_exchange_run_matches_single_device(scheme, n_dev):
    """Explicit shard_map + ppermute ghost-window path (parallel/halo.py)
    vs the single-device run on 2, 4 and 8 devices: one neighbor exchange
    per step, shifted windows at the mesh ends, redundant ghost-zone
    compute."""
    from fluid2d_tpu.parallel.halo import ghost_width, make_sharded_run_halo

    res = 128  # grid (256, 128): X_loc ≥ 32 ≥ 2·ghost_width
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme=scheme,
                           vor_eps=5.0, enable_dye=True)
    assert 256 // n_dev >= 2 * ghost_width(cfg)
    _, mask, _ = build_scene_arrays(2, res)
    scene = get_scene(2, res)
    fields = _random_fields(mask, True, scheme == "cip", seed=7)

    ref = make_run_fn(cfg)(
        _seed_state(init_state(scene, cfg), fields), scene, 6
    )
    mesh = make_mesh(n_dev)
    run_h = make_sharded_run_halo(cfg, mesh)
    got = run_h(
        shard_pytree(_seed_state(init_state(scene, cfg), fields), mesh),
        shard_pytree(scene, mesh),
        6,
    )
    for name, a, b in zip(ref._fields, ref, got):
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("scheme", ["cip", "kk"])
def test_halo_2d_mesh_matches_single_device(scheme):
    """Two-axis ghost-window decomposition: a 4×2
    ("x", "y") mesh with one row exchange + one row-extended column
    exchange per step (corners ride the y links) must reproduce the
    single-device run."""
    from fluid2d_tpu.parallel.halo import ghost_width, make_sharded_run_halo

    res = 128  # grid (256, 128): X_loc=64, Y_loc=64 ≥ 2·ghost_width
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme=scheme,
                           vor_eps=5.0, enable_dye=True)
    h = ghost_width(cfg)
    assert 256 // 4 >= 2 * h and 128 // 2 >= 2 * h
    _, mask, _ = build_scene_arrays(2, res)
    scene = get_scene(2, res)
    fields = _random_fields(mask, True, scheme == "cip", seed=21)

    ref = make_run_fn(cfg)(
        _seed_state(init_state(scene, cfg), fields), scene, 5
    )
    mesh = make_mesh(shape=(4, 2))
    run_h = make_sharded_run_halo(cfg, mesh)
    got = run_h(
        shard_pytree(_seed_state(init_state(scene, cfg), fields), mesh),
        shard_pytree(scene, mesh),
        5,
    )
    for name, a, b in zip(ref._fields, ref, got):
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)


def test_shard_simulator_routes_2d_mesh_to_halo():
    """`--shard-mesh 4x2` routes to the 2-D ghost-window path (not the
    GSPMD fallback) when both axes' slabs fit the ghost depth."""
    from fluid2d_tpu.models.simulator import FluidSimulator
    from fluid2d_tpu.parallel.sharding import shard_simulator

    ref = FluidSimulator.create(1, 128, scheme="upwind", vor_eps=None)
    ref.step(3)

    sim = FluidSimulator.create(1, 128, scheme="upwind", vor_eps=None)
    shard_simulator(sim, mesh_shape=(4, 2))
    assert sim.shard_path == "halo"
    sim.step(3)
    a, b = np.asarray(ref.state.v), np.asarray(sim.state.v)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_sharded_output_keeps_sharding():
    res = 32
    cfg = SimConfig.create(resolution=res, scheme="upwind", vor_eps=None, enable_dye=False)
    scene = get_scene(1, res)
    mesh = make_mesh(8)
    state = shard_pytree(init_state(scene, cfg), mesh)
    scene_s = shard_pytree(scene, mesh)
    out = jax.jit(step_fn_for(cfg))(state, scene_s)
    shard_counts = {len(out.v.sharding.device_set)}
    assert shard_counts == {8}, out.v.sharding


def test_shard_simulator_routes_to_halo():
    """CLI --shard routing: a grid with room for the
    ghost slabs takes the halo path and still matches the
    single-device run."""
    from fluid2d_tpu.models.simulator import FluidSimulator
    from fluid2d_tpu.parallel.sharding import shard_simulator

    res = 128  # X=256 → 32-row slabs on 8 devices ≥ 2·ghost_width(=16)
    ref = FluidSimulator.create(1, res, scheme="upwind", vor_eps=None)
    ref.step(3)

    sim = FluidSimulator.create(1, res, scheme="upwind", vor_eps=None)
    shard_simulator(sim, 8)
    assert sim.shard_path == "halo"
    sim.step(3)
    a, b = np.asarray(ref.state.v), np.asarray(sim.state.v)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_shard_simulator_falls_back_to_gspmd():
    """Too-small grids fall back to GSPMD (and say so via shard_path)."""
    from fluid2d_tpu.models.simulator import FluidSimulator
    from fluid2d_tpu.parallel.sharding import shard_simulator

    sim = FluidSimulator.create(1, 32, scheme="upwind", vor_eps=None)
    shard_simulator(sim, 8)  # X=64 → 8-row slabs < 2·ghost_width
    assert sim.shard_path == "gspmd"
    sim.step(2)
    assert not np.isnan(np.asarray(sim.state.v)).any()


def test_exchange_ships_h_rows_per_link():
    """Guard: the ghost exchange ships exactly h rows
    per link per direction (two ppermutes of (h, Y) slabs and nothing
    more). The end
    windows pad with replicated filler instead of a second real strip."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from fluid2d_tpu.parallel.halo import AXIS, exchange_ghosts

    h, n_dev = 16, 8
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (AXIS,))
    x = jnp.zeros((256, 64))

    jaxpr = jax.make_jaxpr(
        shard_map(lambda a: exchange_ghosts(a, h, n_dev), mesh=mesh,
                  in_specs=(P(AXIS, None),), out_specs=P(AXIS, None),
                  check_vma=False)
    )(x)
    inner = jaxpr.jaxpr.eqns[0].params["jaxpr"]
    pperms = [e for e in inner.eqns if e.primitive.name == "ppermute"]
    assert len(pperms) == 2
    for e in pperms:
        assert e.invars[0].aval.shape == (h, 64), e.invars[0].aval.shape
