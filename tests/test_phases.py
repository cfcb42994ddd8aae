"""Each jnp phase of the step against the matching phase of the scalar
oracle (tests/oracle.py), and the bf16 transport's rounding points.

The phases are what a hand-written kernel would replace, so each is
pinned on its own: velocity (MAC and CIP), dye (MAC and CIP), vorticity
confinement, the SOR and Jacobi pressure solves, and the velocity
limiter — over every scene and scheme, on grids whose sides are not
multiples of 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.cip import cip_dye_phase, cip_velocity_phase
from fluid2d_tpu.models.common import confinement, update_pressure, update_pressure_and_limit
from fluid2d_tpu.models.mac import mac_dye_phase, mac_velocity_phase
from fluid2d_tpu.models.simulator import scene_for_dtype
from fluid2d_tpu.ops.limiters import limit_vector_norm
from fluid2d_tpu.scenes.compile import compile_scene
from fluid2d_tpu.scenes.scenes import build_scene_arrays
from fluid2d_tpu.state import init_state
from fluid2d_tpu.utils.io import _cast_state
from tests.oracle import Oracle
from tests.test_parity import _cmp, _random_fields, _seed_oracle, _seed_state

RES = 13  # grid (26, 13): neither side a multiple of 8
SCENES = [1, 2, 3, 4, 5, 6]
SCHEMES = ["upwind", "kk", "cip"]


def _setup(num, scheme, *, res=RES, seed=0, pressure_solver="sor", v_scale=1.0):
    """Scene, config, seeded JAX state and an oracle seeded identically."""
    bc, mask, dye = build_scene_arrays(num, res)
    cfg = SimConfig.create(resolution=res, re=1000.0, scheme=scheme, vor_eps=5.0,
                           enable_dye=True, pressure_solver=pressure_solver)
    fields = _random_fields(mask, True, scheme == "cip", seed)
    fields["v"] = fields["v"] * np.float32(v_scale)
    scene = compile_scene(bc, mask, dye)
    state = _seed_state(init_state(scene, cfg), fields)
    orc = Oracle(bc, mask, dye, dt=cfg.dt, dx=cfg.dx, re=cfg.re, scheme=scheme,
                 vor_eps=cfg.vor_eps, enable_dye=True, pressure_solver=pressure_solver,
                 omega=cfg.sor_omega, n_iter=cfg.n_pressure_iter)
    _seed_oracle(orc, fields)
    return cfg, scene, state, orc


def _cmp_all(pairs):
    for name, got, want in pairs:
        _cmp(name, got, want)


def _velocity(scheme, num, res=RES):
    cfg, scene, state, orc = _setup(num, scheme, res=res, seed=num)
    if scheme == "cip":
        v, vx, vy, v_alt, vx_alt, vy_alt = cip_velocity_phase(state, scene, cfg)
        orc.cip_velocity_phase()
        _cmp_all([("v", v, orc.v.cur), ("vx", vx, orc.vx.cur), ("vy", vy, orc.vy.cur),
                  ("v_alt", v_alt, orc.v.nxt), ("vx_alt", vx_alt, orc.vx.nxt),
                  ("vy_alt", vy_alt, orc.vy.nxt)])
    else:
        v, v_alt = mac_velocity_phase(state, scene, cfg)
        orc.mac_velocity_phase()
        _cmp_all([("v", v, orc.v.cur), ("v_alt", v_alt, orc.v.nxt)])


@pytest.mark.parametrize("num", SCENES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_velocity_phase_matches_oracle(scheme, num):
    _velocity(scheme, num)


@pytest.mark.parametrize("res", [12, 15, 20])
def test_cip_velocity_phase_grid_sizes(res):
    """Grids (24, 12), (30, 15), (40, 20): odd widths and rows that no
    8-row tile divides."""
    _velocity("cip", 1, res=res)


@pytest.mark.parametrize("num", SCENES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dye_phase_matches_oracle(scheme, num):
    """Dye carried by the seeded current velocity (the limited velocity
    in a full step)."""
    cfg, scene, state, orc = _setup(num, scheme, seed=10 + num)
    if scheme == "cip":
        dye, dyex, dyey, d_alt, dx_alt, dy_alt = cip_dye_phase(state, state.v, scene, cfg)
        orc.cip_dye_phase()
        _cmp_all([("dye", dye, orc.dye.cur), ("dyex", dyex, orc.dyex.cur),
                  ("dyey", dyey, orc.dyey.cur), ("dye_alt", d_alt, orc.dye.nxt),
                  ("dyex_alt", dx_alt, orc.dyex.nxt), ("dyey_alt", dy_alt, orc.dyey.nxt)])
    else:
        dye, d_alt = mac_dye_phase(state, state.v, scene, cfg)
        orc.mac_dye_phase()
        _cmp_all([("dye", dye, orc.dye.cur), ("dye_alt", d_alt, orc.dye.nxt)])


@pytest.mark.parametrize("num", SCENES)
def test_confinement_matches_oracle(num):
    cfg, scene, state, orc = _setup(num, "upwind", seed=20 + num)
    v, v_alt = confinement(state.v, state.v_alt, scene, cfg)
    orc.apply_confinement()
    _cmp_all([("v", v, orc.v.cur), ("v_alt", v_alt, orc.v.nxt)])


@pytest.mark.parametrize("num", SCENES)
@pytest.mark.parametrize("solver", ["sor", "jacobi"])
def test_pressure_matches_oracle(solver, num):
    cfg, scene, state, orc = _setup(num, "upwind", seed=30 + num, pressure_solver=solver)
    p, p_alt = update_pressure(state.p, state.p_alt, state.v, scene, cfg)
    orc.update_pressure(orc.v.cur)
    _cmp_all([("p", p, orc.p.cur), ("p_alt", p_alt, orc.p.nxt)])


@pytest.mark.parametrize("res", [13, 20])
def test_limiter_matches_oracle(res):
    """Velocities scaled so that part of the grid exceeds the limit."""
    cfg, _, state, orc = _setup(1, "upwind", res=res, seed=40, v_scale=40.0)
    assert float(jnp.sqrt((state.v ** 2).sum(0)).max()) > cfg.velocity_limit
    v = limit_vector_norm(state.v, cfg.velocity_limit)
    orc.limit_field()
    _cmp("v", v, orc.v.cur)


# --- bf16 transport: upcast on load, round once at the phase outputs --------

def _phase_outputs(phase, state, scene, cfg):
    if phase in ("mac_velocity-upwind", "mac_velocity-kk"):
        return mac_velocity_phase(state, scene, cfg)
    if phase == "cip_velocity":
        return cip_velocity_phase(state, scene, cfg)
    if phase in ("mac_dye-upwind", "mac_dye-kk"):
        return mac_dye_phase(state, state.v, scene, cfg)
    if phase == "cip_dye":
        return cip_dye_phase(state, state.v, scene, cfg)
    if phase == "confinement":
        return confinement(state.v, state.v_alt, scene, cfg)
    if phase in ("pressure-sor", "pressure-jacobi"):
        return update_pressure(state.p, state.p_alt, state.v, scene, cfg)
    assert phase == "pressure_and_limit"
    return update_pressure_and_limit(state.p, state.p_alt, state.v, scene, cfg)


@pytest.mark.parametrize("phase", [
    "mac_velocity-upwind", "mac_velocity-kk", "cip_velocity",
    "mac_dye-upwind", "mac_dye-kk", "cip_dye", "confinement",
    "pressure-sor", "pressure-jacobi", "pressure_and_limit",
])
def test_bf16_phase_rounds_float32_result(phase):
    """A bf16-transport phase equals the float32 phase run on the same
    (upcast) values, rounded once to bf16 at its outputs: the same
    float32 arithmetic, no rounding in between."""
    scheme = phase.split("-")[1] if "-" in phase and phase.startswith("mac") else (
        "cip" if phase.startswith("cip") else "upwind")
    solver = "jacobi" if phase == "pressure-jacobi" else "sor"
    bc, mask, dye = build_scene_arrays(2, RES)
    fields = _random_fields(mask, True, scheme == "cip", seed=50)
    kw = dict(resolution=RES, re=1000.0, scheme=scheme, vor_eps=5.0, enable_dye=True,
              pressure_solver=solver)
    cfg16 = SimConfig.create(dtype="bfloat16", **kw)
    cfg32 = SimConfig.create(dtype="float32", **kw)
    scene16 = scene_for_dtype(compile_scene(bc, mask, dye), cfg16)
    scene32 = scene16._replace(bc_const=scene16.bc_const.astype(jnp.float32),
                               bc_dye=scene16.bc_dye.astype(jnp.float32))
    s16 = _cast_state(_seed_state(init_state(scene16, cfg16), fields), cfg16)
    s32 = _cast_state(s16, cfg32)  # exact upcast of the bf16 values

    got = _phase_outputs(phase, s16, scene16, cfg16)
    want = _phase_outputs(phase, s32, scene32, cfg32)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == jnp.bfloat16, (phase, i, g.dtype)
        np.testing.assert_array_equal(
            np.asarray(g, np.float32), np.asarray(w.astype(jnp.bfloat16), np.float32),
            err_msg=f"{phase} output {i}")
