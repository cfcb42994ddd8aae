"""Scene compilation: static boundary-condition analysis → device pytree.

The reference re-derives per-cell BC behavior inside every kernel launch
with branchy neighbor tests, including *scatter* writes (a wall cell
writes ghost velocity into its deeper neighbor,
``/root/reference/fs/boundary_condition.py:16-39``) and an 8-way elif
chain for wall pressure (``:41-65``). Scenes are immutable after
construction, so this design precomputes all of it once on the
host into static masks / pattern codes; the runtime kernels become pure
branch-free gathers that XLA fuses into neighboring stencils.

Velocity ghost patterns (trigger cell is an interior wall cell, elif
priority 1→4; the *target* receives the negated mirror of the fluid cell
two cells away):

  ==  trigger condition (at wall cell t-δ)                target t  source
  1   fluid at i-1, walls at j±1                          (i+1, j)  (i-1, j)
  2   fluid at i+1, walls at j±1                          (i-1, j)  (i+1, j)
  3   fluid at j-1, walls at i±1                          (i, j+1)  (i, j-1)
  4   fluid at j+1, walls at i±1                          (i, j-1)  (i, j+1)

Pressure pattern codes (elif priority; clamped mask reads at grid edges —
see ``docs/PARITY.md`` §edge-semantics for why this matches the
reference's effective behavior):

  0 untouched   1..4 copy from (i∓1, j)/(i, j∓1)   5..8 corner averages
  9 inflow: copy from (i+1, j)                     10 outflow: 0
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = ["Scene", "compile_scene", "get_scene"]


class Scene(NamedTuple):
    """Device-resident static scene data (all leaves shaped over the grid)."""

    bc_const: jnp.ndarray  # (2, X, Y) imposed inflow velocity
    bc_dye: jnp.ndarray  # (3, X, Y) inflow dye color
    mask: jnp.ndarray  # (X, Y) uint8: 0 fluid / 1 wall / 2 inflow / 3 outflow
    fluid: jnp.ndarray  # (X, Y) bool
    wall: jnp.ndarray
    not_wall: jnp.ndarray
    inflow: jnp.ndarray
    outflow: jnp.ndarray
    odd_fluid: jnp.ndarray  # fluid & (i+j) odd — red-black SOR colors
    even_fluid: jnp.ndarray
    vbc_targets: jnp.ndarray  # (4, X, Y) bool ghost-velocity target masks
    pbc_code: jnp.ndarray  # (X, Y) int8 pressure pattern code 0..10

    @property
    def shape(self) -> tuple[int, int]:
        return self.mask.shape


def _shifted(m: np.ndarray, di: int, dj: int) -> np.ndarray:
    """m[clamp(i+di), clamp(j+dj)] with edge replication (NumPy, host)."""
    out = m
    if di:
        out = np.pad(out, ((max(-di, 0), max(di, 0)), (0, 0)), mode="edge")
        out = out[max(di, 0) : out.shape[0] - max(-di, 0), :]
    if dj:
        out = np.pad(out, ((0, 0), (max(-dj, 0), max(dj, 0))), mode="edge")
        out = out[:, max(dj, 0) : out.shape[1] - max(-dj, 0)]
    return out


def _velocity_ghost_targets(mask: np.ndarray) -> np.ndarray:
    """(4, X, Y) bool target masks for the ghost-velocity mirror writes."""
    x_res, y_res = mask.shape
    wall = mask == 1
    interior = np.zeros_like(wall)
    interior[1 : x_res - 1, 1 : y_res - 1] = True

    fl_xm = _shifted(mask, -1, 0) == 0  # fluid at (i-1, j)
    fl_xp = _shifted(mask, 1, 0) == 0
    fl_ym = _shifted(mask, 0, -1) == 0
    fl_yp = _shifted(mask, 0, 1) == 0
    wa_xm = _shifted(mask, -1, 0) == 1
    wa_xp = _shifted(mask, 1, 0) == 1
    wa_ym = _shifted(mask, 0, -1) == 1
    wa_yp = _shifted(mask, 0, 1) == 1

    base = wall & interior
    trig = np.zeros((4, x_res, y_res), dtype=bool)
    trig[0] = base & fl_xm & wa_ym & wa_yp
    trig[1] = base & ~trig[0] & fl_xp & wa_ym & wa_yp
    trig[2] = base & ~trig[0] & ~trig[1] & fl_ym & wa_xm & wa_xp
    trig[3] = base & ~trig[0] & ~trig[1] & ~trig[2] & fl_yp & wa_xm & wa_xp

    targets = np.zeros_like(trig)
    targets[0, 1:, :] = trig[0, :-1, :]  # trigger writes (i+1, j)
    targets[1, :-1, :] = trig[1, 1:, :]  # trigger writes (i-1, j)
    targets[2, :, 1:] = trig[2, :, :-1]  # trigger writes (i, j+1)
    targets[3, :, :-1] = trig[3, :, 1:]  # trigger writes (i, j-1)

    # Two triggers can target the same ghost cell (happens around circle
    # and image-mask obstacles at any resolution). The reference's parallel
    # scatter resolves such conflicts nondeterministically; we are
    # deterministic by construction — the runtime applies patterns in order
    # 1→4, so pattern 4 > 3 > 2 > 1 wins (docs/PARITY.md §2).
    return targets


def _pressure_codes(mask: np.ndarray) -> np.ndarray:
    """(X, Y) int8 pattern code per cell, honoring the reference's elif
    priority (``fs/boundary_condition.py:45-65``)."""
    fl_xm = _shifted(mask, -1, 0) == 0
    fl_xp = _shifted(mask, 1, 0) == 0
    fl_ym = _shifted(mask, 0, -1) == 0
    fl_yp = _shifted(mask, 0, 1) == 0
    wa_xm = _shifted(mask, -1, 0) == 1
    wa_xp = _shifted(mask, 1, 0) == 1
    wa_ym = _shifted(mask, 0, -1) == 1
    wa_yp = _shifted(mask, 0, 1) == 1

    conds = [
        fl_xm & wa_ym & wa_yp,  # 1: copy p(i-1, j)
        fl_xp & wa_ym & wa_yp,  # 2: copy p(i+1, j)
        fl_ym & wa_xm & wa_xp,  # 3: copy p(i, j-1)
        fl_yp & wa_xm & wa_xp,  # 4: copy p(i, j+1)
        fl_xm & fl_yp,  # 5: avg p(i-1, j), p(i, j+1)
        fl_xp & fl_yp,  # 6
        fl_xm & fl_ym,  # 7
        fl_xp & fl_ym,  # 8
    ]
    code = np.zeros(mask.shape, dtype=np.int8)
    undecided = mask == 1
    for k, cond in enumerate(conds, start=1):
        hit = undecided & cond
        code[hit] = k
        undecided &= ~hit
    code[mask == 2] = 9
    code[mask == 3] = 10
    return code


def compile_scene(bc: np.ndarray, bc_mask: np.ndarray, bc_dye: np.ndarray) -> Scene:
    """Turn raw scene arrays (reference layout: (X, Y, C)) into the
    channel-leading, device-ready Scene pytree."""
    mask = np.asarray(bc_mask, dtype=np.uint8)
    parity = (np.add.outer(np.arange(mask.shape[0]), np.arange(mask.shape[1])) % 2).astype(bool)
    fluid = mask == 0

    targets = _velocity_ghost_targets(mask)

    return Scene(
        bc_const=jnp.asarray(np.moveaxis(bc.astype(np.float32), -1, 0)),
        bc_dye=jnp.asarray(np.moveaxis(bc_dye.astype(np.float32), -1, 0)),
        mask=jnp.asarray(mask),
        fluid=jnp.asarray(fluid),
        wall=jnp.asarray(mask == 1),
        not_wall=jnp.asarray(mask != 1),
        inflow=jnp.asarray(mask == 2),
        outflow=jnp.asarray(mask == 3),
        odd_fluid=jnp.asarray(fluid & parity),
        even_fluid=jnp.asarray(fluid & ~parity),
        vbc_targets=jnp.asarray(targets),
        pbc_code=jnp.asarray(_pressure_codes(mask)),
    )


def get_scene(num: int, resolution: int, mask_image=None) -> Scene:
    """Build and compile built-in scene `num` (1..6) at y-resolution
    `resolution` (parity surface: ``get_boundary_condition``,
    ``fs/boundary_condition.py:201-219``). `mask_image` (path or bundled
    asset name "dragon"/"rabbit"/"aircraft") swaps in a custom obstacle
    silhouette scene."""
    from fluid2d_tpu.scenes.scenes import build_scene_arrays

    return compile_scene(*build_scene_arrays(num, resolution, mask_image=mask_image))
