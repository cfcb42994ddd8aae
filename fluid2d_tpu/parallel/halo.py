"""Explicit halo-exchange scaling path (shard_map + lax.ppermute).

The GSPMD path (:mod:`fluid2d_tpu.parallel.sharding`) lets XLA insert a
collective per shifted read — correct, but one small transfer per
stencil op. This module implements the classic **ghost-zone redundant
compute** design instead: each device owns a grid slab extended by H
ghost rows per side; ONE neighbor exchange per time step refreshes the
ghosts, the whole unmodified step function runs on the extended slab, and the ghost rows are sliced off. Cells
within the ghost region compute polluted values (the slab edge clamps
like a global edge), but the pollution reaches at most the step's total
stencil depth — H is chosen above it — so every interior row is exactly
what a single-device run produces.

Stencil-depth accounting per step (rows of influence):
  velocity BC (±2) → non-advection (±1) → gradients (±1) → CIP advection
  (±1) = 5; vorticity confinement +2; each SOR iteration +3 (BC + odd +
  even). Dye chain ≤ that of velocity. With the default 2 SOR iterations
  the depth is 13; H rounds up to a multiple of 8.

The exchange itself is a pair of ``lax.ppermute`` shifts of H-row slabs
over each mesh axis — contiguous neighbor traffic, exactly the
communication pattern a spatially-decomposed stencil code wants. Each
link carries exactly H rows per direction per exchanged array; the
shifted end-windows pad their far side with replicated filler instead
of a second real strip (see :func:`exchange_ghosts`).

Both 1-D ``("x",)`` and 2-D ``("x", "y")`` meshes are supported:
on a 2-D mesh the row exchange runs first and the
column exchange ships the already row-extended slabs, so the corner
ghosts arrive via the y-neighbor (whose row extension already contains
the diagonal shard's rows) — two sequential 1-D exchanges, no separate
corner messages.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.scenes.compile import Scene
from fluid2d_tpu.state import SimState

__all__ = ["ghost_width", "exchange_ghosts", "make_sharded_run_halo"]

AXIS = "x"


def ghost_width(cfg: SimConfig) -> int:
    """Ghost rows per side: the step's stencil-depth bound rounded up to
    a multiple of 8."""
    depth = 5  # BC(2) + non-advection(1) + gradients(1) + advection(1)
    if cfg.vor_eps is not None:
        depth += 2
    depth += 3 * cfg.n_pressure_iter
    return 8 * math.ceil(depth / 8)


def _is_grid_leaf(leaf) -> bool:
    return getattr(leaf, "ndim", 0) >= 2


def _dslice(a, lo: int, size: int, dim: int):
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(lo, lo + size)
    return a[tuple(idx)]


def exchange_ghosts(arr, h: int, n_dev: int, axis_name: str = AXIS,
                    dim: int = -2):
    """Inside shard_map: build each shard's working window — the owned
    slab extended by `h` neighbor rows per side along `dim` — via
    ``ppermute`` over mesh axis `axis_name`.

    Every link ships exactly **h rows per direction**. The window is row-SHIFTED at the mesh
    ends: shard 0's window starts at the true global row 0, so the
    step's clamp-to-edge at the slab boundary coincides with the REAL
    global edge. The h window rows beyond shard 0's real ghosts are
    FILLER (the outermost received row replicated): they only feed
    window cells that are themselves ghost output — filler contamination
    travels at stencil speed, ≤ depth ≤ h rows per step
    (:func:`ghost_width` guarantees h ≥ the step's stencil depth), so it
    never reaches an owned row before the strip. The last shard mirrors
    this. Use :func:`window_offset` to locate the owned rows.

    The three window layouts are built under ``lax.switch`` so each
    device materializes ONE concatenation, not three selected variants
    (a where-select of all three would pay 3× the concatenation
    traffic, which bites at small slabs).
    """
    dim = dim % arr.ndim
    n = arr.shape[dim]
    idx = jax.lax.axis_index(axis_name)
    top = _dslice(arr, 0, h, dim)  # sent downward (to idx-1)
    bot = _dslice(arr, n - h, h, dim)  # sent upward (to idx+1)
    from_prev = jax.lax.ppermute(bot, axis_name, [(i, i + 1) for i in range(n_dev - 1)])
    from_next = jax.lax.ppermute(top, axis_name, [(i + 1, i) for i in range(n_dev - 1)])

    def rep(strip, lo: int):
        row = _dslice(strip, lo, 1, dim)
        shape = list(strip.shape)
        shape[dim] = h
        return jnp.broadcast_to(row, shape)

    def first():  # rows [0, L+h) + filler
        return jnp.concatenate([arr, from_next, rep(from_next, h - 1)], axis=dim)

    def mid():
        return jnp.concatenate([from_prev, arr, from_next], axis=dim)

    def last():  # filler + rows [X-L-h, X)
        return jnp.concatenate([rep(from_prev, 0), from_prev, arr], axis=dim)

    pos = (idx > 0).astype(jnp.int32) + (idx == n_dev - 1).astype(jnp.int32)
    return jax.lax.switch(pos, [first, mid, last])


def window_offset(h: int, n_dev: int, axis_name: str = AXIS):
    """Offset of the owned slab inside its working window along one axis."""
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == 0, 0, jnp.where(idx == n_dev - 1, 2 * h, h))


def _mesh_axes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_sharded_run_halo(cfg: SimConfig, mesh: Mesh, h: int | None = None):
    """(state, scene, n) → state over `n` steps with ONE explicit ghost
    exchange per step per decomposed axis. `state` is sharded along X
    (and Y, on a 2-D ``("x", "y")`` mesh) over `mesh`; `scene` may be
    sharded or replicated (it is gathered into per-shard ghost-extended
    slabs once, outside the time loop).

    Equivalent to the single-device run up to FP reordering.
    """
    from fluid2d_tpu.models.simulator import make_run_fn, step_fn_for

    step = step_fn_for(cfg)
    axes = _mesh_axes(mesh)
    n_x = axes.get("x", 1)
    n_y = axes.get("y", 1)
    if mesh.devices.size == 1:
        return make_run_fn(cfg)  # no decomposition — plain single-device run
    if h is None:
        h = ghost_width(cfg)

    def extend(tree):
        if n_x > 1:
            tree = jax.tree.map(
                lambda a: exchange_ghosts(a, h, n_x, "x", -2) if _is_grid_leaf(a) else a,
                tree,
            )
        if n_y > 1:
            # Ships the row-extended slabs → corners ride the y links.
            tree = jax.tree.map(
                lambda a: exchange_ghosts(a, h, n_y, "y", -1) if _is_grid_leaf(a) else a,
                tree,
            )
        return tree

    def strip(tree, x_loc: int, y_loc: int):
        def one(a):
            if not _is_grid_leaf(a):
                return a
            if n_x > 1:
                a = jax.lax.dynamic_slice_in_dim(
                    a, window_offset(h, n_x, "x"), x_loc, axis=a.ndim - 2
                )
            if n_y > 1:
                a = jax.lax.dynamic_slice_in_dim(
                    a, window_offset(h, n_y, "y"), y_loc, axis=a.ndim - 1
                )
            return a

        return jax.tree.map(one, tree)

    def shard_body(state_slab: SimState, scene_ext: Scene, n: int) -> SimState:
        x_loc, y_loc = state_slab.p.shape[-2:]

        def one(st):
            out = step(extend(st), scene_ext)
            return strip(out, x_loc, y_loc)

        # Two steps per scan iteration, like make_run_fn: the (cur, alt)
        # buffer roles swap each step, so a 2-step body keeps the
        # while-carry slot assignment the identity.
        def body(st, _):
            return one(one(st)), None

        pairs, rem = divmod(n, 2)
        if pairs:
            state_slab, _ = jax.lax.scan(body, state_slab, None, length=pairs)
        if rem:
            state_slab = one(state_slab)
        return state_slab

    x_name = "x" if n_x > 1 else None
    y_name = "y" if n_y > 1 else None
    grid_spec = lambda leaf: P(  # noqa: E731
        *([None] * (leaf.ndim - 2)), x_name, y_name
    )

    def specs_for(tree):
        return jax.tree.map(
            lambda leaf: grid_spec(leaf) if _is_grid_leaf(leaf) else P(), tree
        )

    @functools.partial(jax.jit, static_argnums=2)
    def run(state: SimState, scene: Scene, n: int) -> SimState:
        # Each axis's divisibility/ghost-depth constraint applies only
        # when that axis is actually decomposed (n>1): an undecomposed
        # axis exchanges nothing, so e.g. a 1-D x-mesh on a grid with
        # Y < 2h still runs on the halo path.
        x_rows, y_cols = state.p.shape[-2:]
        if n_x > 1 and (x_rows % n_x != 0 or x_rows // n_x < 2 * h):
            msg = (
                f"grid X={x_rows} must split into ≥{2 * h}-row slabs "
                f"across {n_x} devices (ghost width {h})"
            )
            raise ValueError(msg)
        if n_y > 1 and (y_cols % n_y != 0 or y_cols // n_y < 2 * h):
            msg = (
                f"grid Y={y_cols} must split into ≥{2 * h}-column slabs "
                f"across {n_y} devices (ghost width {h})"
            )
            raise ValueError(msg)
        state_specs = specs_for(state)
        scene_specs = specs_for(scene)
        scene_ext = shard_map(
            extend, mesh=mesh, in_specs=(scene_specs,), out_specs=scene_specs,
            check_vma=False,
        )(scene)
        return shard_map(
            functools.partial(shard_body, n=n),
            mesh=mesh,
            in_specs=(state_specs, scene_specs),
            out_specs=state_specs,
            check_vma=False,  # (jax.shard_map's rename of check_rep)
        )(state, scene_ext)

    return run
