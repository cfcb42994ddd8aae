"""Grid sharding over a device mesh (GSPMD path).

The reference is strictly single-device (SURVEY.md §2.3); scale-out here
is spatial domain decomposition: every (…, X, Y) field and scene array is
sharded along X over a 1-D ``jax.sharding.Mesh``. The step functions are
pure ``jnp`` stencils, so GSPMD auto-partitions them — each shifted-slice
read at a shard boundary lowers to a neighbor exchange (collective-permute
over the device links), i.e. halo exchange without hand-written
communication. The
widest stencil (Kawamura-Kuwahara) needs a halo of 2, which XLA derives
itself from the slice widths.

An explicit ``shard_map`` + ``lax.ppermute`` ghost-window path lives in
:mod:`fluid2d_tpu.parallel.halo`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_leaf", "shard_pytree", "shard_simulator"]


def make_mesh(n_devices: int | None = None, devices=None,
              shape: tuple[int, int] | None = None) -> Mesh:
    """Device mesh for spatial decomposition. Default: 1-D over the
    first `n_devices` (grid sharded along X). With ``shape=(nx, ny)``:
    a 2-D ``("x", "y")`` mesh for two-axis decomposition (GSPMD route) —
    the right layout when X/nx slabs would get thinner than the stencil
    ghost depth before the chip count is exhausted. Raises if fewer
    devices exist than requested — a silently smaller mesh makes
    'sharded == single-device' checks vacuously pass."""
    if devices is None:
        devices = jax.devices()
    if shape is not None:
        if n_devices is not None:
            msg = "pass either n_devices or shape, not both (shape fixes the device count)"
            raise ValueError(msg)
        nx, ny = shape
        if len(devices) < nx * ny:
            msg = f"requested {nx}x{ny} mesh, only {len(devices)} devices available"
            raise ValueError(msg)
        return Mesh(np.array(devices[: nx * ny]).reshape(nx, ny), axis_names=("x", "y"))
    if n_devices is not None:
        if len(devices) < n_devices:
            msg = f"requested {n_devices} devices, only {len(devices)} available"
            raise ValueError(msg)
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("x",))


def _spec_for(leaf, mesh: Mesh) -> P:
    """Shard the X axis (second-to-last) of grid arrays over mesh axis
    "x" — and the Y axis (last) over "y" when the mesh has one; replicate
    scalars and indivisible leaves."""
    if getattr(leaf, "ndim", 0) < 2:
        return P()
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if leaf.shape[-2] % sizes["x"] != 0:
        return P()  # uneven grids stay replicated (not used by any scene size)
    y_ax = "y" if "y" in sizes and leaf.shape[-1] % sizes["y"] == 0 else None
    return P(*([None] * (leaf.ndim - 2)), "x", y_ax)


def shard_leaf(leaf, mesh: Mesh):
    return jax.device_put(leaf, NamedSharding(mesh, _spec_for(leaf, mesh)))


def shard_pytree(tree, mesh: Mesh):
    """device_put every array leaf with an X-sharded (or replicated) spec."""
    return jax.tree.map(lambda leaf: shard_leaf(leaf, mesh), tree)


def shard_simulator(sim, n_devices: int | None = None, path: str = "auto",
                    mesh_shape: tuple[int, int] | None = None) -> Mesh:
    """Shard a :class:`FluidSimulator`'s state and scene in place.

    Two routes:

    * ``"halo"`` — explicit ghost-window decomposition
      (:func:`fluid2d_tpu.parallel.halo.make_sharded_run_halo`): ONE
      ppermute exchange per step, the unmodified step per shard inside
      ``shard_map``.
    * ``"gspmd"`` — XLA auto-partitioning of the same step: a collective
      per shifted read at a shard boundary.

    ``"auto"`` picks halo whenever the grid splits into slabs wide enough
    for the ghost depth, else falls back to gspmd. With
    ``mesh_shape=(nx, ny)`` the grid is decomposed over BOTH axes on a
    2-D ``("x", "y")`` mesh — the halo path runs two sequential ghost
    exchanges (rows, then row-extended columns).
    The chosen route is printed (it changes the performance profile
    materially) and recorded as ``sim.shard_path``.
    """
    if mesh_shape is not None:
        mesh = make_mesh(shape=mesh_shape)
    else:
        mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_x, n_y = sizes.get("x", 1), sizes.get("y", 1)

    if path in ("auto", "halo"):
        from fluid2d_tpu.parallel.halo import ghost_width, make_sharded_run_halo

        h = ghost_width(sim.cfg)
        x_rows, y_cols = sim.state.p.shape[-2:]
        # Mirror halo.py's per-axis rule: an undecomposed axis (n == 1)
        # exchanges nothing, so it imposes no slab constraint.
        fits = (
            (n_x == 1 or (x_rows % n_x == 0 and x_rows // n_x >= 2 * h))
            and (n_y == 1 or (y_cols % n_y == 0 and y_cols // n_y >= 2 * h))
        )
        if fits:
            sim._run = make_sharded_run_halo(sim.cfg, mesh)
            sim.state = shard_pytree(sim.state, mesh)
            sim.scene = shard_pytree(sim.scene, mesh)
            sim.shard_path = "halo"
            mesh_desc = f"{n_x}x{n_y} mesh" if n_y > 1 else f"{n_dev} devices"
            print(f"sharding: ghost-window halo path over {mesh_desc} "
                  f"(ghost width {h})")
            return mesh
        if path == "halo":
            msg = (f"halo path needs grid ({x_rows}, {y_cols}) to split into "
                   f"≥{2 * h}-row/col slabs across the {n_x}x{n_y} mesh")
            raise ValueError(msg)
        print(f"sharding: grid ({x_rows}, {y_cols}) too small for {2 * h}-deep ghost "
              f"slabs on the {n_x}x{n_y} mesh; falling back to GSPMD")

    sim.state = shard_pytree(sim.state, mesh)
    sim.scene = shard_pytree(sim.scene, mesh)
    sim.shard_path = "gspmd"
    print(f"sharding: GSPMD auto-partitioning over mesh {sizes}")
    return mesh
