"""Checkpointing, field dumps, and image output.

The reference can only *dump* (``main.py:129-132`` saves v/p/dye on a
keypress — omitting the CIP gradient fields, so a dump cannot restart a
CIP run). Here checkpoints serialize the full state pytree (every buffer
pair + step counter + config), enabling exact resume; `fields_to_numpy`
reproduces the reference's dump layout for cross-checking.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.state import SimState

__all__ = ["fields_to_numpy", "save_checkpoint", "load_checkpoint", "write_png", "write_gif"]


def fields_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """Reference-layout field dump (``fs/fluid_simulator.py:34-36,117-119``):
    v → (X, Y, 2), p → (X, Y), dye → (X, Y, 3) when present."""
    out = {
        "v": np.moveaxis(_npz_safe(np.asarray(state.v)), 0, -1),
        "p": _npz_safe(np.asarray(state.p)),
    }
    if state.dye is not None:
        out["dye"] = np.moveaxis(_npz_safe(np.asarray(state.dye)), 0, -1)
    return out


def _npz_safe(arr: np.ndarray) -> np.ndarray:
    """Widen non-native float dtypes (ml_dtypes bfloat16) to float32 —
    np.savez cannot serialize them without pickling. Lossless."""
    return arr.astype(np.float32) if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16" else arr


def _cast_state(state: SimState, cfg: SimConfig) -> SimState:
    """Re-narrow float leaves to the config's transport dtype (identity
    when they already match; integer leaves untouched)."""
    import jax.numpy as jnp

    dt = jnp.dtype(cfg.dtype)
    return SimState(*(
        leaf.astype(dt)
        if leaf is not None and jnp.issubdtype(leaf.dtype, jnp.floating) and leaf.dtype != dt
        else leaf
        for leaf in state
    ))


def _is_orbax_dir(path: Path) -> bool:
    """Route by suffix: ``.npz`` (case-insensitive) → single file;
    no suffix → orbax directory tree; any other file-like suffix is
    rejected loudly rather than silently becoming a directory."""
    suffix = path.suffix.lower()
    if suffix == ".npz":
        return False
    if suffix and not path.is_dir():
        msg = (f"unrecognized checkpoint suffix {path.suffix!r} (use '.npz' for a "
               f"single file or a suffix-less path for an orbax directory)")
        raise ValueError(msg)
    return True


def save_checkpoint(path: str | Path, state: SimState, cfg: SimConfig,
                    scene_meta: dict | None = None) -> None:
    """Full-state checkpoint: every pytree leaf + the config and scene
    identity as JSON.

    A ``.npz`` path gathers to host and writes one file; a directory
    path (no suffix) uses orbax — which writes sharded arrays per-shard
    without a host gather, the right backend for mesh-distributed runs.
    """
    path = Path(path)
    orbax = _is_orbax_dir(path)  # validate the path before any work
    meta = {"config": dataclasses.asdict(cfg), "scene": scene_meta or {}}
    if orbax:
        _save_orbax(path, state, meta)
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    # npz has no native bfloat16: store reduced-precision transport
    # leaves widened to float32 (exact) and re-narrow on load.
    arrays = {
        name: _npz_safe(np.asarray(leaf))
        for name, leaf in zip(state._fields, state) if leaf is not None
    }
    arrays["__config__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


# SimConfig fields that older checkpoints may carry but the config no
# longer has (the kernel-path selectors); dropped on load.
_REMOVED_CONFIG_KEYS = ("kernels", "sor_fuse")


def _config_from_meta(meta: dict) -> SimConfig:
    fields = {k: v for k, v in meta["config"].items() if k not in _REMOVED_CONFIG_KEYS}
    return SimConfig(**fields)


def load_checkpoint(path: str | Path) -> tuple[SimState, SimConfig, dict]:
    """Restore (state, config, scene_meta) written by :func:`save_checkpoint`."""
    import jax.numpy as jnp

    path = Path(path)
    if _is_orbax_dir(path):
        return _load_orbax(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__config__"].tobytes()).decode())
        cfg = _config_from_meta(meta)
        leaves = {
            name: jnp.asarray(data[name]) for name in SimState._fields if name in data.files
        }
    return _cast_state(SimState(**leaves), cfg), cfg, meta.get("scene", {})


def _save_orbax(path: Path, state: SimState, meta: dict) -> None:
    import orbax.checkpoint as ocp

    path = path.resolve()
    tree = {name: leaf for name, leaf in zip(state._fields, state) if leaf is not None}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path / "state", tree, force=True)
    (path / "config.json").write_text(json.dumps(meta))


def _load_orbax(path: Path) -> tuple[SimState, SimConfig, dict]:
    import orbax.checkpoint as ocp

    path = path.resolve()
    meta = json.loads((path / "config.json").read_text())
    cfg = _config_from_meta(meta)
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(path / "state")
    import jax.numpy as jnp

    tree = {k: jnp.asarray(v) for k, v in tree.items()}
    return _cast_state(SimState(**tree), cfg), cfg, meta.get("scene", {})


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write a uint8 H×W×3 image (see :func:`fluid2d_tpu.utils.viz.to_image`)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(image).save(path)


def write_gif(path: str | Path, frames, fps: int = 30) -> None:
    """Animate frames into a GIF (the reference's disabled VideoManager
    capability, ``main.py:86,109``).

    ``frames`` is an iterable of uint8 H×W×3 arrays **or image file
    paths**. Paths are opened lazily one at a time through a generator,
    so a long res≥1600 animation streams from the already-written PNG
    frames at constant memory instead of holding every decoded frame in
    host RAM."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def to_img(f):
        return Image.open(f) if isinstance(f, (str, Path)) else Image.fromarray(f)

    it = iter(frames)
    first = to_img(next(it))
    first.save(
        path,
        save_all=True,
        append_images=(to_img(f) for f in it),
        duration=max(1, round(1000 / fps)),
        loop=0,
    )
