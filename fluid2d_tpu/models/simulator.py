"""High-level simulator façade.

API parity with the reference's ``FluidSimulator`` / ``DyeFluidSimulator``
(``fs/fluid_simulator.py:13-176``) plus the capabilities an
accelerator-resident library needs: multi-step jitted runs (``lax.scan``, zero
host round-trips per step), full-state checkpoint/resume, and optional
grid sharding over a device mesh.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.cip import cip_step
from fluid2d_tpu.models.mac import mac_step
from fluid2d_tpu.scenes.compile import Scene, get_scene
from fluid2d_tpu.state import SimState, init_state
from fluid2d_tpu.utils import io as fio
from fluid2d_tpu.utils.viz import render_rgb, to_image

__all__ = ["FluidSimulator", "make_step_fn", "make_run_fn"]


def scene_for_dtype(scene: Scene, cfg: SimConfig) -> Scene:
    """Cast the scene's float planes (inflow velocity / dye colors) to
    the transport dtype so every float operand of a phase shares one
    storage dtype (the masks stay bool/int8). Identity for float32."""
    dt = jnp.dtype(cfg.dtype)
    if scene.bc_const.dtype == dt:
        return scene
    return scene._replace(
        bc_const=scene.bc_const.astype(dt), bc_dye=scene.bc_dye.astype(dt)
    )


def step_fn_for(cfg: SimConfig):
    """The raw (state, scene) → state step for `cfg` (untraced)."""
    base = cip_step if cfg.scheme == "cip" else mac_step
    return functools.partial(base, cfg=cfg)


def make_step_fn(cfg: SimConfig):
    """Jitted single step. Donates the state so buffers update in place."""
    step = step_fn_for(cfg)
    return jax.jit(lambda state, scene: step(state, scene), donate_argnums=0)


def make_run_fn(cfg: SimConfig):
    """Jitted (state, scene, n) → state running n steps via ``lax.scan``
    with no host synchronization (n is static).

    The scan body runs TWO steps per iteration. The (cur, alt) buffer
    pairs swap roles every step, so a 1-step body permutes the carry
    slots each iteration, and XLA may copy every fresh output back into
    its while-carry buffer. A 2-step body swaps each pair twice, so the
    slot assignment is the identity and no such copy is needed. Whether
    XLA's GPU backend needs this is not measured yet."""
    step = step_fn_for(cfg)

    @functools.partial(jax.jit, static_argnums=2, donate_argnums=0)
    def run(state, scene, n: int):
        def body(st, _):
            return step(step(st, scene), scene), None

        pairs, rem = divmod(n, 2)
        if pairs:
            state, _ = jax.lax.scan(body, state, None, length=pairs)
        if rem:
            state = step(state, scene)
        return state

    return run


class FluidSimulator:
    """Drop-in capability match for the reference façade.

    ``create`` mirrors ``fs/fluid_simulator.py:60-108,128-176`` (scene
    wiring, SOR ω=1.3 / n_iter=2 defaults, scheme selection); the
    ``get_*_field`` methods reproduce its render kernels. ``enable_dye``
    replaces the separate ``DyeFluidSimulator`` subclass.
    """

    def __init__(self, scene: Scene, cfg: SimConfig, state: SimState | None = None,
                 scene_meta: dict | None = None):
        self.scene = scene_for_dtype(scene, cfg)
        self.cfg = cfg
        self.scene_meta = scene_meta or {}
        # A provided state (resume / dtype override) is re-narrowed or
        # widened to the config's transport dtype — exact in both
        # directions for values that started life as bf16 stores.
        self.state = init_state(scene, cfg) if state is None else fio._cast_state(state, cfg)
        self._run = make_run_fn(cfg)
        self._render = jax.jit(
            lambda state, scene, vis: render_rgb(state, scene, cfg, vis), static_argnums=2
        )

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        bc_num: int,
        resolution: int,
        dt: float | None = None,
        re: float = 1_000_000.0,
        vor_eps: float | None = 5.0,
        scheme: str = "cip",
        enable_dye: bool = True,
        mask_image: str | None = None,
        **config_overrides,
    ) -> "FluidSimulator":
        """`mask_image` (an image path or bundled asset name: dragon,
        rabbit, aircraft) builds a scene-6-style obstacle layout from the
        silhouette, replacing `bc_num` — same override the CLI's
        ``--mask-image`` provides (generalizes the reference's hardwired
        dragon, ``fs/boundary_condition.py:508-513``)."""
        cfg = SimConfig.create(
            resolution=resolution,
            dt=dt,
            re=re,
            scheme=scheme,
            vor_eps=vor_eps,
            enable_dye=enable_dye,
            **config_overrides,
        )
        return cls(
            get_scene(bc_num, resolution, mask_image=mask_image),
            cfg,
            scene_meta={"bc_num": bc_num, "mask_image": mask_image},
        )

    # -- stepping ----------------------------------------------------------
    def step(self, n: int = 1) -> None:
        """Advance n steps on device (one compiled scan, no host syncs)."""
        self.state = self._run(self.state, self.scene, n)

    def reset(self) -> None:
        """Zero all fields (the reference's unused ``DoubleBuffer.reset``
        capability, ``fs/double_buffer.py:16``)."""
        self.state = init_state(self.scene, self.cfg)

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    # -- rendering (parity with fs/fluid_simulator.py:22-32,113-115) --------
    def get_norm_field(self) -> np.ndarray:
        return np.asarray(self._render(self.state, self.scene, 0))

    def get_pressure_field(self) -> np.ndarray:
        return np.asarray(self._render(self.state, self.scene, 1))

    def get_vorticity_field(self) -> np.ndarray:
        return np.asarray(self._render(self.state, self.scene, 2))

    def get_dye_field(self) -> np.ndarray:
        return np.asarray(self._render(self.state, self.scene, 3))

    def screenshot(self, path: str | Path, vis: int = 0) -> None:
        """Render and write a PNG (the reference's ``s`` key,
        ``main.py:124-128``)."""
        fio.write_png(path, to_image(self._render(self.state, self.scene, vis)))

    # -- IO ------------------------------------------------------------------
    def field_to_numpy(self) -> dict[str, np.ndarray]:
        return fio.fields_to_numpy(self.state)

    def save(self, path: str | Path) -> None:
        fio.save_checkpoint(path, self.state, self.cfg, scene_meta=self.scene_meta)

    @classmethod
    def load(cls, path: str | Path, bc_num: int | None = None,
             mask_image: str | None = None) -> "FluidSimulator":
        """Exact resume from a full-state checkpoint (capability the
        reference lacks). The scene identity is stored in the checkpoint;
        `bc_num` / `mask_image` are explicit overrides."""
        state, cfg, meta = fio.load_checkpoint(path)
        bc = bc_num if bc_num is not None else meta.get("bc_num", 1)
        if bc_num is not None and mask_image is None:
            # An explicit bc override replaces the scene identity: do NOT
            # inherit a stored mask image (get_scene short-circuits on
            # mask_image before reading bc_num, so inheriting it would
            # silently keep the old obstacle layout).
            if meta.get("mask_image"):
                print(f"note: -bc {bc_num} overrides the checkpoint's scene; "
                      f"the stored mask image ({meta['mask_image']}) is "
                      f"discarded (pass --mask-image to keep it)")
            mask = None
        else:
            mask = mask_image if mask_image is not None else meta.get("mask_image")
        scene = get_scene(bc, cfg.resolution, mask_image=mask)
        return cls(scene, cfg, state=state,
                   scene_meta={"bc_num": bc, "mask_image": mask})
