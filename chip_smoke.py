"""Smoke test of the solver on the GPU: the quickest proof that the
system still starts and computes the right thing on the card.

    python chip_smoke.py              # one GPU: device, main path, parity, reach
    python chip_smoke.py --four-gpus  # four GPUs: the sharded routes only

Phases (each a plain function that takes the platform it expects, so the
CPU tests run the same checks at small sizes):

1. device     — JAX sees the expected platform; the card's name and power
                limit as ``nvidia-smi`` reports them.
2. main path  — the headline deployment (``-bc 2 -res 1600``, CIP, dye,
                vorticity confinement ε=5, SOR ω=1.3 × 2, float32) through
                ``fluid2d_tpu.cli.main`` in this process, with logging,
                field dump and checkpoint; a resume that must continue the
                step count; all four views through ``FluidSimulator``.
3. parity     — headline steps on the device vs the same jitted step on
                ``jax.devices("cpu")[0]``: per-field relative RMS ≤ 1e-5
                over 10 steps without confinement and 1 step with it, and
                the stated looser bound over 10 steps with it (see
                PARITY_RMS below); then upwind / KK / CIP against
                ``tests/oracle.py`` at ``tests/test_parity.py``'s size,
                seed and tolerance.
4. reach      — BASELINE presets 1-6 for a few steps, float32 and bf16
                transport: finite, and bf16 within ``tests/test_bf16.py``'s
                bound of float32.
5. four GPUs  — (``--four-gpus`` only) res=4096 bc=3 CIP through the halo
                route over 4 cards and GSPMD over a 2x2 mesh, each against
                a one-card run of the same seeded state.

Any failure raises: the script then exits non-zero without the result
line. The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "output" / "chip_smoke"

# Relative RMS bound of the device run against the CPU run of the same
# jitted step (ROADMAP's float32 reference bar). The step has no matrix
# products, so TF32 cannot enter; the comparison still runs under
# jax.default_matmul_precision("highest"). The bar holds over 10 headline
# steps without vorticity confinement, and over 1 step with it. Over 10
# steps with it, it does not: the confinement force's direction
# ∇|ω| / |∇|ω|| is ill-conditioned where |∇|ω|| → 0 (extrema and kinks of
# |ω|), so the last-bit differences of FMA contraction and operation order
# turn into direction changes of a force as large as dt·ε·0.1, and the CIP
# gradient fields, differences of neighbours over 2·dx, amplify that
# per-cell noise further. For that run the bound that holds is stated per
# field group (H100 measured 3.6e-5 for v and 1.2e-3 for vy; docs/PARITY.md §4).
PARITY_RMS = 1e-5
PARITY_RMS_CONFINED = {"value": 2e-4, "gradient": 5e-3}
GRADIENT_FIELDS = ("vx", "vx_alt", "vy", "vy_alt", "dyex", "dyex_alt", "dyey", "dyey_alt")
# tests/test_parity.py's oracle tolerance: max|Δ| ≤ 2e-5 · max(1, max|ref|).
ORACLE_TOL = 2e-5
# tests/test_bf16.py's bound: max|bf16 − f32| / max(max|f32|, 1e-3).
BF16_REL = 0.08
# __graft_entry__.py's sharded-vs-one-device bound: max|Δ| ≤ 1e-5 · max(1, max|ref|).
SHARD_TOL = 1e-5


class SmokeError(RuntimeError):
    """A phase found a wrong or missing result."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def _fields(state) -> dict:
    """Host float32 copies of every array leaf but the step counter."""
    import numpy as np

    return {f: np.asarray(leaf, np.float32) for f, leaf in zip(state._fields, state)
            if leaf is not None and f != "step"}


def _all_finite(state, what: str) -> None:
    import numpy as np

    for name, a in _fields(state).items():
        _check(bool(np.isfinite(a).all()), f"{what}: field {name} is not finite")


def seeded_state(scene, cfg, seed: int = 0):
    """Host (NumPy) state: the zero state plus a smooth seeded
    perturbation of v, p and dye at fluid cells. Nonzero gradients
    almost everywhere keep the confinement's 0/0 branch, whose jump
    turns last-bit differences into O(0.1) ones (docs/PARITY.md §4),
    out of the comparisons."""
    import jax.numpy as jnp
    import numpy as np

    from fluid2d_tpu.state import SimState, init_state

    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2 * np.pi, size=6).astype(np.float32)
    x_rows, y_cols = scene.shape
    fluid = np.asarray(scene.fluid, np.float32)
    gx = np.linspace(0, 2 * np.pi, x_rows, dtype=np.float32)[:, None]
    gy = np.linspace(0, 2 * np.pi, y_cols, dtype=np.float32)[None, :]
    dt = jnp.dtype(cfg.dtype)
    host = {f: np.asarray(leaf) for f, leaf in zip(SimState._fields, init_state(scene, cfg))
            if leaf is not None}
    host["v"] = np.stack([0.3 * np.sin(gx + ph[0]) * np.cos(2 * gy + ph[1]) * fluid,
                          0.2 * np.cos(2 * gx + ph[2]) * np.sin(gy + ph[3]) * fluid]).astype(dt)
    host["p"] = (0.1 * np.sin(gx + gy + ph[4]) * fluid).astype(dt)
    if cfg.enable_dye:
        host["dye"] = np.stack([0.5 + 0.4 * np.sin(k * gx + ph[5]) * np.cos(gy) * fluid
                                for k in (1, 2, 3)]).astype(dt)
    return SimState(**host)


# --- 1. device ---------------------------------------------------------------

def phase_device(platform: str, count: int = 1) -> dict:
    """JAX's devices are `platform` devices, at least `count` of them; on
    a GPU, ``nvidia-smi`` reports the card's name and power limit."""
    import jax

    from fluid2d_tpu.utils.profiling import device_info

    devs = jax.devices()
    kinds = sorted({d.platform for d in devs})
    _check(kinds == [platform], f"expected {platform} devices, JAX found {kinds}")
    _check(len(devs) >= count, f"expected {count} {platform} devices, found {len(devs)}")
    info = device_info()
    if platform == "gpu":
        _check(bool(info["gpu_name"] and info["power_limit"]),
               "nvidia-smi did not report the card's name and power limit")
    print(f"device: {info['platform']} {info['device_kind']} x{info['count']}")
    print(f"nvidia-smi: {info['gpu_name']}, {info['power_limit']}")
    return info


# --- 2. main path --------------------------------------------------------------

def phase_main_path(platform: str, res: int = 1600, steps: int = 200,
                    chunk: int = 50, out_dir: Path = OUT_DIR) -> dict:
    """The headline deployment through the CLI: run, dump, checkpoint,
    resume, render. Returns ``{"steps_per_s": …}`` (information only)."""
    import jax
    import numpy as np

    from fluid2d_tpu import cli
    from fluid2d_tpu.models.simulator import FluidSimulator
    from fluid2d_tpu.utils.io import load_checkpoint

    _check(steps % chunk == 0, "steps must be a multiple of chunk")
    headline = ["-bc", "2", "-res", str(res), "-scheme", "cip", "-vc", "5.0",
                "--pressure-solver", "sor", "--sor-omega", "1.3",
                "--pressure-iters", "2", "--dtype", "float32"]
    ckpt, ckpt2 = out_dir / "ckpt.npz", out_dir / "ckpt_resumed.npz"
    run1, run2 = out_dir / "run", out_dir / "resumed"

    def cli_run(argv: list[str]) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        text = buf.getvalue()
        print(text, end="")
        return text

    t0 = time.perf_counter()
    text = cli_run([*headline, "--steps", str(steps), "--log-every", str(chunk),
                    "--dump-fields", "--checkpoint", str(ckpt), "--output", str(run1)])
    _check(f"Device: {platform} " in text, "the CLI banner does not name the device")
    _check(f"step {steps}:" in text, f"no log line for step {steps}")
    dump = run1 / f"step_{steps:06d}.npz"
    _check(dump.exists(), f"no field dump at {dump}")
    with np.load(dump) as d:
        for k in d.files:
            _check(bool(np.isfinite(d[k]).all()), f"dumped field {k} is not finite")
    state, _, _ = load_checkpoint(ckpt)
    _check(int(state.step) == steps, f"checkpoint step {int(state.step)} != {steps}")
    _all_finite(state, "checkpoint")

    # Resume: step numbering continues from the checkpoint.
    cli_run(["--resume", str(ckpt), "--steps", str(chunk), "--dump-fields",
             "--checkpoint", str(ckpt2), "--output", str(run2)])
    _check((run2 / f"step_{steps + chunk:06d}.npz").exists(),
           f"resumed dump is not named for step {steps + chunk}")
    state2, _, _ = load_checkpoint(ckpt2)
    _check(int(state2.step) == steps + chunk, "resumed run lost the step count")
    _all_finite(state2, "resumed checkpoint")
    print(f"main path: CLI run + resume in {time.perf_counter() - t0:.1f} s")

    # All four views through the façade, then a timed stretch.
    sim = FluidSimulator.load(ckpt2)
    for name in ("norm", "pressure", "vorticity", "dye"):
        rgb = getattr(sim, f"get_{name}_field")()
        _check(rgb.shape == (2 * res, res, 3), f"{name} view has shape {rgb.shape}")
        _check(bool(np.isfinite(rgb).all()), f"{name} view is not finite")
    sim.step(chunk)  # same static length as the CLI chunks: no new compile
    jax.block_until_ready(sim.state)
    t0 = time.perf_counter()
    sim.step(chunk)
    jax.block_until_ready(sim.state)
    rate = chunk / (time.perf_counter() - t0)
    _all_finite(sim.state, "façade run")
    print(f"main path: {rate:.1f} steps/s at res={res} (information only)")
    return {"steps_per_s": rate}


# --- 3. parity -------------------------------------------------------------------

def _device_vs_cpu(platform: str, cfg, scene, host, steps: int) -> dict:
    """Per-field relative RMS of `steps` steps on the device against the
    same jitted step on the CPU, from the same host state."""
    import jax
    import numpy as np

    from fluid2d_tpu.models.simulator import make_run_fn

    host_scene = jax.tree.map(np.asarray, scene)
    run = make_run_fn(cfg)
    outs = {}
    with jax.default_matmul_precision("highest"):
        for dev in (jax.devices(platform)[0], jax.devices("cpu")[0]):
            out = run(jax.device_put(host, dev), jax.device_put(host_scene, dev), steps)
            outs[dev.platform] = _fields(out)
    rel = {}
    for name, b in outs["cpu"].items():
        a = outs[platform][name]
        _check(bool(np.isfinite(a).all()), f"parity: device field {name} is not finite")
        ref_rms = float(np.sqrt(np.mean(np.square(b, dtype=np.float64))))
        d_rms = float(np.sqrt(np.mean(np.square(a - b, dtype=np.float64))))
        rel[name] = d_rms / ref_rms if ref_rms > 0 else d_rms
    return rel


def phase_parity(platform: str, res: int = 1600, steps: int = 10, seed: int = 0,
                 oracle_schemes=("upwind", "kk", "cip")) -> dict:
    """Device vs CPU at real width, then the device vs the scalar oracle.
    Returns the per-field relative RMS differences of each run."""
    import jax

    from fluid2d_tpu.config import SimConfig
    from fluid2d_tpu.scenes.compile import get_scene

    scene = get_scene(2, res)
    runs = {}
    for label, vor_eps, n, bounds in (
        ("no confinement", None, steps, {"value": PARITY_RMS, "gradient": PARITY_RMS}),
        ("confinement ε=5", 5.0, 1, {"value": PARITY_RMS, "gradient": PARITY_RMS}),
        ("confinement ε=5", 5.0, steps, PARITY_RMS_CONFINED),
    ):
        cfg = SimConfig.create(resolution=res, scheme="cip", vor_eps=vor_eps,
                               enable_dye=True, pressure_solver="sor", sor_omega=1.3,
                               n_pressure_iter=2)
        rel = _device_vs_cpu(platform, cfg, scene, seeded_state(scene, cfg, seed), n)
        print(f"parity: {platform} vs cpu, headline with {label}, {n} steps at res={res}, "
              f"relative RMS (bound {bounds['value']:g}, gradient fields "
              f"{bounds['gradient']:g}; matmul precision 'highest'):")
        for name, r in rel.items():
            bound = bounds["gradient" if name in GRADIENT_FIELDS else "value"]
            print(f"  {name:9s} {r:.3e}")
            _check(r <= bound, f"parity ({label}, {n} steps): {name} differs by "
                               f"relative RMS {r:.3e} > {bound:g}")
        runs[f"{label}, {n} steps"] = rel

    # Scalar oracle at tests/test_parity.py's size, seed and tolerance.
    from tests.test_parity import RES, STEPS, _cmp, _run_pair

    with jax.default_matmul_precision("highest"):
        for scheme in oracle_schemes:
            state, orc = _run_pair(2, scheme, vor_eps=5.0, enable_dye=True)
            pairs = [("v", state.v, orc.v.cur), ("v_alt", state.v_alt, orc.v.nxt),
                     ("p", state.p, orc.p.cur), ("p_alt", state.p_alt, orc.p.nxt),
                     ("dye", state.dye, orc.dye.cur), ("dye_alt", state.dye_alt, orc.dye.nxt)]
            if scheme == "cip":
                pairs += [("vx", state.vx, orc.vx.cur), ("vy", state.vy, orc.vy.cur),
                          ("dyex", state.dyex, orc.dyex.cur), ("dyey", state.dyey, orc.dyey.cur)]
            for name, got, want in pairs:
                _cmp(f"oracle/{scheme}/{name}", got, want, tol=ORACLE_TOL)
            print(f"parity: {scheme} matches tests/oracle.py on scene 2, res={RES}, "
                  f"{STEPS} steps (max|Δ| ≤ {ORACLE_TOL:g}·max(1, max|ref|))")
    return runs


# --- 4. reach --------------------------------------------------------------------

def phase_reach(platform: str, presets=None, steps: int = 6, res_cap: int | None = None) -> dict:
    """BASELINE presets in float32 and bf16 transport: finite fields, bf16
    within BF16_REL of float32. `res_cap` shrinks the grids (CPU tests).
    Returns the worst bf16 relative error per preset."""
    import jax
    import numpy as np

    import bench
    from fluid2d_tpu.models.simulator import make_run_fn

    _check(jax.devices()[0].platform == platform, f"reach: default device is not {platform}")
    worst = {}
    for n in presets or sorted(bench.PRESETS):
        kw = dict(bench.PRESETS[n]["kw"])
        if res_cap:
            kw["res"] = min(kw["res"], res_cap)
        got = {}
        for dtype in ("float32", "bfloat16"):
            cfg, scene, state = bench.make_case(dtype=dtype, **kw)
            state = make_run_fn(cfg)(state, scene, steps)
            _all_finite(state, f"preset {n} {dtype}")
            got[dtype] = _fields(state)
        errs = {}
        for name in ("v", "p", "dye"):
            if name not in got["float32"]:
                continue
            a, b = got["bfloat16"][name], got["float32"][name]
            errs[name] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3)
        worst[n] = max(errs.values())
        print(f"reach: preset {n} ({bench.PRESETS[n]['desc']}) res={kw['res']}: "
              f"finite in float32 and bfloat16; bf16 vs f32 "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
        _check(worst[n] < BF16_REL,
               f"reach: preset {n} bf16 strays {worst[n]:.3e} ≥ {BF16_REL} from f32")
    return worst


# --- 5. four GPUs ------------------------------------------------------------------

def phase_four_devices(platform: str, res: int = 4096, bc: int = 3, steps: int = 4,
                       n_dev: int = 4, seed: int = 0) -> dict:
    """The halo route over `n_dev` devices and GSPMD over a 2-D mesh, each
    against a one-device run of the same seeded state. Returns each
    route's max|Δ| / max(1, max|ref|)."""
    import jax
    import numpy as np

    from fluid2d_tpu.config import SimConfig
    from fluid2d_tpu.models.simulator import FluidSimulator, make_run_fn
    from fluid2d_tpu.parallel.sharding import shard_simulator
    from fluid2d_tpu.scenes.compile import get_scene

    devs = jax.devices(platform)
    _check(len(devs) >= n_dev, f"four devices: only {len(devs)} {platform} devices")
    cfg = SimConfig.create(resolution=res, scheme="cip", vor_eps=5.0, enable_dye=True)
    scene = get_scene(bc, res)
    host = seeded_state(scene, cfg, seed)
    ref = _fields(make_run_fn(cfg)(jax.device_put(host, devs[0]), scene, steps))
    side = int(round(n_dev ** 0.5))

    errs = {}
    for route, kw in (("halo", {"n_devices": n_dev}),
                      ("gspmd", {"mesh_shape": (side, n_dev // side), "path": "gspmd"})):
        sim = FluidSimulator(scene, cfg, state=host)
        shard_simulator(sim, **kw)
        _check(sim.shard_path == route, f"{route}: shard_simulator took {sim.shard_path}")
        sim.step(steps)
        got = _fields(sim.state)
        worst = 0.0
        for name, a in ref.items():
            b = got[name]
            _check(b.shape == a.shape, f"{route}/{name}: shape {b.shape} != {a.shape}")
            err = float(np.abs(b - a).max()) / max(1.0, float(np.abs(a).max()))
            _check(err <= SHARD_TOL, f"{route}/{name}: sharded != one device, "
                                     f"{err:.3e} > {SHARD_TOL:g}")
            worst = max(worst, err)
        errs[route] = worst
        mesh = "x".join(str(s) for s in sim.state.v.sharding.mesh.devices.shape)
        print(f"four devices: {route} over a {mesh} mesh matches one device, res={res} "
              f"bc={bc}, {steps} steps (worst max|Δ|/max(1,max|ref|) = {worst:.3e}, "
              f"bound {SHARD_TOL:g})")
    return errs


def result_line(platform: str) -> str:
    import jax

    dev = jax.devices()[0]
    _check(dev.platform == platform, f"result: device is {dev.platform}, not {platform}")
    return json.dumps({"ok": True, "device": {"platform": dev.platform,
                                              "kind": dev.device_kind,
                                              "count": len(jax.devices())}})


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card phase (needs four GPUs)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the perturbed states")
    args = ap.parse_args(argv)

    from fluid2d_tpu.utils.cache import enable_compile_cache

    t0 = time.perf_counter()
    phase_device("gpu", count=4 if args.four_gpus else 1)
    enable_compile_cache()
    if args.four_gpus:
        phase_four_devices("gpu", seed=args.seed)
    else:
        try:
            phase_main_path("gpu")
        finally:
            shutil.rmtree(OUT_DIR, ignore_errors=True)  # ~1 GB of checkpoints
        phase_parity("gpu", seed=args.seed)
        phase_reach("gpu")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line("gpu"))


if __name__ == "__main__":
    main()
