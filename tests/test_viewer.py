"""Headless (Agg backend) smoke tests for the interactive viewer —
Drive run_viewer's loop, key handlers (p/v/s/d/q)
and render cadence without a display, mirroring the reference's GGUI
loop behavior (``/root/reference/main.py:93-134``)."""

import pytest

# matplotlib is an optional extra (the `viz` extra in pyproject.toml).
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.backend_bases import KeyEvent  # noqa: E402

from fluid2d_tpu.models.simulator import FluidSimulator  # noqa: E402
from fluid2d_tpu.utils.viewer import run_viewer  # noqa: E402

RES = 16


def _make_sim(**kw):
    return FluidSimulator.create(1, RES, vor_eps=None, scheme="upwind", **kw)


def _drive(monkeypatch, keys_by_iter):
    """Replace plt.pause with a driver that injects key presses on given
    loop iterations (the viewer calls pause once per render)."""
    counter = {"i": 0}

    def fake_pause(_interval):
        i = counter["i"]
        counter["i"] += 1
        fig = plt.gcf()
        for key in keys_by_iter.get(i, ()):
            fig.canvas.callbacks.process(
                "key_press_event", KeyEvent("key_press_event", fig.canvas, key)
            )

    monkeypatch.setattr(plt, "pause", fake_pause)
    return counter


def test_viewer_runs_and_quits(monkeypatch, tmp_path):
    sim = _make_sim()
    _drive(monkeypatch, {2: ["q"]})
    run_viewer(sim, vis=0, output_dir=str(tmp_path), max_steps=1000)
    # 3 loop iterations × render_every=5 steps (reference cadence,
    # main.py:94) before 'q' lands.
    assert sim.step_count == 15


def test_viewer_key_handlers(monkeypatch, tmp_path):
    sim = _make_sim()
    # iter 0: cycle vis; iter 1: screenshot + dump; iter 2: pause;
    # iter 3 (paused: no stepping); iter 4: quit.
    _drive(monkeypatch, {0: ["v"], 1: ["s", "d"], 2: ["p"], 4: ["escape"]})
    run_viewer(sim, vis=0, output_dir=str(tmp_path), max_steps=1000)

    shots = list(tmp_path.glob("*.png"))
    dumps = list(tmp_path.glob("step_*.npz"))
    assert len(shots) == 1 and len(dumps) == 1
    with np.load(dumps[0]) as data:
        assert {"v", "p", "dye"} <= set(data.files)
    # paused iterations don't advance the sim: iters 0,1,2 step (15),
    # iters 3,4 are paused.
    assert sim.step_count == 15


def test_viewer_vis_cycle_wraps_without_dye(monkeypatch, tmp_path):
    """'v' cycles through 3 modes when dye is off (reference: r % 3,
    main.py:117-121) — never reaching the dye view."""
    sim = _make_sim(enable_dye=False)
    _drive(monkeypatch, {0: ["v", "v", "v", "v"], 1: ["q"]})
    run_viewer(sim, vis=0, output_dir=str(tmp_path), max_steps=1000)  # must not raise


def test_viewer_initial_vis_clamped_without_dye(monkeypatch, tmp_path):
    """--interactive -vis 3 -no_dye must not crash at the
    first render."""
    sim = _make_sim(enable_dye=False)
    _drive(monkeypatch, {0: ["q"]})
    run_viewer(sim, vis=3, output_dir=str(tmp_path), max_steps=1000)


def test_viewer_max_steps(monkeypatch, tmp_path):
    sim = _make_sim()
    _drive(monkeypatch, {})
    run_viewer(sim, vis=1, output_dir=str(tmp_path), max_steps=10)
    assert sim.step_count == 10


def test_mask_image_facade():
    """Custom-image scenes constructible from the
    façade (parity+ vs fs/boundary_condition.py:508-513)."""
    sim = FluidSimulator.create(1, RES, scheme="upwind", vor_eps=None,
                                mask_image="rabbit")
    assert sim.scene_meta["mask_image"] == "rabbit"
    sim.step(2)
    assert not np.isnan(sim.field_to_numpy()["v"]).any()


def test_viewer_headless_error_message(monkeypatch):
    """Without a working matplotlib the viewer raises a helpful error."""
    import builtins

    sim = _make_sim()
    real_import = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError("no display")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(RuntimeError, match="frame-every"):
        run_viewer(sim)
