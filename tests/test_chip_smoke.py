"""chip_smoke.py's phases at small sizes on the CPU (the same functions
the script runs on the card), its refusal to report without a GPU, and
its last line."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parents[1]


def test_device_phase_accepts_expected_platform():
    info = cs.phase_device("cpu")
    assert info["platform"] == "cpu" and info["count"] >= 1


def test_device_phase_rejects_missing_gpu():
    with pytest.raises(cs.SmokeError, match="expected gpu devices"):
        cs.phase_device("gpu")


def test_main_fails_without_gpu(capsys):
    with pytest.raises(cs.SmokeError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_format():
    line = cs.result_line("cpu")
    assert "\n" not in line
    got = json.loads(line)
    assert got["ok"] is True
    assert set(got["device"]) == {"platform", "kind", "count"}
    assert got["device"]["platform"] == "cpu"
    assert isinstance(got["device"]["count"], int)


def test_result_line_rejects_other_platform():
    with pytest.raises(cs.SmokeError):
        cs.result_line("gpu")


def test_main_path_phase(tmp_path, capsys):
    """CLI run with log, dump and checkpoint; resume continues the step
    count; all four views render."""
    rate = cs.phase_main_path("cpu", res=16, steps=4, chunk=2, out_dir=tmp_path)
    assert rate["steps_per_s"] > 0
    out = capsys.readouterr().out
    assert "Device: cpu " in out
    assert (tmp_path / "resumed" / "step_000006.npz").exists()


def test_main_path_phase_rejects_bad_chunk(tmp_path):
    with pytest.raises(cs.SmokeError, match="multiple of chunk"):
        cs.phase_main_path("cpu", res=16, steps=5, chunk=2, out_dir=tmp_path)


@pytest.mark.parametrize("scheme", ["upwind", "kk", "cip"])
def test_parity_phase(scheme):
    runs = cs.phase_parity("cpu", res=16, steps=2, oracle_schemes=(scheme,))
    assert len(runs) == 3
    for rel in runs.values():
        assert {"v", "p", "dye", "vx", "dyey_alt"} <= set(rel)
        assert all(r == 0.0 for r in rel.values())  # one device on both sides


def test_seeded_state_is_smooth_and_finite():
    import numpy as np

    from fluid2d_tpu.config import SimConfig
    from fluid2d_tpu.scenes.compile import get_scene

    scene = get_scene(2, 16)
    cfg = SimConfig.create(resolution=16, scheme="cip", enable_dye=True)
    a, b = cs.seeded_state(scene, cfg, 0), cs.seeded_state(scene, cfg, 0)
    assert np.array_equal(a.v, b.v)
    assert not np.array_equal(a.v, cs.seeded_state(scene, cfg, 1).v)
    assert np.isfinite(a.v).all() and np.abs(a.v).max() > 0
    assert (np.asarray(a.v)[:, ~np.asarray(scene.fluid)] == 0).all()


@pytest.mark.parametrize("preset", [1, 2, 3, 4, 5, 6])
def test_reach_phase(preset):
    worst = cs.phase_reach("cpu", presets=[preset], steps=2, res_cap=16)
    assert 0 < worst[preset] < cs.BF16_REL


def test_four_device_phase():
    errs = cs.phase_four_devices("cpu", res=64, steps=2)
    assert set(errs) == {"halo", "gspmd"}
    assert all(e <= cs.SHARD_TOL for e in errs.values())


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole script on one card, in a process of its own."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
