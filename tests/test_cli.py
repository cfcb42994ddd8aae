"""CLI flag semantics (resume overrides, GIF streaming, platform
checks)."""

import argparse

import numpy as np
import pytest
from PIL import Image

from fluid2d_tpu import cli
from fluid2d_tpu.utils.io import load_checkpoint, write_gif, write_png


# --- resume-override semantics (sentinel defaults, not value equality) ----

def test_resolve_args_tracks_typed_flags():
    parser = cli.build_parser()
    args = parser.parse_args(["-re", "1000000.0", "--steps", "1"])
    typed = cli.resolve_args(args)
    # -re was typed AT its default value and must still count as explicit.
    assert "reynolds_num" in typed
    assert "pressure_iters" not in typed
    # Untyped flags get the fresh-run defaults filled in.
    assert args.pressure_iters == 2
    assert args.advection_scheme == "cip"
    assert args.no_dye is False
    assert args.boundary_condition is None


def test_resume_repassed_default_applies(tmp_path):
    """`--resume ckpt --pressure-iters 2` must restore the default on a
    checkpoint saved with 4 (the r2 footgun: a re-passed default used to
    be indistinguishable from not-given)."""
    common = ["-res", "16", "--output", str(tmp_path)]
    ck1 = str(tmp_path / "a.npz")
    cli.main(["--steps", "2", "--pressure-iters", "4", "--checkpoint", ck1, *common])
    _, cfg1, _ = load_checkpoint(ck1)
    assert cfg1.n_pressure_iter == 4

    # Resume WITHOUT the flag: the stored value sticks.
    ck2 = str(tmp_path / "b.npz")
    cli.main(["--resume", ck1, "--steps", "1", "--checkpoint", ck2, *common])
    _, cfg2, _ = load_checkpoint(ck2)
    assert cfg2.n_pressure_iter == 4

    # Resume WITH the flag at its default value: the default is restored.
    ck3 = str(tmp_path / "c.npz")
    cli.main(["--resume", ck1, "--steps", "1", "--pressure-iters", "2",
              "--checkpoint", ck3, *common])
    _, cfg3, _ = load_checkpoint(ck3)
    assert cfg3.n_pressure_iter == 2


def test_resume_bc_override_discards_stored_mask_note(tmp_path, capsys):
    """Overriding -bc on resume drops a stored mask-image scene;
    that must be said out loud."""
    from fluid2d_tpu.models.simulator import FluidSimulator

    sim = FluidSimulator.create(1, 16, mask_image="dragon", scheme="upwind",
                                vor_eps=None, enable_dye=False)
    ck = tmp_path / "mask.npz"
    sim.save(ck)
    capsys.readouterr()
    loaded = FluidSimulator.load(ck, bc_num=2)
    out = capsys.readouterr().out
    assert "discarded" in out and "dragon" in out
    assert loaded.scene_meta["mask_image"] is None
    # No note when the mask is kept (no bc override).
    loaded2 = FluidSimulator.load(ck)
    assert "discarded" not in capsys.readouterr().out
    assert loaded2.scene_meta["mask_image"] == "dragon"


# --- GIF streaming from disk ----------------------------------------------

def test_write_gif_streams_from_paths(tmp_path):
    paths = []
    rng = np.random.default_rng(0)
    for i in range(3):
        p = tmp_path / f"f{i}.png"
        write_png(p, rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
        paths.append(p)
    gif = tmp_path / "out.gif"
    write_gif(gif, paths)
    with Image.open(gif) as im:
        assert im.n_frames == 3


def test_cli_gif_end_to_end(tmp_path):
    gif = tmp_path / "anim.gif"
    cli.main(["-res", "16", "--steps", "4", "--frame-every", "2",
              "--gif", str(gif), "--output", str(tmp_path)])
    with Image.open(gif) as im:
        assert im.n_frames == 2


# --- mesh argument validation -----------------------------------

def test_make_mesh_rejects_both_count_and_shape():
    from fluid2d_tpu.parallel.sharding import make_mesh

    with pytest.raises(ValueError, match="not both"):
        make_mesh(n_devices=2, shape=(1, 2))
