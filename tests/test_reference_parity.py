"""Golden parity against the reference's OWN source (scene layer).

An oracle-only suite proves parity against
tests/oracle.py, written by the same author — these tests remove that
trust link for the scene/boundary-condition layer by *executing*
``/root/reference/fs/boundary_condition.py`` (unmodified) under the
NumPy-backed taichi stub (tests/taichi_stub.py) and asserting
bit-equality of every produced array.

Covers all 6 scenes × 4 resolutions (including 400 and an odd size),
both constructor paths (dye / no-dye), the ``create_color_map`` ramp
(``fs/boundary_condition.py:125-134``), and the bundled PNG assets.
"""

import numpy as np
import pytest

from fluid2d_tpu.scenes.builder import ASSET_DIR, color_ramp
from fluid2d_tpu.scenes.scenes import build_scene_arrays
from tests.taichi_stub import REFERENCE_ROOT, load_reference_fs

fs = None  # the reference's fs package, loaded by the fixture below


@pytest.fixture(autouse=True, scope="module")
def _reference_fs():
    """Load the reference source once per module; skip when it is absent."""
    global fs
    if not REFERENCE_ROOT.is_dir():
        pytest.skip(f"reference source not found at {REFERENCE_ROOT}")
    fs = load_reference_fs()


def _reference_arrays(num: int, res: int, *, enable_dye: bool = True):
    ref = fs.boundary_condition.get_boundary_condition(num, res, enable_dye=enable_dye)
    dye = ref._bc_dye.arr if enable_dye else None
    return ref._bc_const.arr, ref._bc_mask.arr, dye


@pytest.mark.parametrize("res", [36, 81, 100, 400])
@pytest.mark.parametrize("num", [1, 2, 3, 4, 5, 6])
def test_scene_bit_exact(num, res):
    """Every scene array byte-matches the reference's own builders."""
    if num == 4 and res % 4:
        # The reference's own builder crashes when the dye ramp length
        # y_res//4 - 2 disagrees with the inflow slice (res % 4 != 0,
        # fs/boundary_condition.py:388-396); parity = we raise too.
        with pytest.raises(ValueError, match="broadcast"):
            fs.boundary_condition.get_boundary_condition(num, res, enable_dye=True)
        with pytest.raises(ValueError, match="broadcast"):
            build_scene_arrays(num, res)
        return
    ref_bc, ref_mask, ref_dye = _reference_arrays(num, res)
    bc, mask, dye = build_scene_arrays(num, res)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(bc, ref_bc)
    np.testing.assert_array_equal(dye, ref_dye)
    assert mask.dtype == ref_mask.dtype == np.uint8
    assert bc.dtype == ref_bc.dtype == np.float32
    assert dye.dtype == ref_dye.dtype == np.float32


@pytest.mark.parametrize("num", [1, 4])
def test_scene_no_dye_constructor(num):
    """The reference's no-dye path captures identical bc/mask arrays
    (``fs/boundary_condition.py:516-521``)."""
    ref_bc, ref_mask, _ = _reference_arrays(num, 64, enable_dye=False)
    bc, mask, _ = build_scene_arrays(num, 64)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(bc, ref_bc)


@pytest.mark.parametrize("n_samples", [2, 7, 100, 1599])
def test_color_map_bit_exact(n_samples):
    colors = [
        np.array([0.2, 1.1, 1.1]),
        np.array([1.1, 0.2, 0.2]),
        np.array([0.2, 0.2, 1.1]),
        np.array([1.1, 1.1, 0.2]),
    ]
    ref = fs.boundary_condition.create_color_map(colors, n_samples)
    np.testing.assert_array_equal(color_ramp(colors, n_samples), ref)


def test_mask_assets_identical_bytes():
    """The bundled obstacle silhouettes are byte-identical to the
    reference's (scene 6 bit-parity depends on it)."""
    for name in ("dragon", "rabbit", "aircraft"):
        ours = (ASSET_DIR / f"{name}.png").read_bytes()
        theirs = (REFERENCE_ROOT / "images" / "bc_mask" / f"{name}.png").read_bytes()
        assert ours == theirs, name


def test_scene3_rng_stream():
    """Scene 3's obstacle layout comes from the legacy global seed-123
    stream (``fs/boundary_condition.py:353-355``); the mask equality in
    test_scene_bit_exact already proves it, this pins the count too."""
    _, mask, _ = build_scene_arrays(3, 100)
    _, ref_mask, _ = _reference_arrays(3, 100)
    assert (mask == 1).sum() == (ref_mask == 1).sum() > 0
