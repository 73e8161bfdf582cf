"""The control: the reference itself in the program's place, computed in
bfloat16, the precision below the configurations' float32, fails each
cell's comparison at a tiny size (on the card, at the cells' own sizes:
``calibrate.py``)."""
import pytest
import torch

import calibrate
from conftest import make_cell
from srtbench import check, spec


@pytest.mark.parametrize("config", ["large_mesh", "mega_mesh"])
def test_bfloat16_reference_fails(config, tmp_path):
    root, bd, name = make_cell(tmp_path, config, subdivisions=3)
    cfg, mix, md = calibrate._pieces(name, root, bd)
    limits = spec.limits(name, bd)
    for r in calibrate.control_readings(cfg, mix, md, [5, 2 ** 31 + 9], 3,
                                        "cpu"):
        assert not check.judge(r, limits), r
        assert r["gap"] > 5 * limits["gap"]["limit"], r


def test_compare_reads_bias_and_nan():
    import numpy as np
    from reference.tonemap import tonemap_u8
    ref = np.ones((100, 3)) * 4.0
    img = tonemap_u8(ref, 4)[0]
    assert check.compare(ref, ref, 4, img) == {
        "gap": 0.0, "nonfinite": 0, "image_levels": 0}
    off = ref * 1.01
    assert check.compare(off, ref, 4, img)["gap"] == pytest.approx(0.02)
    nan = ref.copy()
    nan[3, 1] = np.nan
    assert check.compare(nan, ref, 4, img)["nonfinite"] == 1
    assert check.compare(nan, nan, 4, img) == {
        "gap": 0.0, "nonfinite": 0, "image_levels": 0}
    assert not check.judge({"gap": float("nan"), "nonfinite": 0},
                           {"gap": {"limit": 1.0}, "nonfinite": {"limit": 0}})


def test_image_levels_against_the_port_tonemap():
    """The plain tonemap gives the port's u8 image of the same canvas
    (truncation, ACES, gamma 2.0), and a stale or darker image reads in
    levels."""
    import numpy as np
    from reference.tonemap import tonemap_u8
    from simple_raytracer_tpu_torch.ops.tonemap import tonemap_u8 as port
    g = np.random.default_rng(3)
    canvas = g.gamma(0.7, 1.5, size=(4096, 3)) * 9.0
    ours, finite = tonemap_u8(canvas, 9)
    theirs = port(torch.tensor(canvas, dtype=torch.float32), 9).numpy()
    assert finite.all()
    assert np.abs(ours - theirs.astype(np.int64)).max() <= 1
    assert check.compare(canvas, canvas, 9, theirs)["image_levels"] <= 1
    dark = port(torch.tensor(canvas, dtype=torch.float32), 10).numpy()
    assert check.compare(canvas, canvas, 9, dark)["image_levels"] >= 3
