"""The port's label-map colorizer (``sige_torch/utils/colorize.py``)
against sige_tpu's: the palettes, ``Colorize``, ``tensor2im`` and
``tensor2label`` give the same arrays exactly, and ``save_visuals``
writes PNGs that the port's reader reads back equal to those arrays and
to the PNGs sige_tpu writes (through PIL)."""

import numpy as np
import pytest

from sige_torch.demo.png import decode_png
from sige_torch.utils import colorize as c
from sige_tpu.utils import colorize as jc


@pytest.mark.parametrize("n", [35, 36, 20, 151])
def test_palette_and_colorize_equal_sige_tpu(n):
    np.testing.assert_array_equal(c.labelcolormap(n), jc.labelcolormap(n))
    assert c.labelcolormap(n).dtype == np.uint8
    labels = np.random.default_rng(n).integers(-2, n + 3, (17, 23))
    got = c.Colorize(n)(labels)
    assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
    np.testing.assert_array_equal(got, jc.Colorize(n)(labels))


@pytest.mark.parametrize("shape", [(1, 16, 24, 3), (16, 24, 3), (16, 24, 1),
                                   (16, 24)])
@pytest.mark.parametrize("normalize", [True, False])
def test_tensor2im_equals_sige_tpu(shape, normalize):
    x = np.random.default_rng(3).uniform(-1.3, 1.3, shape).astype(np.float32)
    got = c.tensor2im(x, normalize=normalize)
    assert got.dtype == np.uint8 and got.shape == (16, 24, 3)
    np.testing.assert_array_equal(
        got, jc.tensor2im(x, normalize=normalize))


@pytest.mark.parametrize("form", ["onehot4", "onehot3", "int3", "int2"])
def test_tensor2label_equals_sige_tpu(form):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 36, (16, 24))
    x = {"onehot4": np.eye(36, dtype=np.float32)[ids][None],
         "onehot3": np.eye(36, dtype=np.float32)[ids],
         "int3": ids[..., None], "int2": ids}[form]
    got = c.tensor2label(x, 36)
    np.testing.assert_array_equal(got, c.Colorize(36)(ids))
    np.testing.assert_array_equal(got, jc.tensor2label(x, 36))


def test_save_visuals_reads_back_equal(tmp_path):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 36, (32, 64))
    visuals = {"original_label": np.eye(36, dtype=np.float32)[ids][None],
               "edited_label": ids,
               "edited_image": rng.uniform(-1, 1, (1, 32, 64, 3)).astype(
                   np.float32)}
    c.save_visuals(str(tmp_path / "port"), visuals, "img0", input_nc=35)
    jc.save_visuals(str(tmp_path / "ref"), visuals, "img0", input_nc=35)
    for kind, v in visuals.items():
        want = (c.tensor2label(v, 36) if kind.endswith("label")
                else c.tensor2im(v))
        for side in ("port", "ref"):
            path = tmp_path / side / kind / "img0.png"
            got = decode_png(path.read_bytes())
            np.testing.assert_array_equal(got, want, err_msg=f"{side} {kind}")
