"""The port's metric backbones (``sige_torch.metrics.backbones``) against
``sige_tpu``'s Flax ones, on the CPU:

  * each converter on a synthetic reference-layout state dict, written
    from a seeded Flax tree by ``tests/test_backbones.py``'s independently
    written inverse mappings (torchvision ``alexnet`` and
    ``inception_v3``, with the keys a converter drops; the DataParallel
    DRNSeg), gives exactly what ``sige_torch.utils.from_jax`` gives for
    that tree;
  * with those weights in both packages, ``AlexNetFeatures`` at 64^2,
    ``InceptionV3Features`` at 107^2 and ``DRNSeg`` at 64x96 (not square:
    the 8x transposed-conv upsample) equal the Flax modules within
    1e-4 * max(1, max|ref|) (the DRN's logits ~1e1: its bottlenecks'
    ``bn3`` scales are drawn small, as ``seeded_state`` draws them);
    ``LPIPSAlex`` distances agree within 1e-5 and ``CityscapesSegmenter``
    labels are equal away from near-ties;
  * ``FIDInception``'s resize to 299 equals ``jax.image.resize``
    (bilinear, antialiased where it shrinks) within 1e-5, up from 32^2
    and down from 512^2 and 256x512.

Flax trees come from ``jax.eval_shape`` (no init compile) with seeded
values; each Flax reference is traced once per module (module-scoped
fixtures, ``jax.jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.metrics import backbones as jbb
from sige_torch.metrics import backbones as tbb
from sige_torch.metrics.backbones.common import BN3_SCALE, nchw, run
from sige_torch.metrics.backbones.inception import resize_299
from sige_torch.utils import from_jax
from test_backbones import _drn_sd, _inception_sd, _t
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)


def seeded_tree(module, shape, seed=0):
    """A seeded parameter tree of numpy arrays for ``module`` at input
    ``shape``: kernels He-normal, BatchNorm scales 1 + 0.1 N(0, 1),
    biases and running means 0.1 N(0, 1), running variances in
    [0.5, 1.5], and a bottleneck's last scale (``bn3``) ``BN3_SCALE`` times its
    draw (the statistics of ``sige_torch``'s ``seeded_state``)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            jnp.zeros(shape, jnp.float32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name, shp = path[-1].key, s.shape
        if name == "kernel":
            x = rng.standard_normal(shp) * np.sqrt(2.0 / np.prod(shp[:-1]))
        elif name == "running_var":
            x = rng.uniform(0.5, 1.5, shp)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shp)
            if path[-2].key == "bn3":
                x *= BN3_SCALE
        else:
            x = 0.1 * rng.standard_normal(shp)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _port(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# --- AlexNet and LPIPS --------------------------------------------------------

@pytest.fixture(scope="module")
def alex():
    tree = seeded_tree(jbb.AlexNetFeatures(), (1, 64, 64, 3), seed=1)
    sd = {}
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        sd[f"features.{idx}.weight"] = _t(tree[f"conv{i}"]["kernel"])
        sd[f"features.{idx}.bias"] = np.asarray(tree[f"conv{i}"]["bias"])
    sd["classifier.1.weight"] = np.zeros((10, 9216), np.float32)  # dropped
    rng = np.random.default_rng(2)
    lins = {f"lin{i}.model.1.weight":
            np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32)
            for i, c in enumerate((64, 192, 384, 256, 256))}
    return tree, sd, lins


def test_alexnet_converter(alex):
    tree, sd, lins = alex
    _same_state(tbb.convert_alexnet(sd), from_jax.alexnet_state_from_flax(tree))
    ours = tbb.convert_lpips_lins(lins)
    theirs = jbb.convert_lpips_lins(lins)
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    back = from_jax.lpips_state_from_lins(theirs)
    assert all(np.array_equal(back[k].numpy(), lins[k]) for k in lins)


def test_alexnet_features_match_flax(alex):
    tree, _, _ = alex
    x = np.random.default_rng(3).uniform(-2, 2, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jax.jit(jbb.AlexNetFeatures().apply)({"params": tree},
                                                jnp.asarray(x))
    mod = _port(tbb.AlexNetFeatures(), from_jax.alexnet_state_from_flax(tree))
    got = run(mod, nchw(x, mod))
    assert [t.shape[1] for t in got] == [64, 192, 384, 256, 256]
    for g, r in zip(got, ref):
        _close(_nhwc(g), r)


@pytest.mark.parametrize("with_lins", [True, False])
def test_lpips_alex_distances_match(alex, with_lins):
    _, sd, lins = alex
    lins = lins if with_lins else None
    theirs = jbb.LPIPSAlex(sd, lins)
    ours = tbb.LPIPSAlex(sd, lins, device="cpu")
    assert all(np.allclose(a, b, rtol=0, atol=0)
               for a, b in zip(ours.lins, theirs.lins))
    rng = np.random.default_rng(4)
    a = rng.random((64, 64, 3)).astype(np.float32) * 2 - 1
    b = a.copy()
    b[20:30, 20:30] = -b[20:30, 20:30]
    mask = np.zeros((64, 64), bool)
    mask[20:30, 20:30] = True
    assert ours(a, a) == pytest.approx(0.0, abs=1e-6)
    for m in (None, mask):
        d_ours, d_theirs = ours(a, b, mask=m), theirs(a, b, mask=m)
        assert d_ours > 0
        assert d_ours == pytest.approx(d_theirs, rel=1e-5)


# --- InceptionV3 and FID ------------------------------------------------------

@pytest.fixture(scope="module")
def inception():
    tree = seeded_tree(jbb.InceptionV3Features(), (1, 107, 107, 3), seed=5)
    sd = _inception_sd(tree)
    # keys the converter drops
    sd["fc.weight"] = np.zeros((10, 2048), np.float32)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.zeros((), np.int64)
    return tree, sd


def test_inception_converter(inception):
    tree, sd = inception
    _same_state(tbb.convert_inception_v3(sd),
                from_jax.inception_state_from_flax(tree))


def test_inception_features_match_flax(inception):
    tree, _ = inception
    x = np.random.default_rng(6).uniform(-1, 1, (2, 107, 107, 3)).astype(
        np.float32)
    ref = jax.jit(jbb.InceptionV3Features().apply)({"params": tree},
                                                    jnp.asarray(x))
    mod = _port(tbb.InceptionV3Features(),
                from_jax.inception_state_from_flax(tree))
    got = run(mod, nchw(x, mod)).numpy()
    assert got.shape == (2, 2048)
    _close(got, ref)


@pytest.mark.parametrize("hw", [(32, 32), (512, 512), (256, 512)])
def test_resize_299_matches_jax_image_resize(hw):
    x = np.random.default_rng(7).random((2, *hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear")
    got = _nhwc(resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


# --- DRN-D-105 and the segmenter ----------------------------------------------

@pytest.fixture(scope="module")
def drn():
    tree = seeded_tree(jbb.DRNSeg(classes=19), (1, 64, 96, 3), seed=8)
    sd = _drn_sd(tree)
    sd["module.up.weight"] = np.zeros((19, 1, 16, 16), np.float32)  # dropped
    img = np.random.default_rng(9).random((64, 96, 3)).astype(np.float32)
    # the segmenter's input normalization
    x = ((img - jbb.CityscapesSegmenter.MEAN)
         / jbb.CityscapesSegmenter.STD)[None]
    ref = jax.jit(jbb.DRNSeg(classes=19).apply)({"params": tree},
                                                 jnp.asarray(x))
    return tree, sd, img, x, np.asarray(ref)


def test_drn_seg_converter(drn):
    tree, sd, _, _, _ = drn
    _same_state(tbb.convert_drn_seg(sd), from_jax.drn_state_from_flax(tree))


def test_drn_seg_matches_flax(drn):
    tree, _, _, x, ref = drn
    mod = _port(tbb.DRNSeg(classes=19), from_jax.drn_state_from_flax(tree))
    got = _nhwc(run(mod, nchw(x, mod)))
    assert got.shape == (1, 64, 96, 19)
    assert np.abs(ref).max() < 1e3  # the limit stays < 0.1
    _close(got, ref)


def test_cityscapes_segmenter_labels_match(drn):
    """The port's segmenter against the argmax of the Flax DRNSeg on the
    normalized image (``sige_tpu``'s ``CityscapesSegmenter``), at every
    pixel whose top-2 logit gap exceeds 1e-3 * max|logit|."""
    _, sd, img, _, ref = drn
    logits = ref[0]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3 * np.abs(logits).max()
    got = tbb.CityscapesSegmenter(sd, device="cpu")(img)
    want = logits.argmax(-1)
    assert got.shape == (64, 96) and clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def test_untrained_backbones_are_seeded():
    """Without weights each backbone draws the same values every time (a
    dry run of the pipeline; the numbers mean nothing)."""
    a = tbb.LPIPSAlex(None, None, device="cpu").module.state_dict()
    b = tbb.LPIPSAlex(None, None, device="cpu").module.state_dict()
    _same_state(a, b)
    assert not torch.equal(a["features.0.weight"],
                           torch.zeros_like(a["features.0.weight"]))
