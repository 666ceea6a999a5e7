"""The port's safety checker (``sige_torch.models.sd.safety``) against
``sige_tpu.models.sd.safety`` on the CPU:

  * ``preprocess_images`` shrinking (512^2 -> 224), growing (64^2 -> 224)
    and non-square (512x768 and 768x512: the shortest edge leads), atol
    1e-4 (``sige_tpu`` resizes with ``jax.image.resize(..., "bicubic")``:
    Keys' cubic with a = -0.5, antialiased when it shrinks);
  * ``cosine_similarity``, ``safety_head`` (3-decimal rounding, the 0.01
    special-care adjustment) and ``convert_safety_head``;
  * the CLIP vision trunk's pooled features and the projected
    ``image_embeds``, atol 1e-4, with the weights of a tiny
    ``FlaxCLIPVisionModel`` carried by ``utils/from_jax.py``, and from a
    synthetic snapshot through ``from_pretrained``; the same NSFW
    decisions (seeded thresholds that one image trips and another does
    not) and the same blackout.

``sige_tpu``'s ``from_pretrained`` reads the trunk's weights only from a
file whose keys are ``vision_model.*`` (it strips one ``vision_model.``
and adds one back, which ``transformers``' converter then misses on the
checker's own nested ``vision_model.vision_model.*``); the port reads
both, and the nested layout is held to the flat one.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sige_tpu.models.sd import safety as jsafety
from sige_torch.models.sd import safety as tsafety
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

ATOL = 1e-4
TINY = tsafety.CLIPVisionConfig(hidden_size=16, intermediate_size=32,
                                num_hidden_layers=2, num_attention_heads=2,
                                patch_size=14)
P = 8  # projection width


def _images(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (1, 64, 64, 3),
                                   (1, 512, 768, 3), (1, 768, 512, 3),
                                   (1, 224, 224, 3)],
                         ids=["shrink", "grow", "wide", "tall", "same"])
def test_preprocess_matches_sige_tpu(shape):
    x = _images(shape)
    got = tsafety.preprocess_images(x, device="cpu").numpy()
    want = np.asarray(jsafety.preprocess_images(x))
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cosine_and_head_match_sige_tpu():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=s).astype(np.float32) for s in ((6, 8), (5, 8)))
    np.testing.assert_allclose(
        tsafety.cosine_similarity(torch.as_tensor(a), torch.as_tensor(b)),
        np.asarray(jsafety.cosine_similarity(a, b)), atol=1e-6, rtol=0)
    # one concept along e0, one special-care concept along e1: clean,
    # flagged, and flagged only through the 0.01 adjustment (as
    # tests/test_safety_watermark.py)
    concept = np.eye(1, 8, 0, dtype=np.float32)
    special = np.eye(1, 8, 1, dtype=np.float32)
    thr = np.array([0.5], np.float32)

    def vec(c0, c1):
        v = np.zeros(8, np.float32)
        v[0], v[1], v[7] = c0, c1, np.sqrt(max(0.0, 1 - c0 ** 2 - c1 ** 2))
        return v

    embeds = np.concatenate([np.stack([vec(0.9, 0.0), vec(0.49, 0.0),
                                       vec(0.495, 0.8)]), a])
    args = (embeds, concept, thr, special, thr)
    got = tsafety.safety_head(*map(torch.as_tensor, args))
    want = jsafety.safety_head(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got, want)
    assert list(got[:3]) == [True, False, True]


def test_convert_safety_head_equal():
    sd = chip_smoke.safety_state(TINY, P, 0, device="cpu")
    got, want = tsafety.convert_safety_head(sd), jsafety.convert_safety_head(
        sd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["visual_projection"].shape == (TINY.hidden_size, P)


@functools.lru_cache(maxsize=None)
def _flax_vision():
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import FlaxCLIPVisionModel

    model = FlaxCLIPVisionModel(HFConfig(**dataclasses.asdict(TINY)),
                                _do_init=True, seed=2)
    return model, jax.tree_util.tree_map(np.asarray, model.params)


def test_vision_trunk_matches_flax():
    """Pooled features of the port's trunk against the Flax model that
    ``sige_tpu``'s ``vision_fn`` runs, on ``sige_tpu``'s pixels."""
    fmodel, params = _flax_vision()
    sd = state_dict_from_flax(params)
    trunk = tsafety.CLIPVisionModel(TINY)
    assert set(trunk.state_dict()) == set(sd)
    trunk.load_state_dict(sd, strict=True)
    pv = jsafety.preprocess_images(_images((3, 300, 200, 3), 3))
    want = np.asarray(fmodel(pixel_values=jnp.transpose(pv, (0, 3, 1, 2)))
                      .pooler_output)
    with torch.inference_mode():
        got = trunk(torch.tensor(np.asarray(pv)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.pooler_output.numpy(), want, atol=ATOL,
                               rtol=0)
    assert got.last_hidden_state.shape == (3, 257, TINY.hidden_size)


@functools.lru_cache(maxsize=None)
def _snapshots(root):
    """(flat, nested) snapshots of one seeded checker whose thresholds
    split ``_images((2, 512, 384, 3), 4)`` (``chip_smoke.split_thresholds``:
    image 0 trips concept 0, image 1 does not): the flat one with the
    trunk at ``vision_model.*`` (what ``sige_tpu`` reads), the nested one
    in the checker's own layout."""
    sd = chip_smoke.safety_state(TINY, P, 0, device="cpu")
    trunk = chip_smoke.vision_trunk(sd, TINY)
    pv = tsafety.preprocess_images(_images((2, 512, 384, 3), 4),
                                   device="cpu").permute(0, 3, 1, 2)
    with torch.inference_mode():
        embeds = trunk(pv).pooler_output @ sd["visual_projection.weight"].T
    chip_smoke.split_thresholds(sd, embeds)
    flat = {k[len("vision_model."):] if k.startswith("vision_model.") else k:
            v for k, v in sd.items()}
    paths = (os.path.join(root, "flat"), os.path.join(root, "nested"))
    for path, state in zip(paths, (flat, sd)):
        chip_smoke.write_safety_snapshot(path, TINY, P, state)
    return paths


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    return _snapshots(str(tmp_path_factory.mktemp("safety")))


def test_checker_from_pretrained_matches_sige_tpu(snapshots):
    flat, nested = snapshots
    images = _images((2, 512, 384, 3), 4)
    theirs = jsafety.SafetyChecker.from_pretrained(flat)
    want_pooled = np.asarray(theirs.vision_fn(
        jsafety.preprocess_images(images)))
    want_embeds = want_pooled @ np.asarray(
        theirs.head["visual_projection"])
    want_checked, want_nsfw = theirs(images)
    assert want_nsfw == [True, False]
    for path in (flat, nested):
        ours = tsafety.SafetyChecker.from_pretrained(path, device="cpu")
        with torch.inference_mode():
            pooled = ours.vision_fn(tsafety.preprocess_images(
                images, device="cpu"))
        np.testing.assert_allclose(pooled.numpy(), want_pooled, atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(ours.image_embeds(images).numpy(),
                                   want_embeds, atol=ATOL, rtol=0)
        checked, nsfw = ours(images)
        assert nsfw == want_nsfw
        np.testing.assert_array_equal(checked, want_checked)
        assert (checked[0] == 0).all()
        np.testing.assert_array_equal(checked[1], images[1])


def test_checker_with_an_injected_vision_fn():
    """``sige_tpu``'s own end-to-end test: a ``vision_fn`` crafted so that
    image 0 projects onto concept 0 and image 1 is orthogonal to every
    concept; both packages flag image 0 only."""
    rng = np.random.default_rng(1)
    D, Pj = 16, 8
    proj = rng.normal(size=(D, Pj)).astype(np.float32)
    concept = rng.normal(size=(2, Pj)).astype(np.float32)
    special = rng.normal(size=(1, Pj)).astype(np.float32)
    pinv_t = np.linalg.pinv(proj).T
    ortho = np.linalg.svd(np.concatenate([concept, special]))[2][-1]
    unit = concept[0] / np.linalg.norm(concept[0])

    def vision_fn(pixel_values):
        assert tuple(pixel_values.shape[1:]) == (224, 224, 3)
        out = np.zeros((pixel_values.shape[0], D), np.float32)
        out[0], out[1] = pinv_t @ unit, pinv_t @ ortho
        return out

    head = {"concept_embeds": concept,
            "concept_thresholds": np.array([0.9, 0.9], np.float32),
            "special_embeds": special,
            "special_thresholds": np.array([0.9], np.float32),
            "visual_projection": proj}
    images = _images((2, 32, 32, 3), 1)
    ours = tsafety.SafetyChecker(head, vision_fn=vision_fn, device="cpu")
    theirs = jsafety.SafetyChecker(head, vision_fn=vision_fn)
    assert ours(images)[1] == theirs(images)[1] == [True, False]


def test_checker_needs_weights_and_a_gpu(snapshots, monkeypatch):
    with pytest.raises(FileNotFoundError, match="safety checker weights"):
        tsafety.SafetyChecker({}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsafety.SafetyChecker.from_pretrained(snapshots[1])
