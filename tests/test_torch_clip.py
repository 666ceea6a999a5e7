"""The port's CLIP tokenizer and text encoder (``sige_torch.models.sd``)
against their oracles on the CPU, from synthetic snapshots in the
``openai/clip-vit-large-patch14`` file layout (``chip_smoke.py``'s
writers: a seeded byte-level BPE vocabulary, seeded weights at tiny
widths):

  * the tokenizer gives the ids of ``transformers.CLIPTokenizer`` (which
    ``sige_tpu`` calls; ``ftfy`` is absent here as on the card's host)
    for a stated list of prompts: over 77 tokens, contractions, runs of
    digits, accented and CJK letters, the empty prompt, specials written
    in the text, control characters; and pads with the snapshot's
    ``pad_token``;
  * the text encoder's ``last_hidden_state`` equals ``sige_tpu``'s
    ``FrozenCLIPEmbedder`` over an injected tiny ``FlaxCLIPTextModel``
    whose weights go through ``utils/from_jax.py`` (atol 1e-4), also
    loaded from the snapshot's ``pytorch_model.bin`` and from an LDM
    checkpoint's ``cond_stage_model.transformer.*`` keys (with and
    without ``text_model.``);
  * a hub id resolves as ``from_pretrained(local_files_only=True)``
    does; a missing snapshot raises ``FileNotFoundError``.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from sige_tpu.models.sd.clip import FrozenCLIPEmbedder as JEmbedder
from sige_tpu.models.sd.clip import encode_prompts as j_encode_prompts
from sige_torch.models.sd.clip import (CLIPTextConfig, CLIPTextModel,
                                       FrozenCLIPEmbedder,
                                       _model_from_sd_state_dict,
                                       encode_prompts, resolve_snapshot)
from sige_torch.models.sd.tokenizer import CLIPTokenizer
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

ATOL = 1e-4
TINY = CLIPTextConfig(vocab_size=514 + 400, hidden_size=16,
                      intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=2)
PROMPTS = [
    "",
    "a photograph of an astronaut riding a horse",
    "it's the cat's toy; they're here, we've seen, I'm sure, you'll, he'd",
    "Room 101 has 2048 chairs and 3.14159 tables!!!",
    "café naïve résumé Ångström São Paulo",
    "東京タワーと富士山 的 风景 한국어",
    "  lots   of\twhite\nspace  ",
    "UPPER Case MiXeD",
    "<|endoftext|> written in text <|startoftext|>",
    " ".join(["word"] * 100),
    "emoji 🚀🔥 and symbols ©®™ — “quotes”",
    "tab\x00null\x07bell\u200bzero-width",
    "'''s''t 'quoted' it''s",
    "a" * 300,
]


def _hf_ids(tok, prompts):
    return tok(prompts, truncation=True, max_length=77, padding="max_length",
               return_tensors="np")["input_ids"]


@functools.lru_cache(maxsize=None)
def _snapshot(tmp_root):
    """A tiny CLIP text snapshot under ``tmp_root``: the directory."""
    path = os.path.join(tmp_root, "clip-tiny")
    chip_smoke.write_clip_snapshot(
        path, TINY, chip_smoke.clip_text_state(TINY, 0, device="cpu"), 0)
    return path


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return _snapshot(str(tmp_path_factory.mktemp("clip")))


@pytest.fixture(scope="module")
def tokenizers(snapshot):
    return (CLIPTokenizer.from_pretrained(snapshot),
            transformers.CLIPTokenizer.from_pretrained(snapshot))


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_tokenizer_ids_equal_transformers(tokenizers, prompt):
    ours, theirs = tokenizers
    got = ours([prompt])["input_ids"]
    np.testing.assert_array_equal(got, _hf_ids(theirs, [prompt]))
    assert got.shape == (1, 77) and got[0, 0] == ours.bos_token_id
    assert ours.eos_token_id in got[0]  # truncation keeps the end token


def test_tokenizer_batch_merges_and_padding(tokenizers):
    ours, theirs = tokenizers
    got = ours(PROMPTS)["input_ids"]
    np.testing.assert_array_equal(got, _hf_ids(theirs, PROMPTS))
    # the empty prompt: start, end, then padding
    assert list(got[0, :3]) == [ours.bos_token_id, ours.eos_token_id,
                                ours.pad_token_id]
    # ordinary words merge (ids past the 512 byte symbols)
    words = got[1][1:list(got[1]).index(ours.eos_token_id)]
    assert (words >= 512).any() and len(words) < len(PROMPTS[1])
    # digits split one by one; over 77 tokens truncates to 75 + 2
    assert len(ours.tokenize("2048")) == 4
    assert len(ours.tokenize(PROMPTS[-1])) > 75 and got[-1, -1] == \
        ours.eos_token_id


def test_tokenizer_pad_token_from_the_snapshot(snapshot, tmp_path):
    """A snapshot whose ``special_tokens_map.json`` pads with ``!`` (as
    SD 2's OpenCLIP tokenizer does) pads with its id."""
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(snapshot, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    (tmp_path / "special_tokens_map.json").write_text(json.dumps(
        {"pad_token": "!"}))
    ours = CLIPTokenizer.from_pretrained(str(tmp_path))
    theirs = transformers.CLIPTokenizer.from_pretrained(str(tmp_path))
    assert ours.pad_token_id == theirs.pad_token_id != ours.eos_token_id
    np.testing.assert_array_equal(ours(PROMPTS[:3])["input_ids"],
                                  _hf_ids(theirs, PROMPTS[:3]))


@functools.lru_cache(maxsize=None)
def _flax_model():
    """A tiny ``FlaxCLIPTextModel`` and its parameters as numpy."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import FlaxCLIPTextModel

    model = FlaxCLIPTextModel(HFConfig(**dataclasses.asdict(TINY)),
                              _do_init=True, seed=1)
    return model, jax.tree_util.tree_map(np.asarray, model.params)


def test_flax_tree_loads_strictly():
    _, params = _flax_model()
    sd = state_dict_from_flax(params)
    model = CLIPTextModel(TINY)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


def test_text_encoder_matches_sige_tpu(snapshot, tokenizers):
    ours_tok, theirs_tok = tokenizers
    fmodel, params = _flax_model()
    model = CLIPTextModel(TINY)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    ours = FrozenCLIPEmbedder(tokenizer=ours_tok, model=model, device="cpu")
    theirs = JEmbedder(tokenizer=theirs_tok, model=fmodel)
    got = encode_prompts(PROMPTS, embedder=ours)
    want = np.asarray(j_encode_prompts(PROMPTS, embedder=theirs))
    assert got.shape == want.shape == (len(PROMPTS), 77, TINY.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    one = ours("a photograph of an astronaut riding a horse")
    np.testing.assert_allclose(one.numpy(), want[1:2], atol=ATOL, rtol=0)


def test_text_encoder_from_the_snapshot_matches_sige_tpu(snapshot):
    """``pytorch_model.bin`` (with an old ``position_ids`` buffer and a
    ``text_projection`` beside ``text_model.*``) and ``config.json``."""
    from transformers import FlaxCLIPTextModel

    ours = FrozenCLIPEmbedder(model_path=snapshot, device="cpu")
    theirs = JEmbedder(
        tokenizer=transformers.CLIPTokenizer.from_pretrained(snapshot),
        model=FlaxCLIPTextModel.from_pretrained(snapshot, from_pt=True))
    assert ours.model.cfg == TINY
    np.testing.assert_allclose(ours(PROMPTS[:4]).numpy(),
                               np.asarray(theirs(PROMPTS[:4])), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("text_model", [True, False],
                         ids=["text_model", "older"])
def test_text_encoder_from_an_ldm_checkpoint(snapshot, text_model):
    """``cond_stage_model.transformer.text_model.*`` and the older keys
    without ``text_model.``, ``position_ids`` dropped, give the snapshot's
    encoder."""
    sd = chip_smoke.clip_text_state(TINY, 0, device="cpu")
    ldm = {"model.diffusion_model.x": torch.zeros(1)}
    for k, v in sd.items():
        if k.startswith("text_model."):
            k = k if text_model else k[len("text_model."):]
            ldm["cond_stage_model.transformer." + k] = v.numpy()
    model = _model_from_sd_state_dict(ldm, cfg=TINY)
    emb = FrozenCLIPEmbedder(model_path=snapshot, model=model, device="cpu")
    want = FrozenCLIPEmbedder(model_path=snapshot, device="cpu")
    torch.testing.assert_close(emb(PROMPTS[:3]), want(PROMPTS[:3]),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="cond_stage_model"):
        _model_from_sd_state_dict({"first_stage_model.x": np.zeros(1)})


def _hub(root, snapshot, name="abc123", ref=True):
    base = root / "models--openai--clip-vit-large-patch14"
    (base / "snapshots").mkdir(parents=True)
    os.symlink(snapshot, base / "snapshots" / name)
    if ref:
        (base / "refs").mkdir()
        (base / "refs" / "main").write_text(name)
    return str(base / "snapshots" / name)


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
def test_hub_id_resolves_like_local_files_only(snapshot, tmp_path,
                                               monkeypatch, env):
    for var in ("HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    root = tmp_path / ("hub" if env == "HF_HUB_CACHE" else "home")
    want = _hub(root / "hub" if env == "HF_HOME" else root, snapshot,
                ref=env == "HF_HUB_CACHE")
    monkeypatch.setenv(env, str(root))
    assert resolve_snapshot("openai/clip-vit-large-patch14") == want
    got = encode_prompts(["", "a church"], device="cpu")
    direct = encode_prompts(["", "a church"], model_path=snapshot,
                            device="cpu")
    torch.testing.assert_close(got, direct, atol=0, rtol=0)


def test_missing_snapshot_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        FrozenCLIPEmbedder(device="cpu")
    with pytest.raises(FileNotFoundError):
        encode_prompts(["", "a church"], model_path=str(tmp_path / "none"),
                       device="cpu")


def test_embedder_needs_a_gpu_unless_asked_for_the_cpu(snapshot,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrozenCLIPEmbedder(model_path=snapshot)
