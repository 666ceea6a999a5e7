"""``SIGEModel.adopt_full`` and the state bridge it takes from sige_tpu
(``utils/from_jax.py caches_from_flax`` / ``meta_from_flax``).

  * a second model's full pass, its caches and metadata adopted by a
    fresh model of the same weights: ``set_masks`` then ``sparse`` equal
    the plain engine's exactly, for the DDPM U-Net and the SD decoder, in
    the window and tile layouts;
  * the flow of ``tests/test_parallel.py:195-253`` (the tiny SD decoder
    with attention at 8 px, the 8x10 edit): sige_tpu's ``adopt_full`` fed
    its one-device full pass's caches, and the port's fed the same caches
    through ``caches_from_flax`` on the converted weights, agree within
    1e-4 after ``set_masks`` and ``sparse`` (the one-device caches, not
    the 8-device sp ones: this holds the adoption, not the sp reduction);
  * a later ``full`` at another input shape drops what was adopted;
  * ``caches_from_flax`` and ``meta_from_flax`` carry the tiny DDPM
    U-Net's and SD decoder's trees key by key, equal to the port's own
    full pass on the same weights and input.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm import DDPMUNetConfig as JDDPMConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JDDPM
from sige_tpu.models.sd import SDVAEConfig as JVAEConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.nn import SIGEModel as JModel
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.models.sd import SDVAEConfig, SIGEDecoder
from sige_torch.nn import SIGEModel
from sige_torch.utils.from_jax import (caches_from_flax, meta_from_flax,
                                       state_dict_from_flax)
from test_torch_demo import TINY as DDPM_TINY
from test_torch_sd_unet import flax_params, one_torch_thread  # noqa: F401

# tests/test_parallel.py:182, :208
DEC_CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
               resolution=32, num_groups=8)
R = 32  # the DDPM image side and the decoder's image side


def _t(a):
    return torch.from_numpy(np.array(a))


def ddpm_case(seed=0):
    """The tiny DDPM U-Net: (module factory, flax module, original args,
    edited args, masks)."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    t = np.full((1,), 7.0, np.float32)
    m = np.zeros((R, R), bool)
    m[6:14, 10:20] = True
    x1 = x0 + rng.standard_normal(x0.shape).astype(np.float32) * m[
        None, :, :, None]
    masks = downsample_mask(dilate_mask(m, 2), min_res=4)
    return (lambda: SIGEFusedUNet(DDPMUNetConfig(**DDPM_TINY)),
            JDDPM(cfg=JDDPMConfig(**DDPM_TINY)), (x0, t),
            (x1.astype(np.float32), t), masks)


def decoder_case(seed=7):
    """tests/test_parallel.py:205-227: the tiny decoder's latent and the
    8x10 edit of its 32 px image, pyramid to 16 px."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    mask = np.zeros((32, 32), bool)
    mask[8:16, 10:20] = True
    masks = downsample_mask(dilate_mask(mask, 2), min_res=16)
    z_edit = (z + rng.standard_normal(z.shape).astype(np.float32)
              * np.asarray(masks[(16, 16)])[None, :, :, None])
    return (lambda: SIGEDecoder(SDVAEConfig(**DEC_CFG)),
            JDecoder(cfg=JVAEConfig(**DEC_CFG)), (z,),
            (z_edit.astype(np.float32),), masks)


CASES = {"ddpm": ddpm_case, "decoder": decoder_case}


def _host_copy(model):
    """A model's caches and metadata as another process would hand them
    over: every tensor a fresh copy in host memory."""
    caches = {path: [{k: t.detach().to("cpu", copy=True)
                      for k, t in d.items()} for d in slots]
              for path, slots in model.state.caches.items()}
    return caches, model.meta


@pytest.mark.parametrize("layout", ["window", "tiles"])
@pytest.mark.parametrize("case", ["ddpm", "decoder"])
def test_adopted_caches_give_the_plain_engines_sparse(case, layout):
    """A second model's full pass adopted by a fresh model of the same
    weights: ``set_masks`` and ``sparse`` equal the plain engine's,
    exactly; the adopted model holds no plan or pins before set_masks."""
    make, _, args0, args1, masks = CASES[case]()
    plain = SIGEModel(make(), bucket_min=1, layout=layout, device="cpu")
    plain.init(0)
    plain.full(*map(_t, args0))
    caches, meta = _host_copy(plain)
    plain.set_masks(masks)
    want = plain.sparse(*map(_t, args1))

    fresh = SIGEModel(make(), bucket_min=1, layout=layout, device="cpu")
    fresh.module.load_state_dict(plain.module.state_dict())
    fresh.state.pins = {("x",): 1}  # pins it held are dropped
    fresh.adopt_full(caches, meta, *map(_t, args0))
    assert fresh.plan == {} and fresh.plan_host is None
    assert fresh.state.pins == {}
    with pytest.raises(RuntimeError, match="set_masks"):
        fresh.sparse(*map(_t, args1))
    fresh.set_masks(masks)
    assert fresh.active_layout == layout
    got = fresh.sparse(*map(_t, args1))
    assert torch.equal(got, want)


def test_adopt_refuses_caches_of_other_modules():
    make, _, args0, _, _ = ddpm_case()
    model = SIGEModel(make(), device="cpu")
    with pytest.raises(KeyError, match="lacks"):
        model.adopt_full({"no.such.module": [{}]}, {}, *map(_t, args0))
    with pytest.raises(ValueError, match="slots"):
        name = next(iter(model.state.caches))
        model.adopt_full({name: [{}, {}]}, {}, *map(_t, args0))


@functools.lru_cache(maxsize=None)
def _jax_full(case):
    """sige_tpu's one-device full pass: (params, cache, meta, full out)."""
    _, jmodule, args0, _, _ = CASES[case]()
    params = flax_params(jmodule, *args0)
    jm = JModel(jmodule, params, bucket_min=1)
    y = np.asarray(jm.full(*map(jnp.asarray, args0)))
    return params, jax.device_get(jm.cache), jax.device_get(jm.meta), y


def test_reference_flow_agrees_with_sige_tpu_adopt_full():
    """tests/test_parallel.py:195-253 on one device: both packages adopt
    the caches of sige_tpu's full pass, plan the edit, and run sparse."""
    make, jmodule, args0, args1, masks = decoder_case()
    params, cache, meta, _ = _jax_full("decoder")
    jm = JModel(jmodule, bucket_min=1)
    jm.params = params
    jm.adopt_full(cache, meta, *map(jnp.asarray, args0))
    jm.set_masks(masks)
    want = np.asarray(jm.sparse(*map(jnp.asarray, args1)))

    model = SIGEModel(make(), bucket_min=1, device="cpu")
    model.module.load_state_dict(state_dict_from_flax(params), strict=True)
    model.adopt_full(caches_from_flax(cache), meta_from_flax(meta),
                     *map(_t, args0))
    model.set_masks(masks)
    got = model.sparse(*map(_t, args1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_full_at_a_new_shape_drops_what_was_adopted():
    """After ``adopt_full``, a ``full`` at another input shape records new
    metadata and drops the plan: the adopted metadata's resolutions are
    gone, and sparse needs a new ``set_masks``."""
    make, _, args0, args1, masks = decoder_case()
    src = SIGEModel(make(), bucket_min=1, device="cpu")
    src.init(0)
    src.full(*map(_t, args0))
    caches, meta = _host_copy(src)
    model = SIGEModel(make(), bucket_min=1, device="cpu")
    model.module.load_state_dict(src.module.state_dict())
    model.adopt_full(caches, meta, *map(_t, args0))
    model.set_masks(masks)
    model.full(_t(np.zeros((1, 8, 8, 4), np.float32)))
    assert model.plan == {} and model.plan_host is None
    res = {tuple(int(v) for v in g.meta["input_res"][0])
           for _, g in model._gathers}
    assert (32, 32) not in res and (8, 8) in res  # the adopted: 16 and 32
    with pytest.raises(RuntimeError, match="set_masks"):
        model.sparse(*map(_t, args1))


@pytest.mark.parametrize("case", ["ddpm", "decoder"])
def test_state_bridge_round_trips_key_by_key(case):
    """``caches_from_flax`` / ``meta_from_flax`` on sige_tpu's full pass
    give the port's own full pass's caches (within 1e-4 * max(1,
    max|cache|)) and metadata (exactly), key by key, one slot each."""
    make, _, args0, _, _ = CASES[case]()
    params, cache, meta, _ = _jax_full(case)
    model = SIGEModel(make(), bucket_min=1, device="cpu")
    model.module.load_state_dict(state_dict_from_flax(params), strict=True)
    model.full(*map(_t, args0))
    caches = caches_from_flax(cache)
    own = model.state.caches
    assert set(caches) <= set(own)
    assert {p for p, slots in own.items() if slots[0]} == set(caches)
    for path, slots in caches.items():
        assert len(slots) == 1
        assert set(slots[0]) == set(own[path][0]), path
        for name, t in slots[0].items():
            want = own[path][0][name]
            assert t.shape == want.shape and t.dtype == want.dtype
            tol = 1e-4 * max(1.0, want.abs().max().item())
            np.testing.assert_allclose(t.numpy(), want.numpy(), atol=tol,
                                       rtol=0, err_msg=f"{path} {name}")
    got_meta = meta_from_flax(meta)

    def entries(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict) and "geom" not in v:
                yield from entries(v, path + (k,))
            else:
                yield path + (k,), v

    want_meta = dict(entries(model.meta))
    assert dict(entries(got_meta)).keys() == want_meta.keys()
    for path, entry in entries(got_meta):
        assert entry.keys() == want_meta[path].keys(), path
        for k, v in entry.items():
            assert len(v) == len(want_meta[path][k]), (path, k)
            for a, b in zip(v, want_meta[path][k]):
                np.testing.assert_array_equal(a, b, err_msg=f"{path} {k}")
