"""The port's spatial parallelism (``sige_torch/parallel/spatial.py``):
the rows of one request sharded over ``torch.distributed`` ranks, with
the halo exchanges, GroupNorm sums and K/V row gathers written by hand,
against ``sige_tpu.parallel.spatial`` (XLA's SPMD partitioner on
conftest's virtual CPU devices) and against the port's one-process
engine.

The ranks are processes of their own (``tests/torch_mesh_worker.py``:
no JAX), joined in a gloo group through a file under a temporary
directory, each waited on for ``JOIN_S`` and killed after, so a hung rank
fails its test. Every rank takes the same global inputs and returns its
band; one spawn per world size runs every task of the file.

  * the tiny decoder of ``tests/test_parallel.py:175-176`` at 2 and 4
    ranks: ``spatial_apply`` equals ``sige_tpu``'s within 1e-4 and the
    port's one-process dense within 1e-5;
  * the big-canvas composition of ``tests/test_parallel.py:195-253``:
    the sharded full pass, its caches gathered onto one process,
    ``adopt_full``, ``set_masks`` and ``sparse`` equal ``sige_tpu``'s
    flow (its sp full pass adopted on one device) within 1e-4, the
    port's one-process flow within 1e-4, and ``sige_tpu``'s sp caches
    carried by ``caches_from_flax`` / ``meta_from_flax`` into the port
    give the same sparse output within 1e-4. (``sige_tpu``'s own test of
    this flow holds it to 1e-5 and misses by about 1.2e-5; the port
    keeps the 1e-4 contract of the SIGE examples);
  * the gathered caches against the one-process full pass key by key
    (within 1e-5 * max(1, max|cache|)), the metadata exactly and the same
    on every rank, the folded affines bit for bit the same on every rank;
  * the encoder, the DDPM U-Net, the PD U-Net, the SD U-Net (with and
    without its K/V caches) and the GauGAN generators (fused SPADE,
    sub-mobile, vanilla) at 2 ranks against one process within 1e-4, and
    each but the vanilla generator against ``sige_tpu``'s
    ``spatial_apply`` at 2 devices within 1e-4;
  * a mesh of one (no process group) is the plain engine, exactly;
  * the errors: a height the ranks do not divide, an odd band under a
    stride-2 conv, sparse mode with a band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.models.ddpm import DDPMUNetConfig as JDDPMConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JDDPMUNet
from sige_tpu.models.gaugan import SIGEFusedSPADEGenerator as JFusedGen
from sige_tpu.models.gaugan import SIGESubMobileSPADEGenerator as JSubGen
from sige_tpu.models.gaugan import SPADEGenConfig as JGenConfig
from sige_tpu.models.pd import PDUNetConfig as JPDConfig
from sige_tpu.models.pd import SIGEPDUNet as JPDUNet
from sige_tpu.models.sd import SDUNetConfig as JSDUNetConfig
from sige_tpu.models.sd import SDVAEConfig as JVAEConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.models.sd import SIGEEncoder as JEncoder
from sige_tpu.models.sd import SIGESDUNet as JSDUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.parallel import make_spatial_mesh as j_make_spatial_mesh
from sige_tpu.parallel import spatial_apply as j_spatial_apply
from sige_tpu.parallel import spatial_full_apply as j_spatial_full_apply
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig, VanillaSPADEGenerator)
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGEEncoder, SIGESDUNet)
from sige_torch.nn import SIGEModel
from sige_torch.parallel import (BandCaches, gather_caches, gather_rows,
                                 make_spatial_mesh, row_sharding,
                                 spatial_apply, spatial_full_apply)
from sige_torch.utils.from_jax import (caches_from_flax, meta_from_flax,
                                       state_dict_from_flax)
from test_torch_adopt import DEC_CFG, decoder_case
from test_torch_gpu import BAND_CONVS, band_conv_error
from test_torch_mesh import _spawn
from test_torch_sd_unet import TINY_UNET, flax_params, one_torch_thread  # noqa: F401,E501

ATOL = 1e-4
WORLDS = (2, 4)
# the other models, at 2 ranks: (module, config, config fields, whether
# the full pass runs too, the module's other arguments)
DDPM_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(16,), resolution=32,
                 sparse_resolution_threshold=32)
PD_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
               resolution=32, temb_ch=64, head_dim=16,
               sparse_resolution_threshold=16)  # tests/test_pd.py:12
# tests/test_torch_gaugan.py's TINY at twice the side (128x64: latent
# 2x4, one latent row a rank) and its sub-mobile channels
GAUGAN_TINY = dict(ngf=8, semantic_nc=6, crop_size=128, aspect_ratio=2.0,
                   num_upsampling_layers="normal", num_sparse_layers=5)
OTHERS = {
    "encoder": (SIGEEncoder, SDVAEConfig, DEC_CFG, False, {}),
    "ddpm": (SIGEFusedUNet, DDPMUNetConfig, DDPM_TINY, True, {}),
    "pd": (SIGEPDUNet, PDUNetConfig, PD_TINY, False, {}),
    "sd_unet": (SIGESDUNet, SDUNetConfig, TINY_UNET, True, {}),
    "sd_unet_kv": (SIGESDUNet, SDUNetConfig,
                   dict(TINY_UNET, kv_cache_min_tokens=64), True, {}),
    "gaugan": (SIGEFusedSPADEGenerator, SPADEGenConfig, GAUGAN_TINY, True,
               {}),
    "gaugan_sub": (SIGESubMobileSPADEGenerator, SPADEGenConfig, GAUGAN_TINY,
                   True, dict(channels=(4, 4, 4, 6, 4, 3, 3, 4))),
    "gaugan_vanilla": (VanillaSPADEGenerator, SPADEGenConfig,
                       dict(GAUGAN_TINY, main_block_size=None,
                            shortcut_block_size=None, num_sparse_layers=0),
                       False, {}),
}
# the models that are also held against sige_tpu's spatial_apply at 2
# ranks: their sige_tpu twin, whose seeded flax parameters both run on
JAX_TWINS = {
    "encoder": lambda f, kw: JEncoder(cfg=JVAEConfig(**f)),
    "ddpm": lambda f, kw: JDDPMUNet(cfg=JDDPMConfig(**f)),
    "pd": lambda f, kw: JPDUNet(cfg=JPDConfig(**f)),
    "sd_unet": lambda f, kw: JSDUNet(cfg=JSDUNetConfig(**f)),
    "sd_unet_kv": lambda f, kw: JSDUNet(cfg=JSDUNetConfig(**f)),
    "gaugan": lambda f, kw: JFusedGen(cfg=JGenConfig(**f)),
    "gaugan_sub": lambda f, kw: JSubGen(cfg=JGenConfig(**f), **kw),
}
MODEL_KEYS = {SIGEEncoder: "encoder", SIGEFusedUNet: "ddpm",
              SIGEPDUNet: "pd", SIGESDUNet: "sd_unet",
              SIGEFusedSPADEGenerator: "gaugan",
              SIGESubMobileSPADEGenerator: "gaugan_sub",
              VanillaSPADEGenerator: "gaugan_vanilla"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _other_inputs(name):
    rng = np.random.default_rng(11)
    if name == "encoder":
        return (rng.standard_normal((1, 32, 32, 3)).astype(np.float32),)
    if name in ("ddpm", "pd"):
        return (rng.standard_normal((1, 32, 32, 3)).astype(np.float32),
                np.full((1,), 0.7 if name == "pd" else 7.0, np.float32))
    if name.startswith("gaugan"):  # 5 labels in 8x8 blocks + an edge map
        labels = np.kron(rng.integers(0, 5, (8, 16)), np.ones((8, 8), int))
        seg = np.eye(6, dtype=np.float32)[labels][None]
        seg[..., 5] = (rng.random((64, 128)) < 0.1)
        return (seg,)
    return (rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
            np.full((1,), 501.0, np.float32),
            rng.standard_normal((1, 5, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def decoder():
    """The decoder case: sige_tpu's tiny decoder with seeded weights, the
    port's one-process flow on the same weights (dense, full, sparse
    after planning the edit) and sige_tpu's sp flow per world size."""
    _, jmodule, (z,), (z_edit,), masks = decoder_case()
    params = flax_params(jmodule, z)
    sd = state_dict_from_flax(params)
    one = SIGEModel(SIGEDecoder(SDVAEConfig(**DEC_CFG)), bucket_min=1,
                    device="cpu")
    one.module.load_state_dict(sd, strict=True)
    ref = {"dense": one.dense(_t(z)).numpy(), "full": one.full(_t(z)).numpy(),
           "caches": one.state.caches, "meta": one.meta}
    one.set_masks(masks)
    ref["sparse"] = one.sparse(_t(z_edit)).numpy()

    jax_sp = {}
    for n in WORLDS:
        jmesh = j_make_spatial_mesh(n, devices=jax.devices("cpu"))
        dense = np.asarray(j_spatial_apply(jmesh, jmodule, params,
                                           jnp.asarray(z)))
        _, cache, meta = j_spatial_full_apply(jmesh, jmodule, params,
                                              jnp.asarray(z))
        cache, meta = jax.device_get(cache), jax.device_get(meta)
        jm = JModel(jmodule, bucket_min=1)
        jm.params = params
        jm.adopt_full(cache, meta, jnp.asarray(z))
        jm.set_masks(masks)
        jax_sp[n] = {"dense": dense, "cache": cache, "meta": meta,
                     "sparse": np.asarray(jm.sparse(jnp.asarray(z_edit)))}
    return dict(z=z, z_edit=z_edit, masks=masks, sd=sd, one=ref,
                jax=jax_sp)


@pytest.fixture(scope="module")
def others():
    """Each other model's weights (seeded: those with a sige_tpu twin the
    twin's flax parameters, carried over by state_dict_from_flax) and
    one-process outputs; for those with a twin, sige_tpu's spatial_apply
    at 2 ranks on the same parameters."""
    out = {}
    jmesh = j_make_spatial_mesh(2, devices=jax.devices("cpu"))
    for name, (cls, config, fields, full, kwargs) in OTHERS.items():
        model = SIGEModel(cls(config(**fields), **kwargs), bucket_min=1,
                          device="cpu")
        args = _other_inputs(name)
        jax_dense = None
        if name in JAX_TWINS:
            jmodule = JAX_TWINS[name](fields, kwargs)
            params = flax_params(jmodule, *args)
            model.module.load_state_dict(state_dict_from_flax(params),
                                         strict=True)
            jax_dense = np.asarray(j_spatial_apply(
                jmesh, jmodule, params, *map(jnp.asarray, args)))
        else:
            model.init(3)
        rec = {"state": model.module.state_dict(), "args": args,
               "dense": model.dense(*map(_t, args)).numpy(),
               "jax_dense": jax_dense}
        if full:
            rec["full"] = model.full(*map(_t, args)).numpy()
            rec["caches"] = model.state.caches
            rec["meta"] = model.meta
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, decoder, others):
    """The results of every task, by name, on every rank of a spawn per
    world size (run on first use)."""
    done = {}

    def get(world):
        if world in done:
            return done[world]
        tasks = {"decoder": dict(
            kind="spatial", model="decoder", cfg=DEC_CFG, state=decoder["sd"],
            inputs=(decoder["z"],), full=True, masks=decoder["masks"],
            edited=(decoder["z_edit"],))}
        if world == 2:
            for name, (cls, _, fields, full, kwargs) in OTHERS.items():
                tasks[name] = dict(
                    kind="spatial", model=MODEL_KEYS[cls], cfg=fields,
                    kwargs=kwargs, state=others[name]["state"],
                    inputs=others[name]["args"], full=full)
            tasks["errors"] = dict(
                kind="spatial_errors", model="encoder", cfg=DEC_CFG,
                state=others["encoder"]["state"],
                inputs=others["encoder"]["args"], odd_h=18)
        results = _spawn(world, list(tasks.values()),
                         tmp_path_factory.mktemp(f"sp{world}"))
        done[world] = [dict(zip(tasks, r)) for r in results]
        return done[world]

    return get


def _assert_caches(got, want, err=""):
    """Caches in ``EngineState.caches`` form, key by key within 1e-5 *
    max(1, max|cache|)."""
    assert set(got) == set(want)
    for path, slots in want.items():
        assert len(got[path]) == len(slots)
        for g, w in zip(got[path], slots):
            assert set(g) == set(w), path
            for k, t in w.items():
                ref = t.numpy()
                np.testing.assert_allclose(
                    np.asarray(g[k]), ref, rtol=0,
                    atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                    err_msg=f"{err}{path}/{k}")


def _assert_meta(got, want, path=""):
    """Metadata trees equal, every array exactly."""
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_meta(got[k], w, f"{path}/{k}")
        else:
            assert len(got[k]) == len(w), f"{path}/{k}"
            for a, b in zip(got[k], w):
                np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("world", WORLDS)
def test_decoder_dense_matches_sige_tpu(world, decoder, ranks):
    """tests/test_parallel.py:167 at 2 and 4 ranks: every rank's gathered
    output equals sige_tpu's spatial_apply within 1e-4 and the port's
    one-process dense within 1e-5; each rank's band is its rows of it;
    every conv of the decoder but its 1x1 convs exchanged a halo, every
    GroupNorm ran two all-reduces, the mid attention two row gathers."""
    for r, res in enumerate(ranks(world)):
        got = res["decoder"]
        assert got["sp"] == world
        np.testing.assert_allclose(got["dense"], decoder["jax"][world]["dense"],
                                   atol=ATOL, rtol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["dense"], decoder["one"]["dense"],
                                   atol=1e-5, rtol=0, err_msg=f"rank {r}")
        k = got["dense"].shape[1] // world
        np.testing.assert_array_equal(got["rows"],
                                      got["dense"][:, r * k:(r + 1) * k])
        module = SIGEDecoder(SDVAEConfig(**DEC_CFG))
        convs = sum(m.weight.shape[2] > 1 for n, m in module.named_modules()
                    if n and hasattr(m, "weight") and m.weight is not None
                    and m.weight.ndim == 4)
        norms = sum(type(m).__name__ in ("FoldedGroupNorm",)
                    for m in module.modules()) + 1  # + the tail's
        assert got["counts"]["halo"] == convs
        assert got["counts"]["all_reduce"] == 2 * norms
        assert got["counts"]["gather_rows"] == 2


@pytest.mark.parametrize("world", WORLDS)
def test_composition_matches_sige_tpu(world, decoder, ranks):
    """tests/test_parallel.py:195-253: the sharded full pass, its caches
    gathered onto rank 0 and adopted by a one-process model, the edit
    planned and run sparse: equal to sige_tpu's flow (its sp full pass
    adopted on one device) and to the port's one-process flow within
    1e-4; sige_tpu's sp caches carried into the port by
    caches_from_flax / meta_from_flax give the same within 1e-4. The
    sharded full output equals the one-process full output within
    1e-5."""
    got = ranks(world)[0]["decoder"]
    want = decoder["jax"][world]
    np.testing.assert_allclose(got["sparse"], want["sparse"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["sparse"], decoder["one"]["sparse"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["full"], decoder["one"]["full"],
                               atol=1e-5, rtol=0)

    model = SIGEModel(SIGEDecoder(SDVAEConfig(**DEC_CFG)), bucket_min=1,
                      device="cpu")
    model.module.load_state_dict(decoder["sd"], strict=True)
    model.adopt_full(caches_from_flax(want["cache"]),
                     meta_from_flax(want["meta"]), _t(decoder["z"]))
    model.set_masks(decoder["masks"])
    np.testing.assert_allclose(model.sparse(_t(decoder["z_edit"])).numpy(),
                               want["sparse"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_caches_and_meta_match_one_process(world, decoder, ranks):
    """The caches gather_caches assembled on rank 0 equal the one-process
    full pass's key by key; the banded entries are exactly the scatters'
    row maps; every rank recorded the one-process metadata, at the
    global shapes."""
    results = ranks(world)
    got = results[0]["decoder"]
    _assert_caches(got["caches"], decoder["one"]["caches"])
    banded = {(p, k) for p, _, k in got["banded"]}
    maps = {(p, k) for p, slots in decoder["one"]["caches"].items()
            for k, t in slots[0].items() if t.ndim == 4}
    assert banded == maps and len(banded) > 0
    for r, res in enumerate(results):
        assert res["decoder"]["banded"] == got["banded"], f"rank {r}"
        _assert_meta(res["decoder"]["meta"], decoder["one"]["meta"])


@pytest.mark.parametrize("world", WORLDS)
def test_folded_affines_equal_on_every_rank(world, ranks):
    """The caches that are not bands (the folded GroupNorm affines) are
    the same on every rank, bit for bit: adopt_full may take any rank's."""
    results = ranks(world)
    consts = results[0]["decoder"]["consts"]
    assert consts and all(k[2] in ("scale", "shift") for k in consts)
    for r, res in enumerate(results[1:], 1):
        assert set(res["decoder"]["consts"]) == set(consts)
        for k, a in consts.items():
            np.testing.assert_array_equal(res["decoder"]["consts"][k], a,
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", list(OTHERS))
def test_models_at_two_ranks_match_one_process(name, others, ranks):
    """The encoder (stride-2 (0, 1) downsamples, tail norm), the DDPM
    U-Net (timesteps replicated, attention at 16 px), the PD U-Net
    (in-block avg-pool and nearest-2x resamples, multi-head attention),
    the SD U-Net (stride-2 padding-1 downsamples, self-attention gathered,
    cross-attention over the replicated context; also with K/V caches)
    and the GauGAN generators (the seg map's band resized to each level's
    band; the sub-mobile's InstanceNorm statistics all-reduced) at 2
    ranks: the gathered output equals one process within 1e-4 on every
    rank; where the full pass runs, its output within 1e-4, its caches key
    by key and its metadata exactly (the cross-attention's K/V, from the
    replicated context, and the InstanceNorm statistics not banded)."""
    want = others[name]
    results = ranks(2)
    for r, res in enumerate(results):
        got = res[name]
        np.testing.assert_allclose(got["dense"], want["dense"], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")
        if "full" not in want:
            continue
        np.testing.assert_allclose(got["full"], want["full"], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")
        _assert_meta(got["meta"], want["meta"])
    if "full" in want:
        _assert_caches(results[0][name]["caches"], want["caches"])
        banded = {k for _, _, k in results[0][name]["banded"]}
        unbanded = {k[2] for k in results[0][name]["consts"]}
        consts = {"scale", "shift", "k", "v", "in_mean", "in_rstd"}
        assert not banded & consts and unbanded <= consts


@pytest.mark.parametrize("name", list(JAX_TWINS))
def test_models_at_two_ranks_match_sige_tpu(name, others, ranks):
    """The models of the test above that have a sige_tpu twin (all but
    the vanilla SPADE generator), on the twin's flax parameters: the
    gathered output of the 2-rank spatial_apply equals sige_tpu's
    spatial_apply on 2 of conftest's CPU devices within 1e-4 on every
    rank, and so does the port's one-process dense. This holds each
    model's own exchanges (the attentions' K/V row gathers, the SD
    U-Net's local cross-attention, the band-aware nearest resize, the
    all-reduced InstanceNorm) against the reference."""
    want = others[name]["jax_dense"]
    np.testing.assert_allclose(others[name]["dense"], want, atol=ATOL,
                               rtol=0, err_msg="one process")
    for r, res in enumerate(ranks(2)):
        np.testing.assert_allclose(res[name]["dense"], want, atol=ATOL,
                                   rtol=0, err_msg=f"rank {r}")


def test_one_rank_mesh_is_the_plain_engine(decoder):
    """Without a process group the mesh has one rank and no band: dense
    and full equal the plain engine's bit for bit, and the gathers return
    what they are given."""
    mesh = make_spatial_mesh(device="cpu")
    assert mesh.shape == {"sp": 1} and mesh.index == 0
    assert row_sharding(mesh)(16) == slice(0, 16)
    module = SIGEDecoder(SDVAEConfig(**DEC_CFG))
    module.load_state_dict(decoder["sd"])
    z = _t(decoder["z"])
    y = spatial_apply(mesh, module, z)
    assert torch.equal(y, torch.from_numpy(decoder["one"]["dense"]))
    assert gather_rows(mesh, y) is y
    yf, caches, meta = spatial_full_apply(mesh, module, z)
    assert isinstance(caches, BandCaches) and not caches.rows
    assert torch.equal(yf, torch.from_numpy(decoder["one"]["full"]))
    whole = gather_caches(mesh, caches)
    for path, slots in decoder["one"]["caches"].items():
        for g, w in zip(whole[path], slots):
            assert set(g) == set(w)
            assert all(torch.equal(g[k], w[k]) for k in w), path
    _assert_meta(meta, decoder["one"]["meta"])
    with pytest.raises(TypeError, match="BandCaches"):
        gather_caches(mesh, dict(caches))


def test_errors(ranks):
    """A height the ranks do not divide and an odd band under a stride-2
    conv raise ValueError on every rank (before any collective of the
    failing layer, so no rank hangs); sparse mode refuses a band."""
    for r, res in enumerate(ranks(2)):
        msgs = res["errors"]
        assert "not divisible" in msgs["not_divisible"], f"rank {r}"
        assert "odd band" in msgs["odd_band"], f"rank {r}"
        assert "one card" in msgs["sparse"], f"rank {r}"


@pytest.mark.parametrize("shape", list(BAND_CONVS))
def test_band_conv_matches_the_whole_map(shape):
    """The halo form of ``conv2d_nhwc`` on the CPU, two row bands of one
    map simulated in one process (``tests/test_torch_gpu.py``'s card test
    on the CPU): the concatenated bands equal the whole map's conv within
    1e-5 * max(1, max|ref|), for the three conv shapes of the sharded
    paths."""
    assert band_conv_error("cpu", *BAND_CONVS[shape]) <= 1e-5
