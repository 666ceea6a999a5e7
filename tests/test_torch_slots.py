"""Cache slots and ``sparse_update`` on the PD U-Net and the GauGAN
generators, the port against sige_tpu (the SD models are in
``tests/test_torch_sd_slots.py``, on the harness here).

The same sequence goes through both, on the tiny configurations of the
models' own port tests and seeded weights bridged with
``utils/from_jax.py``: a full pass per slot (each slot on its own input;
GauGAN's config has no slots, so it runs one), an edit planned and
committed into the last slot with ``sparse_update``, then a second edit
planned over the committed slot, and the original input of slot 0
replayed under that plan (with one slot, the committed edit replayed
under its own plan).
Every output agrees with sige_tpu at atol 1e-4 (fp32 on both sides), and
so does every cache the commit wrote (each scatter's map, by module
path); the replay equals slot 0's full pass, or the commit's output (the
SIGE contract), and the commit touched no tensor of another slot. In the
window layout the chains step aside for the commit and run again for the
second edit (over the committed caches).

The sub-mobile generator's reference is sige_tpu in float64 with exact
InstanceNorm statistics, as in ``tests/test_torch_gaugan.py`` (sige_tpu's
float32 statistics miss the exact function by ~4.6e-4 at this size).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import (compute_difference_mask, dilate_mask,
                                 downsample_mask)
from sige_tpu.models.gaugan import SIGEFusedSPADEGenerator as JGen
from sige_tpu.models.gaugan import SIGESubMobileSPADEGenerator as JSubGen
from sige_tpu.models.gaugan import SPADEGenConfig as JGanConfig
from sige_tpu.models.pd import PDUNetConfig as JPDConfig
from sige_tpu.models.pd import SIGEPDUNet as JPDUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.runners.gaugan_runner import GauGANRunConfig as JRunConfig
from sige_tpu.runners.gaugan_runner import GauGANRunner as JRunner
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig)
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.nn import SIGEModel
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path
from test_torch_gaugan import SUB_CHANNELS
from test_torch_gaugan import TINY as GAN_TINY
from test_torch_gaugan import _exact_sige_tpu, _scramble_stats
from test_torch_pd import CONFIGS as PD_CONFIGS
from test_torch_sd_unet import (ATOL, box_mask, flax_params,  # noqa: F401
                                one_torch_thread)

SLOTS = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def j_cache_leaves(tree, path=()):
    """(module path, cache name, [slots, ...] array) of sige_tpu's cache
    collection."""
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from j_cache_leaves(v, path + (k,))
        else:
            yield path, k, np.asarray(v)


def assert_caches_match(j_cache, state, slot, atol=ATOL):
    """Every cache of sige_tpu's ``slot`` equals the port's by module path
    and name, within ``atol`` times max(1, max |cache|) (deep activations
    reach tens, where fp32 sums differ by tens of ulps, as PERF.md's
    contract states for SD); every scatter map ("original", "residual")
    has one."""
    n = 0
    for path, name, arr in j_cache_leaves(jax.device_get(j_cache)):
        key = ".".join(torch_path(path))
        got = state.caches.get(key, [{}] * (slot + 1))[slot].get(name)
        if got is None:
            assert name not in ("original", "residual"), (key, name)
            continue
        want = arr[slot]
        assert tuple(got.shape) == want.shape, (key, name)
        tol = atol * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.double().numpy(), want, atol=tol,
                                   rtol=0, err_msg=f"{key} {name}")
        n += 1
    assert n, "no cache compared"


class Sequence:
    """One model's slot sequence, run by sige_tpu and by the port.

    ``args[k]``: slot k's original inputs (numpy); ``edit1`` / ``edit2``:
    (masks, inputs) of the committed edit on the last slot and of the
    second edit over it. ``exact`` wraps sige_tpu's run (float64)."""

    def __init__(self, jmodule, params, tmodule, layout, args, edit1, edit2,
                 exact=None, bucket_min=1):
        self.tmodule, self.layout, self.bucket_min = tmodule, layout, \
            bucket_min
        self.args, self.edit1, self.edit2 = args, edit1, edit2
        self.sd = state_dict_from_flax(params)
        self.last = len(args) - 1
        with exact() if exact else contextlib.nullcontext():
            cast = ((lambda a: jnp.asarray(a, jnp.float64)) if exact
                    else jnp.asarray)
            if exact:
                params = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64), params)
            jm = JModel(jmodule, params, layout=layout,
                        bucket_min=bucket_min)
            self.j_full = [np.asarray(jm.full(*map(cast, a), cache_id=k))
                           for k, a in enumerate(args)]
            jm.set_masks(edit1[0])
            self.j_update = np.asarray(jm.sparse(
                *map(cast, edit1[1]), cache_id=self.last,
                sparse_update=True))
            self.j_committed = jax.device_get(jm.cache)
            jm.set_masks(edit2[0])
            self.j_second = np.asarray(jm.sparse(*map(cast, edit2[1]),
                                                 cache_id=self.last))
            jm.set_masks(self.replay[0])
            self.j_replay = np.asarray(jm.sparse(*map(cast, self.replay[1]),
                                                 cache_id=0))

    @property
    def replay(self):
        """(masks, inputs) of slot 0's replay: its original input under
        the second edit's plan, or with one slot the committed edit again
        under its own plan (a commit's output is a fixed point of its
        plan; another plan's windows recompute the committed ring, which
        SIGE's approximation left stale)."""
        if self.last:
            return self.edit2[0], self.args[0]
        return self.edit1

    def check(self):
        """Run the port through the sequence and hold it to sige_tpu's."""
        tm = SIGEModel(self.tmodule, layout=self.layout,
                       bucket_min=self.bucket_min, device="cpu")
        tm.module.load_state_dict(self.sd, strict=True)
        assert tm.cache_slots == len(self.args)
        full = [tm.full(*map(_t, a), cache_id=k).numpy()
                for k, a in enumerate(self.args)]
        for got, want in zip(full, self.j_full):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        tm.set_masks(self.edit1[0])
        assert tm.active_layout == self.layout
        before = [[id(t) for t in tm.state.tensors(k)]
                  for k in range(len(self.args))]
        update = tm.sparse(*map(_t, self.edit1[1]), cache_id=self.last,
                           sparse_update=True).numpy()
        np.testing.assert_allclose(update, self.j_update, atol=ATOL, rtol=0)
        assert np.abs(update - full[self.last]).max() > 1e-3  # it shows
        for k in range(self.last):
            assert [id(t) for t in tm.state.tensors(k)] == before[k]
        assert [id(t) for t in tm.state.tensors(self.last)] != \
            before[self.last]
        assert_caches_match(self.j_committed, tm.state, self.last)
        tm.set_masks(self.edit2[0])
        got = tm.sparse(*map(_t, self.edit2[1]),
                        cache_id=self.last).numpy()
        np.testing.assert_allclose(got, self.j_second, atol=ATOL, rtol=0)
        tm.set_masks(self.replay[0])
        got = tm.sparse(*map(_t, self.replay[1]), cache_id=0).numpy()
        np.testing.assert_allclose(got, self.j_replay, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, full[0] if self.last else update,
                                   atol=ATOL, rtol=0)
        return tm


# --- PD ----------------------------------------------------------------------

R = 32
BOX1, BOX2 = (8, 16, 10, 20), (18, 24, 4, 12)


def _box_edit(x, box, seed, scale=0.5):
    m = box_mask(x.shape[1:3], box)[None, :, :, None]
    noise = np.random.default_rng(seed).standard_normal(x.shape)
    return (x + scale * noise * m).astype(np.float32)


def _pyramid(box, shape, dilation=2):
    return downsample_mask(dilate_mask(box_mask(shape, box), dilation),
                           min_res=4)


@functools.lru_cache(maxsize=None)
def pd_sequence(layout):
    rng = np.random.default_rng(21)
    xs = rng.standard_normal((SLOTS, 1, R, R, 3)).astype(np.float32)
    ls = [np.array([v], np.float32) for v in (1.3, -0.4)]
    args = [(xs[k], ls[k]) for k in range(SLOTS)]
    x1 = _box_edit(xs[-1], BOX1, 1)
    x2 = _box_edit(x1, BOX2, 2)
    cfg = dict(PD_CONFIGS["tiny"], cache_slots=SLOTS)
    params = flax_params(JPDUNet(cfg=JPDConfig(**cfg)), *args[0])
    return Sequence(JPDUNet(cfg=JPDConfig(**cfg)), params,
                    SIGEPDUNet(PDUNetConfig(**cfg)), layout, args,
                    (_pyramid(BOX1, (R, R)), (x1, ls[-1])),
                    (_pyramid(BOX2, (R, R)), (x2, ls[-1])))


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_pd_slots_and_sparse_update_match_sige_tpu(layout):
    pd_sequence(layout).check()


# --- GauGAN ------------------------------------------------------------------

GH, GW = 32, 64
GBOX1 = (GH // 4, GH // 4 + 6, GW // 4, GW // 4 + 10)
GBOX2 = (GH // 2, GH // 2 + 5, GW // 2, GW // 2 + 8)
N_LABELS = GAN_TINY["semantic_nc"] - 1


def _labels_to_input(labels):
    r = JRunner.__new__(JRunner)  # preprocess_input only
    r.run_cfg = JRunConfig(input_nc=N_LABELS)
    return r.preprocess_input(labels)


def _gan_masks(a, b):
    """The runner's mask pyramid of the edit from semantics a to b."""
    mask = dilate_mask(compute_difference_mask(a[0], b[0], eps=1e-3), 1)
    return downsample_mask(mask, min_res=JGanConfig(**GAN_TINY).latent_hw,
                           dilation=1)


@functools.lru_cache(maxsize=None)
def gaugan_sequence(kind, layout):
    rng = np.random.default_rng(0)
    l0 = rng.integers(0, N_LABELS - 1, (GH, GW))
    l1 = l0.copy()
    l1[GBOX1[0]:GBOX1[1], GBOX1[2]:GBOX1[3]] = N_LABELS - 2
    l2 = l1.copy()
    l2[GBOX2[0]:GBOX2[1], GBOX2[2]:GBOX2[3]] = N_LABELS - 3
    s0, s1, s2 = map(_labels_to_input, (l0, l1, l2))
    if kind == "fused":
        jmod, tmod = JGen(cfg=JGanConfig(**GAN_TINY)), \
            SIGEFusedSPADEGenerator(SPADEGenConfig(**GAN_TINY))
    else:
        jmod = JSubGen(cfg=JGanConfig(**GAN_TINY), channels=SUB_CHANNELS)
        tmod = SIGESubMobileSPADEGenerator(SPADEGenConfig(**GAN_TINY),
                                           SUB_CHANNELS)
    params = _scramble_stats(flax_params(jmod, s0))
    return Sequence(jmod, params, tmod, layout, [(s0,)],
                    (_gan_masks(s0, s1), (s1,)), (_gan_masks(s1, s2), (s2,)),
                    exact=_exact_sige_tpu if kind == "sub" else None)


@pytest.mark.parametrize("kind,layout", [("fused", "window"),
                                         ("fused", "tiles"),
                                         ("sub", "window")])
def test_gaugan_sparse_update_matches_sige_tpu(kind, layout):
    """One slot (SPADEGenConfig has no ``cache_slots``, in sige_tpu as
    here): the commit, the second edit over it and the replay."""
    gaugan_sequence(kind, layout).check()


def test_gaugan_chains_step_aside_for_the_commit(monkeypatch):
    """The fused generator's window chain is off under sparse_update (the
    shortcut norm's γβ scatter then commits too) and on for the second
    edit over the committed caches."""
    from sige_torch.models.gaugan import spade

    seq = gaugan_sequence("fused", "window")
    calls = []
    orig = spade.SIGEFusedSPADEResnetBlock._chain_window

    def spy(self, x, seg, ctx):
        calls.append(ctx.sparse_update)
        return orig(self, x, seg, ctx)

    monkeypatch.setattr(spade.SIGEFusedSPADEResnetBlock, "_chain_window",
                        spy)
    seq.check()
    assert calls and not any(calls)
