"""The port against the JAX package at the repo's reference
configurations, on the CPU.

The families: `configs/test_config.yml` (f32, N=256, attention at 8, 16
and 32, a 4096-wide caption), its variants `test_config_large.yml` (a
wider 8x8 level, 3 res blocks) and `pod_config.yml` (attention at 8 only,
a 128-wide caption), and the 4096-wide caption configs at L=128
(`cond_length*.yml`, `cond_ss*.yml`, `no_cond.yml`: C=5 or C=8, length,
ss and inpainting conditions). Each is built from its yml with `nf` and
`ch_mult` narrowed (the yml's N, levels, res blocks, attention
resolutions, heads, caption width, conditions and SDE stay), random
weights everywhere (`proj_out` included) carried to flax by the JAX
package's `flax_params_from_torch_state` and back by the port's
`state_dict_from_flax_params`, and captions of abstract length through
the hash encoder, so that the cross-attention runs at caption buckets of
128 to 512 keys (past the 512-token cut for pod_config). Bars: the score
forward relative max diff < 2e-5 (the UNet bar), the DSM loss with
injected t and z rtol 2e-4, one PC step (Langevin corrector,
reverse-diffusion predictor, the yml's conditions applied) with injected
draws relative max diff < 1e-5.

The JAX model's `apply` is jit-compiled once per architecture and shared
by its score, loss and sampler steps (each eager call would compile every
op anew); its attention takes the JAX package's CPU route.

Then the flash kernels' plain versions at reduced sizes of the shape
kinds these configs give the card (masked Tk 192, 320 and 512 with a
fully masked row, D=128, 512 and 1024) against the Pallas kernels run in
interpret mode, and the hash encoder's buckets and its 512-token cut on
abstract-length captions against the JAX encoder.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import text2protein_tpu.ops.flash as jflash
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion import losses as jlosses
from text2protein_tpu.diffusion import sampling as jsampling
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.interop.torch_port import flax_params_from_torch_state
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu.models.utils import get_score_fn as j_get_score_fn
from text2protein_tpu.text import encoder as jenc
from text2protein_tpu_torch.conditioning import length_mask
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.helix_records import abstract_caption
from text2protein_tpu_torch.diffusion import losses as tlosses
from text2protein_tpu_torch.diffusion import sampling as tsampling
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import (
    build_model,
    init_random_weights,
)
from text2protein_tpu_torch.models.utils import get_score_fn
from text2protein_tpu_torch.ops import flash as tflash
from text2protein_tpu_torch.text import encoder as tenc

from torch_port_helpers import (  # noqa: F401  (a fixture)
    one_torch_thread,
    rel_max_diff,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# yml: (nf, ch_mult, the hash tokens of each caption of the batch). The
# narrowed widths keep every attention head at 8 (the flash gate's
# D % 8) and give test_config_large's 8x8 level twice the others' width,
# as its yml does. The captions put each architecture's cross-attention in
# another bucket (the longest caption's; at L=128 a second row masked
# shorter), pod_config past the 512-token cut. The N=256 models run at
# batch 1. The caption configs of one channel count have one architecture
# and share their captions, so that JAX compiles once.
FAMILIES = {
    "test_config.yml": (8, (1, 1, 1, 8, 8, 8), (300,)),
    "test_config_large.yml": (8, (1, 1, 1, 8, 8, 16), (100,)),
    "pod_config.yml": (8, (1, 1, 1, 8, 8, 8), (700,)),
    "cond_length.yml": (8, (1, 1, 1, 8, 8, 8), (60, 190)),
    "cond_length_no_ss.yml": (8, (1, 1, 1, 8, 8, 8), (60, 190)),
    "cond_length_inpainting.yml": (8, (1, 1, 1, 8, 8, 8), (100, 440)),
    "cond_ss.yml": (8, (1, 1, 1, 8, 8, 8), (100, 440)),
    "cond_ss_inpainting.yml": (8, (1, 1, 1, 8, 8, 8), (100, 440)),
    "no_cond.yml": (8, (1, 1, 1, 8, 8, 8), (100, 440)),
}
SCORE_TOL = 2e-5
LOSS_RTOL = 2e-4
PC_TOL = 1e-5


def _configs(name):
    nf, ch_mult, _ = FAMILIES[name]
    jcfg, tcfg = (load(str(CONFIGS / name)) for load in (j_load_config,
                                                         load_config))
    for cfg in (jcfg, tcfg):
        cfg.model.nf = nf
        cfg.model.ch_mult = ch_mult
        cfg.model.dropout = 0.0
    return jcfg, tcfg


class _Jitted:
    """A flax module whose `apply` is jit-compiled: the JAX score, loss and
    sampler steps call `model.apply`, here through one compiled function
    per architecture."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("train",))


_ARCHITECTURES = {}


def _architecture(jcfg, tcfg):
    """(jitted JAX model, flax params, port model) of one architecture,
    built once: random port weights (`init_random_weights`: nothing zero,
    proj_out included) carried to flax by the JAX package's
    `flax_params_from_torch_state` and back into the port model by
    `state_dict_from_flax_params` (strict)."""
    m, d = tcfg.model, tcfg.data
    key = (d.max_res_num, d.num_channels, m.nf, tuple(m.ch_mult),
           m.num_res_blocks, tuple(m.attn_resolutions), m.context_dim)
    if key not in _ARCHITECTURES:
        tmodel = init_random_weights(build_model(tcfg, device="cpu"), 0)
        params = flax_params_from_torch_state(
            {k: v.numpy() for k, v in tmodel.state_dict().items()},
            d.num_channels, d.max_res_num, m.nf, tuple(m.ch_mult),
            m.num_res_blocks, tuple(m.attn_resolutions))
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_state_dict(state_dict_from_flax_params(params, tcfg),
                               strict=True)
        _ARCHITECTURES[key] = (_Jitted(j_build_model(jcfg)), params,
                               tmodel)
    return _ARCHITECTURES[key]


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(config, JAX config, JAX model, flax params, port model, context,
    mask): the same random weights in both packages, the captions through
    the port's hash encoder."""
    name = request.param
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(0)
    captions = [abstract_caption(rng, t) for t in FAMILIES[name][2]]
    ctx, mask = tenc.build_text_encoder(tcfg).encode(captions)
    assert ctx.shape[2] == tcfg.model.context_dim
    return (tcfg, jcfg, *_architecture(jcfg, tcfg), ctx, mask)


def _maps(cfg, b, seed):
    """(b, N, N, C) maps in [-1, 1], the length mask as the last channel
    (the first row shorter than N); the pair mask, the lengths and the
    generator."""
    rng = np.random.default_rng(seed)
    n, c = cfg.data.max_res_num, cfg.data.num_channels
    coords = rng.uniform(-1, 1, (b, n, n, c)).astype(np.float32)
    lengths = np.array([n // 2 + 3, n])[:b]
    row = np.arange(n)[None, :] < lengths[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords[..., -1] = mask_pair
    return coords * mask_pair[..., None], mask_pair, lengths, rng


def test_score_forward_matches_jax(family):
    """One forward, a label of the 2000-step ladder per row."""
    cfg, _, jmodel, params, tmodel, ctx, mask = family
    x, _, _, rng = _maps(cfg, len(ctx), 1)
    x = x * 10 + rng.standard_normal(x.shape).astype(np.float32)
    labels = np.asarray([1500.0, 3.0], np.float32)[:len(ctx)]
    # as `get_model_fn` calls it, so that the compiled function is shared
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(labels),
                                   context=jnp.asarray(ctx),
                                   context_mask=jnp.asarray(mask),
                                   train=False, rngs=None))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(labels),
                     torch.from_numpy(ctx), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == x.shape
    assert rel_max_diff(got, want) < SCORE_TOL


def test_dsm_loss_matches_jax(family):
    """The DSM loss with the yml's conditions (dropout 0, so train=False
    is the same function; it shares the score's compiled forward),
    injected t and z; the SS block dropout's draw recomputed from the JAX
    key's split and injected; a random inpainting mask where the yml
    inpaints."""
    cfg, jcfg, jmodel, params, tmodel, ctx, mask = family
    condition = tuple(cfg.model.condition)
    b = len(ctx)
    coords, mask_pair, _, rng = _maps(cfg, b, 2)
    n = cfg.data.max_res_num
    spans = np.full((b, 32, 2), -1, np.int32)
    spans[0, :2] = [[2, 9], [20, 40]]
    spans[-1, 2:3] = [[45, n - 7]]
    batch = {"coords_6d": coords, "mask_pair": mask_pair, "context": ctx,
             "context_mask": mask, "ss_spans": spans}
    if "inpainting" in condition:
        batch["mask_inpaint"] = rng.uniform(size=(b, n, n)) < 0.5
    t = np.asarray([0.6, 0.03], np.float32)[:b]
    z = rng.standard_normal(coords.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    drop = np.array(jax.random.uniform(jax.random.split(key, 6)[1],
                                       (b, 32)) < 0.2)
    jsde, _ = j_get_sde(jcfg)
    tsde, _ = get_sde(cfg)
    want = jlosses.get_sde_loss_fn(jsde, jmodel, train=False,
                                   condition=condition)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        t=jnp.asarray(t), z=jnp.asarray(z))
    with torch.no_grad():
        got = tlosses.get_sde_loss_fn(tsde, tmodel, train=False,
                                      condition=condition)(
            None, {k: torch.from_numpy(np.array(v)) for k, v in
                   batch.items()},
            t=torch.from_numpy(t), z=torch.from_numpy(z),
            ss_drop=torch.from_numpy(drop))
    assert np.isfinite(float(want))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_pc_step_matches_jax(family):
    """One step of the PC sampler at t = 0.5 of the yml's schedule: the
    length condition (and the yml's ss and inpainting conditions) applied
    to a prior draw, the Langevin corrector and the reverse-diffusion
    predictor, the conditioned entries restored after each, every draw
    made in JAX from the keys the JAX sampler's step splits."""
    cfg, jcfg, jmodel, params, tmodel, ctx, mask = family
    condition = tuple(cfg.model.condition)
    b = len(ctx)
    coords, _, lengths, rng = _maps(cfg, b, 3)
    n, shape = cfg.data.max_res_num, coords.shape
    jcond = {"length": np.asarray(length_mask(torch.from_numpy(lengths),
                                              n))}
    if "ss" in condition:
        jcond["ss"] = coords[..., 4:7]
    if "inpainting" in condition:
        jcond["inpainting"] = {"coords_6d": coords,
                               "mask_inpaint": rng.uniform(size=(b, n, n))
                               < 0.5}
    tcond = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   jcond)
    jcond = jax.tree_util.tree_map(jnp.asarray, jcond)
    prior = (rng.standard_normal(shape) * cfg.model.sigma_max).astype(
        np.float32)
    key, kc, kp = jax.random.split(jax.random.PRNGKey(9), 3)
    draws = [jax.random.normal(jax.random.split(kc, 1)[0], shape),
             jax.random.normal(kp, shape)]
    vec_t = np.full((b,), 0.5, np.float32)
    snr = float(cfg.sampling.snr)

    jsde, _ = j_get_sde(jcfg)
    jscore = j_get_score_fn(jsde, jmodel, params, train=False)

    def jfn(x, t):
        return jscore(x, t, jnp.asarray(ctx), jnp.asarray(mask))

    x, cmask = jsampling.apply_condition(jnp.asarray(prior), jcond)
    x0 = x
    x, _ = jsampling.LangevinCorrector(jsde, jfn, snr, 1).update_fn(
        kc, x, jnp.asarray(vec_t))
    x = jnp.where(cmask, x, x0)
    x, _ = jsampling.ReverseDiffusionPredictor(jsde, jfn).update_fn(
        kp, x, jnp.asarray(vec_t))
    want = np.asarray(jnp.where(cmask, x, x0))

    tsde, _ = get_sde(cfg)
    tscore = get_score_fn(tsde, tmodel, train=False)

    def tfn(x, t):
        return tscore(x, t, torch.from_numpy(ctx), torch.from_numpy(mask))

    it = iter(draws)

    def noise_fn(s):
        return torch.from_numpy(np.array(next(it)).reshape(s))

    with torch.no_grad():
        x, cmask = tsampling.apply_condition(torch.from_numpy(prior), tcond)
        x0 = x
        x, _ = tsampling.LangevinCorrector(tsde, tfn, snr, 1).update_fn(
            noise_fn, x, torch.from_numpy(vec_t))
        x = torch.where(cmask, x, x0)
        x, _ = tsampling.ReverseDiffusionPredictor(tsde, tfn).update_fn(
            noise_fn, x, torch.from_numpy(vec_t))
        got = torch.where(cmask, x, x0).numpy()
    assert next(it, None) is None
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    assert rel_max_diff(got, want) < PC_TOL


# ------------------------------------------------------------ flash kernels


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        jflash.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(
        jflash, "flash_attention_fwd", jflash.flash_attention_fwd.__wrapped__)
    monkeypatch.setattr(
        jflash, "flash_attention_bwd", jflash.flash_attention_bwd.__wrapped__)
    yield


# (B, H, Tq, Tk, D, masked): reduced sizes of the new kinds of call. The
# cross-attention over caption buckets of 192, 320 and 512 keys (a fully
# masked batch row), test_config_large's transformer heads of 128 (self
# and cross) and its AttnBlock at D=1024, test_config's AttnBlock at
# D=512
KERNEL_SHAPES = [
    (2, 2, 64, 192, 64, True),
    (2, 2, 32, 320, 64, True),
    (2, 1, 64, 512, 32, True),
    (2, 2, 64, 64, 128, False),
    (2, 2, 64, 128, 128, True),
    (1, 1, 64, 64, 512, False),
    (1, 1, 64, 64, 1024, False),
]


def _inputs(b, h, tq, tk, d, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                  for t in (tq, tk, tk, tq))
    mask = None
    if masked:
        lengths = rng.integers(1, tk + 1, size=b)
        lengths[-1] = 0  # a fully masked row
        mask = np.arange(tk)[None, :] < lengths[:, None]
    return q, k, v, g, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("b,h,tq,tk,d,masked", KERNEL_SHAPES)
def test_flash_forward_matches_pallas_at_the_new_shapes(interpret_pallas, b,
                                                        h, tq, tk, d,
                                                        masked):
    """The forward's plain version against the Pallas forward: out and lse
    within atol/rtol 1e-5 (f32), a fully masked row's out 0 in both."""
    q, k, v, _, mask = _inputs(b, h, tq, tk, d, masked, 0)
    scale = d**-0.5
    want_out, want_lse = jflash.flash_attention_fwd(
        _j(q), _j(k), _j(v), scale=scale, kv_mask=_j(mask))
    got_out, got_lse = tflash.flash_attention_fwd(
        _t(q), _t(k), _t(v), scale, _t(mask))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy().reshape(-1),
                               np.asarray(want_lse).reshape(-1), atol=1e-5,
                               rtol=1e-5)
    if masked:
        assert not got_out[-1].any() and not np.asarray(want_out)[-1].any()


@pytest.mark.parametrize("b,h,tq,tk,d,masked", KERNEL_SHAPES)
def test_flash_backward_matches_pallas_at_the_new_shapes(interpret_pallas,
                                                         b, h, tq, tk, d,
                                                         masked):
    """The backward's plain version against the Pallas backward on the
    same residuals (the JAX forward's out and lse): dq, dk, dv within atol
    1e-5 and rtol 1e-5 of their scale's largest entry over 1 (sums of up
    to 1024 products in another order). Every shape here passes the JAX
    backward gate (`supports_bwd`), masked ones included."""
    q, k, v, g, mask = _inputs(b, h, tq, tk, d, masked, 1)
    assert tflash.supports_bwd(_t(q), _t(k), _t(v))
    scale = d**-0.5
    out, lse = jflash.flash_attention_fwd(_j(q), _j(k), _j(v), scale=scale,
                                          kv_mask=_j(mask))
    want = jflash.flash_attention_bwd(_j(q), _j(k), _j(v), out, lse, _j(g),
                                      scale=scale, kv_mask=_j(mask))
    got = tflash.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale, _t(mask))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(x.numpy(), w, atol=atol, rtol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------ hash encoder


# hash tokens of the batch's captions: one batch in each 64-token bucket
# from 64 to 512, and past the 512-token cut
BUCKET_CAPTIONS = [(40, 12), (64, 1), (65, 100), (150, 191), (192, 250),
                   (300, 40), (330, 384), (385, 400), (449, 500), (511,),
                   (512, 9), (513, 200), (600, 601)]


@pytest.mark.parametrize("tokens", BUCKET_CAPTIONS,
                         ids=lambda t: "x".join(map(str, t)))
def test_hash_encoder_buckets_abstract_captions_as_jax(tokens):
    """test_config.yml's text section (4096 wide, 64-token buckets, 512
    at most): the port's encode equals the JAX encoder's (atol 0), is
    padded to the bucket of the longest caption (cut at 512), masks each
    row to its own tokens, and `padded_width` gives that width from the
    tokens alone."""
    cfg = load_config(str(CONFIGS / "test_config.yml"))
    got_enc = tenc.build_text_encoder(cfg)
    want_enc = jenc.build_text_encoder(j_load_config(str(CONFIGS /
                                                         "test_config.yml")))
    rng = np.random.default_rng(sum(tokens))
    captions = [abstract_caption(rng, t) for t in tokens]
    got, want = got_enc.encode(captions), want_enc.encode(captions)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    width = min(512, -(-max(tokens) // 64) * 64)
    assert got[0].shape == (len(tokens), width, 4096)
    np.testing.assert_array_equal(got[1].sum(1),
                                  [min(t, 512) for t in tokens])
    assert got_enc.padded_width(captions) == width
