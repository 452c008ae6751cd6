"""The port's SDEs, score wrapper and PC sampler against the JAX package.

Torch cannot replay JAX's threefry streams, so every draw is made in JAX by
replaying the JAX sampler's own key splits, and handed to the port through
its `noise_fn`. The model is the tiny UNet with random weights carried
across (see test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.conditioning import get_mask_all_lengths as j_all_lengths
from text2protein_tpu.conditioning import length_mask as j_length_mask
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion import sampling as jsampling
from text2protein_tpu.diffusion import sde as jsde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu.models.utils import get_score_fn as j_get_score_fn
from text2protein_tpu_torch.conditioning import get_mask_all_lengths
from text2protein_tpu_torch.conditioning import length_mask
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion import sampling as tsampling
from text2protein_tpu_torch.diffusion import sde as tsde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import build_model
from text2protein_tpu_torch.models.utils import get_score_fn

from torch_port_helpers import (
    C,
    CONTEXT_DIM,
    N,
    NUM_SCALES,
    flax_template,
    random_flax_params,
    rel_max_diff,
    tiny_config_dict,
)

SHAPE = (2, N, N, C)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    cfgd = tiny_config_dict()
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    jmodel = j_build_model(j_load_config(cfgd))
    template = flax_template(jmodel, rng.standard_normal(SHAPE),
                             np.zeros(2, np.float32), ctx, mask)
    params = random_flax_params(template, 0)
    tmodel = build_model(load_config(cfgd), device="cpu")
    tmodel.load_state_dict(
        state_dict_from_flax_params(params, load_config(cfgd)), strict=True)
    return jmodel, params, tmodel, ctx, mask


def _draws(noise):
    """noise_fn handing out the given arrays in order."""
    it = iter(noise)

    def noise_fn(shape):
        z = next(it)
        assert tuple(z.shape) == tuple(shape)
        return torch.from_numpy(np.asarray(z))

    noise_fn.rest = it
    return noise_fn


# ---------------------------------------------------------------- SDE level

@pytest.mark.parametrize("num_steps", [8, 20, 100, 1000, 2000])
def test_time_grid_indices_and_labels_match_jax(num_steps):
    """torch.linspace, which builds the time grid and the sigma ladders,
    may differ from jnp.linspace in the last places (XLA turns the division
    by num - 1 into a multiplication): atol 2e-7 on t in [0, 1]. The VE time
    index, truncated to an int, and the score label, rounded, must not
    differ at all."""
    want = np.asarray(jnp.linspace(1.0, 1e-5, num_steps))
    got = torch.linspace(1.0, 1e-5, num_steps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    js = jsde.VESDE(N=num_steps, sigma_min=0.01, sigma_max=100.0)
    ts = tsde.VESDE(N=num_steps, sigma_min=0.01, sigma_max=100.0)
    np.testing.assert_allclose(ts.discrete_sigmas().numpy(),
                               np.asarray(js.discrete_sigmas), rtol=1e-6)
    jidx = np.asarray((jnp.asarray(want) * (num_steps - 1)).astype(jnp.int32))
    tidx = (torch.from_numpy(got) * (num_steps - 1)).to(torch.int64).numpy()
    np.testing.assert_array_equal(tidx, jidx)
    jlab = np.asarray(jnp.round((1.0 - jnp.asarray(want)) * 1999))
    tlab = torch.round((1.0 - torch.from_numpy(got)) * 1999).numpy()
    np.testing.assert_array_equal(tlab, jlab)


@pytest.mark.parametrize("kind", ["vesde", "vpsde", "subvpsde"])
def test_sde_matches_jax(kind):
    cfg = tiny_config_dict()
    cfg["training"]["sde"] = kind
    js, jeps = jsde.get_sde(j_load_config(cfg))
    ts, teps = tsde.get_sde(load_config(cfg))
    assert jeps == teps and js.N == ts.N
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.asarray(jnp.linspace(1.0, jeps, 7))[[0, 3]]
    for name in ("sde", "marginal_prob") + (
            ("discretize",) if kind != "subvpsde" else ()):
        want = getattr(js, name)(jnp.asarray(x), jnp.asarray(t))
        got = getattr(ts, name)(torch.from_numpy(x), torch.from_numpy(t))
        for w, g in zip(want, got):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
    z = rng.standard_normal(SHAPE).astype(np.float32)
    if kind == "vesde":
        np.testing.assert_allclose(
            ts.prior_sampling(torch.from_numpy(z)).numpy(), z * 100.0)


class _LabelModel(torch.nn.Module):
    """Returns its labels, broadcast: shows the label convention."""

    def forward(self, x, labels, context=None, context_mask=None):
        return labels.reshape(-1, 1, 1, 1) + torch.zeros_like(x)


class _JLabelModel:
    def apply(self, variables, x, labels, context=None, context_mask=None,
              train=False, rngs=None):
        return labels.reshape(-1, 1, 1, 1) + jnp.zeros_like(x)


@pytest.mark.parametrize("kind", ["vesde", "vpsde", "subvpsde"])
def test_score_fn_label_convention_matches_jax(kind):
    """VE: round((T - t)(N - 1)); VP: t(N - 1) and division by the
    discrete std; sub-VP: t * 999 and the continuous std."""
    cfg = tiny_config_dict()
    cfg["training"]["sde"] = kind
    js, _ = jsde.get_sde(j_load_config(cfg))
    ts, _ = tsde.get_sde(load_config(cfg))
    t = np.array(jnp.linspace(1.0, 1e-3, 9))
    x = np.ones((9, 2, 2, 1), np.float32)
    want = j_get_score_fn(js, _JLabelModel(), None)(jnp.asarray(x),
                                                     jnp.asarray(t))
    got = get_score_fn(ts, _LabelModel())(torch.from_numpy(x),
                                          torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_length_masks_match_jax():
    lengths = np.asarray([1, 7, 16], np.int32)
    np.testing.assert_array_equal(
        length_mask(torch.from_numpy(lengths), N).numpy(),
        np.asarray(j_length_mask(jnp.asarray(lengths), N)))
    cfg = tiny_config_dict()
    cfg["data"]["min_res_num"] = 4
    np.testing.assert_array_equal(
        get_mask_all_lengths(load_config(cfg), batch_size=3).numpy(),
        np.asarray(j_all_lengths(j_load_config(cfg), batch_size=3)))


@pytest.mark.parametrize("kind", ["length", "ss", "inpainting"])
def test_apply_condition_matches_jax(kind):
    rng = np.random.default_rng(2)
    shape = (2, N, N, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "length":
        v = np.asarray(j_length_mask(jnp.asarray([5, 12]), N))
        jc, tc = {"length": jnp.asarray(v)}, {"length": torch.from_numpy(v)}
    elif kind == "ss":
        v = rng.standard_normal((2, N, N, 3)).astype(np.float32)
        jc, tc = {"ss": jnp.asarray(v)}, {"ss": torch.from_numpy(v)}
    else:
        coords = rng.standard_normal(shape).astype(np.float32)
        mask = rng.random((2, N, N)) < 0.5
        jc = {"inpainting": {"coords_6d": jnp.asarray(coords),
                             "mask_inpaint": jnp.asarray(mask)}}
        tc = {"inpainting": {"coords_6d": torch.from_numpy(coords),
                             "mask_inpaint": torch.from_numpy(mask)}}
    jx, jm = jsampling.apply_condition(jnp.asarray(x), jc)
    tx, tm = tsampling.apply_condition(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# -------------------------------------------------------------- step level

def _bound_scores(models, num_scales=NUM_SCALES):
    jmodel, params, tmodel, ctx, mask = models
    js = jsde.VESDE(N=num_scales, sigma_min=0.01, sigma_max=100.0)
    ts = tsde.VESDE(N=num_scales, sigma_min=0.01, sigma_max=100.0)
    jscore = j_get_score_fn(js, jmodel, params)
    tscore = get_score_fn(ts, tmodel)

    def jfn(x, t):
        return jscore(x, t, jnp.asarray(ctx), jnp.asarray(mask))

    def tfn(x, t):
        return tscore(x, t, torch.from_numpy(ctx), torch.from_numpy(mask))

    return js, ts, jfn, tfn


@pytest.mark.parametrize("t_value", [1.0, 0.5, 1e-5])
def test_reverse_diffusion_step_matches_jax(models, t_value):
    js, ts, jfn, tfn = _bound_scores(models)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(SHAPE) * 100 * t_value).astype(np.float32)
    t = np.full((2,), t_value, np.float32)
    key = jax.random.PRNGKey(11)
    z = jax.random.normal(key, SHAPE)  # the draw update_fn makes from key
    jx, jmean = jsampling.ReverseDiffusionPredictor(js, jfn).update_fn(
        key, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tx, tmean = tsampling.ReverseDiffusionPredictor(ts, tfn).update_fn(
            _draws([z]), torch.from_numpy(x), torch.from_numpy(t))
    assert rel_max_diff(tx.numpy(), jx) < 1e-5
    assert rel_max_diff(tmean.numpy(), jmean) < 1e-5


@pytest.mark.parametrize("t_value", [1.0, 0.5, 1e-5])
def test_langevin_step_matches_jax(models, t_value):
    js, ts, jfn, tfn = _bound_scores(models)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(SHAPE) * 100 * t_value).astype(np.float32)
    t = np.full((2,), t_value, np.float32)
    key = jax.random.PRNGKey(12)
    # LangevinCorrector.update_fn splits its key into n_steps keys
    z = jax.random.normal(jax.random.split(key, 1)[0], SHAPE)
    jx, jmean = jsampling.LangevinCorrector(js, jfn, 0.17, 1).update_fn(
        key, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tx, tmean = tsampling.LangevinCorrector(ts, tfn, 0.17, 1).update_fn(
            _draws([z]), torch.from_numpy(x), torch.from_numpy(t))
    assert rel_max_diff(tx.numpy(), jx) < 1e-5
    assert rel_max_diff(tmean.numpy(), jmean) < 1e-5


# -------------------------------------------------------- trajectory level

def _pc_draws(key, shape, num_steps, n_steps):
    """The draws of text2protein_tpu's PC sampler, in the order the port's
    sampler asks for them: the prior, then per step the corrector's n_steps
    draws and the predictor's draw (sampling.py's key splits)."""
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, shape)]
    for _ in range(num_steps):
        key, kc, kp = jax.random.split(key, 3)
        draws += [jax.random.normal(k, shape)
                  for k in jax.random.split(kc, n_steps)]
        draws.append(jax.random.normal(kp, shape))
    return draws


@pytest.mark.parametrize("num_steps,cfg_scale", [(8, 1.0), (3, 2.0)])
def test_pc_trajectory_matches_jax(models, num_steps, cfg_scale):
    """A short PC trajectory (num_steps != N, so the sampler re-discretizes
    while the score keeps the model's ladder) under a length condition,
    with every draw made in JAX. Bar: relative max diff < 1e-4, since f32
    rounding differences of the two UNets compound over 2 * num_steps
    evaluations through the Langevin step size."""
    jmodel, params, tmodel, ctx, mask = models
    js = jsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0)
    ts = tsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0)
    lengths = np.asarray([9, 16], np.int32)
    jcond = {"length": j_length_mask(jnp.asarray(lengths), N)}
    tcond = {"length": length_mask(torch.from_numpy(lengths), N)}
    key = jax.random.PRNGKey(5)

    jsampler = jsampling.get_pc_sampler(js, jmodel, SHAPE,
                                        num_steps=num_steps,
                                        cfg_scale=cfg_scale)
    jout, jnfe = jsampler(params, key, condition=jcond,
                          context=jnp.asarray(ctx),
                          context_mask=jnp.asarray(mask))
    noise_fn = _draws(_pc_draws(key, SHAPE, num_steps, 1))
    tsampler = tsampling.get_pc_sampler(ts, tmodel, SHAPE,
                                        num_steps=num_steps,
                                        cfg_scale=cfg_scale)
    tout, tnfe = tsampler(condition=tcond, context=torch.from_numpy(ctx),
                          context_mask=torch.from_numpy(mask),
                          noise_fn=noise_fn)
    assert next(noise_fn.rest, None) is None  # every draw was used
    assert tnfe == jnfe
    assert np.isfinite(tout.numpy()).all()
    np.testing.assert_array_equal(tout.numpy()[..., -1],
                                  np.asarray(jcond["length"], np.float32))
    assert rel_max_diff(tout.numpy(), jout) < 1e-4


def test_sampling_fn_builds_the_pc_sampler_only():
    cfg = load_config(tiny_config_dict())
    ts, eps = tsde.get_sde(cfg)
    model = build_model(cfg, device="cpu")
    assert callable(tsampling.get_sampling_fn(cfg, ts, model, SHAPE, eps))
    cfg.sampling.method = "ode"
    with pytest.raises(NotImplementedError):
        tsampling.get_sampling_fn(cfg, ts, model, SHAPE, eps)
