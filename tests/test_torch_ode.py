"""The port's ODE and hybrid samplers, and the sampler dispatch, against the
JAX package (text2protein_tpu/diffusion/ode.py).

Every draw is made in JAX by replaying the JAX sampler's own key splits and
handed to the port through its `noise_fn`. The model is the tiny UNet with
random weights carried across (see test_torch_model.py). Trajectories are
held to a relative max diff < 1e-4, the PC trajectory test's bar: f32
rounding differences of the two UNets compound over the evaluations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.conditioning import length_mask as j_length_mask
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion import ode as jode
from text2protein_tpu.diffusion import sde as jsde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.conditioning import length_mask
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion import ode as tode
from text2protein_tpu_torch.diffusion import sampling as tsampling
from text2protein_tpu_torch.diffusion import sde as tsde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import build_model

from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    CONTEXT_DIM,
    N,
    NUM_SCALES,
    flax_template,
    one_torch_thread,
    random_flax_params,
    rel_max_diff,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPE = (2, N, N, C)
TRAJ_TOL = 1e-4


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
        return torch.from_numpy(np.array(z))

    noise_fn.rest = it
    return noise_fn


def _ode_draws(key, shape, final_langevin):
    """get_ode_sampler's draws: the prior, then one per Langevin step."""
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, shape)]
    for _ in range(final_langevin):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, shape))
    return draws


def _hybrid_draws(key, shape, pc_steps, n_steps):
    """get_hybrid_sampler's draws: the prior, then per tail step the
    corrector's n_steps draws and the predictor's draw."""
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, shape)]
    for _ in range(pc_steps):
        key, kc, kp = jax.random.split(key, 3)
        draws += [jax.random.normal(k, shape)
                  for k in jax.random.split(kc, n_steps)]
        draws.append(jax.random.normal(kp, shape))
    return draws


def _conditions():
    lengths = np.asarray([9, 16], np.int32)
    return ({"length": j_length_mask(jnp.asarray(lengths), N)},
            {"length": length_mask(torch.from_numpy(lengths), N)})


def _sdes():
    return (jsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0),
            tsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0))


@pytest.mark.parametrize("final_langevin,denoise", [(2, True)])
def test_ode_trajectory_matches_jax(models, final_langevin, denoise):
    """Six Heun steps (num_steps != N: the drift's SDE is re-discretized,
    the score keeps the model's ladder), the final Langevin churn with its
    RMS step size and the terminal Tweedie step, under a length
    condition."""
    jmodel, params, tmodel, ctx, mask = models
    js, ts = _sdes()
    jcond, tcond = _conditions()
    key = jax.random.PRNGKey(7)
    jsampler = jode.get_ode_sampler(js, jmodel, SHAPE, num_steps=6,
                                    denoise=denoise,
                                    final_langevin=final_langevin)
    jout, jnfe = jsampler(params, key, condition=jcond,
                          context=jnp.asarray(ctx),
                          context_mask=jnp.asarray(mask))
    noise_fn = _draws(_ode_draws(key, SHAPE, final_langevin))
    tsampler = tode.get_ode_sampler(ts, tmodel, SHAPE, num_steps=6,
                                    denoise=denoise,
                                    final_langevin=final_langevin)
    tout, tnfe = tsampler(condition=tcond, context=torch.from_numpy(ctx),
                          context_mask=torch.from_numpy(mask),
                          noise_fn=noise_fn)
    assert next(noise_fn.rest, None) is None  # every draw was used
    assert tnfe == int(jnfe) == 12 + final_langevin + int(denoise)
    assert np.isfinite(tout.numpy()).all()
    np.testing.assert_array_equal(tout.numpy()[..., -1],
                                  np.asarray(jcond["length"], np.float32))
    assert rel_max_diff(tout.numpy(), jout) < TRAJ_TOL


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_hybrid_trajectory_matches_jax(models, cfg_scale):
    """Three ODE steps and four PC steps, with and without classifier-free
    guidance (two UNet calls per score, the second with the zeroed
    caption): the trajectory and the NFE."""
    jmodel, params, tmodel, ctx, mask = models
    js, ts = _sdes()
    jcond, tcond = _conditions()
    key = jax.random.PRNGKey(8)
    kw = dict(ode_steps=3, pc_steps=4, cfg_scale=cfg_scale)
    jsampler = jode.get_hybrid_sampler(js, jmodel, SHAPE, **kw)
    jout, jnfe = jsampler(params, key, condition=jcond,
                          context=jnp.asarray(ctx),
                          context_mask=jnp.asarray(mask))
    noise_fn = _draws(_hybrid_draws(key, SHAPE, 4, 1))
    tsampler = tode.get_hybrid_sampler(ts, tmodel, SHAPE, **kw)
    tout, tnfe = tsampler(condition=tcond, context=torch.from_numpy(ctx),
                          context_mask=torch.from_numpy(mask),
                          noise_fn=noise_fn)
    assert next(noise_fn.rest, None) is None
    assert tnfe == int(jnfe) == (2 * 3 + 4 * 2) * (2 if cfg_scale != 1 else 1)
    assert np.isfinite(tout.numpy()).all()
    np.testing.assert_array_equal(tout.numpy()[..., -1],
                                  np.asarray(jcond["length"], np.float32))
    assert rel_max_diff(tout.numpy(), jout) < TRAJ_TOL


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _jax_hybrid_grids(sde, ode_steps, pc_steps, sigma_cross):
    """n_full, t_pc and t_ode as text2protein_tpu's get_hybrid_sampler
    built them (ode.py:203-221), read from its sampler's closure."""
    sampler = jode.get_hybrid_sampler(sde, None, SHAPE, ode_steps=ode_steps,
                                      pc_steps=pc_steps,
                                      sigma_cross=sigma_cross)
    cells = _closure(sampler.__wrapped__)
    n_full = _closure(cells["_make_steps"])["sde_tail"].N
    return n_full, np.asarray(cells["t_pc"]), np.asarray(cells["t_ode"])


@pytest.mark.parametrize("ode_steps,pc_steps,sigma_cross", [
    (3, 4, 2.0),
    (60, 170, 2.0),  # configs/deploy_l128.yml
    (4, 6, 2.0),
    (10, 25, 0.5),
])
def test_hybrid_grids_match_jax(ode_steps, pc_steps, sigma_cross):
    """n_full and both grids equal bit for bit (`linspace_f32` computes
    as XLA does); so are the tail's truncated SMLD indices and the score
    labels."""
    js, ts = _sdes()
    n_full, t_pc, t_ode = tode.hybrid_grids(ts, ode_steps, pc_steps,
                                            sigma_cross)
    jn, jt_pc, jt_ode = _jax_hybrid_grids(js, ode_steps, pc_steps,
                                          sigma_cross)
    assert n_full == jn
    assert len(t_pc) == pc_steps and len(t_ode) == ode_steps + 1
    np.testing.assert_array_equal(t_pc.numpy(), jt_pc)
    np.testing.assert_array_equal(t_ode.numpy(), jt_ode)
    assert float(t_ode[-1]) == float(t_pc[0])
    assert t_pc.dtype == t_ode.dtype == torch.float32
    np.testing.assert_array_equal(
        (t_pc * (n_full - 1)).to(torch.int64).numpy(),
        (jnp.asarray(jt_pc) * (n_full - 1)).astype(jnp.int32))
    for got, want in ((t_pc, jt_pc), (t_ode, jt_ode)):
        np.testing.assert_array_equal(
            torch.round((1.0 - got) * (NUM_SCALES - 1)).numpy(),
            np.asarray(jnp.round((1.0 - jnp.asarray(want))
                                 * (NUM_SCALES - 1))))


def test_deploy_hybrid_nfe_is_920_under_cfg():
    """configs/deploy_l128.yml: 60 Heun steps and 170 PC steps, CFG 2.0:
    NFE (2 * 60 + 170 * 2) * 2 = 920, as in the JAX package."""
    cfg = load_config("configs/deploy_l128.yml")
    cfg.model.update(nf=8, ch_mult=[1], attn_resolutions=[], n_heads=1,
                     context_dim=8)
    cfg.data.max_res_num = 8
    model = build_model(cfg, device="cpu")
    ts, eps = tsde.get_sde(cfg)
    sampler = tsampling.get_sampling_fn(cfg, ts, model, (1, 8, 8, C), eps)
    count = []
    orig = model.forward

    def counting(*a, **k):
        count.append(1)
        return torch.ones_like(a[0])

    model.forward = counting
    try:
        _, nfe = sampler(torch.Generator().manual_seed(0),
                         context=torch.zeros((1, 4, 8)),
                         context_mask=torch.ones((1, 4), dtype=torch.bool))
    finally:
        model.forward = orig
    assert nfe == len(count) == 920


@pytest.mark.parametrize("kind", ["vpsde", "subvpsde"])
def test_hybrid_refuses_a_non_ve_sde(kind):
    cfg = tiny_config_dict()
    cfg["training"]["sde"] = kind
    ts, _ = tsde.get_sde(load_config(cfg))
    model = build_model(load_config(cfg), device="cpu")
    with pytest.raises(ValueError, match=type(ts).__name__):
        tode.get_hybrid_sampler(ts, model, SHAPE)

