"""The port's DDIM sampler, beta schedules and epsilon loss against the JAX
package (text2protein_tpu/diffusion/ddim.py).

The draws (the prior and one per step for `sample`, t and the noise for
`p_loss`) are made in JAX by replaying its own key splits and handed to the
port. The epsilon model is the tiny UNet with random weights carried across,
its labels the DDIM timesteps (n_timestep = the tiny model's num_scales).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion import ddim as jddim
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion import ddim as tddim
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


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    cfgd = tiny_config_dict()
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[0, 6:] = False
    jmodel = j_build_model(j_load_config(cfgd))
    template = flax_template(jmodel, rng.standard_normal(SHAPE),
                             np.zeros(2, np.float32), ctx, mask)
    params = random_flax_params(template, 1)
    tmodel = build_model(load_config(cfgd), device="cpu")
    tmodel.load_state_dict(
        state_dict_from_flax_params(params, load_config(cfgd)), strict=True)
    return jmodel, params, tmodel, ctx, mask


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear",
                                      "sqrt"])
@pytest.mark.parametrize("n", [10, 1000])
def test_beta_schedules_equal_jax(schedule, n):
    """float64 numpy on both sides: equal bit for bit."""
    got = tddim.make_beta_schedule(schedule, n)
    want = jddim.make_beta_schedule(schedule, n)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown"):
        tddim.make_beta_schedule("quadratic", 10)


def test_step_indices_equal_jax():
    """An f32 linspace rounded half to even, then int: equal to the JAX
    sampler's `step_idx` (computed as it computes it, under jit) for every
    step count up to 40 at two schedule lengths."""
    for n in (20, 1000):
        sampler = tddim.DDIMSampler(torch.nn.Linear(1, 1), n_timestep=n)
        for steps in range(2, 41):
            want = jax.jit(lambda: jnp.linspace(n - 1, 0, steps).round()
                           .astype(jnp.int32))()
            np.testing.assert_array_equal(
                sampler.step_indices(steps).numpy(), np.asarray(want))


def test_cumulative_alphas_equal_jax():
    j = jddim.DDIMSampler(None, n_timestep=NUM_SCALES)
    t = tddim.DDIMSampler(torch.nn.Linear(1, 1), n_timestep=NUM_SCALES)
    for name in ("alphas_cumprod", "sqrt_ac", "sqrt_1m_ac"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def _sample_draws(key, shape, steps):
    """DDIMSampler.sample's draws: the prior, then one per step."""
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, shape)]
    for _ in range(steps):
        key, kz = jax.random.split(key)
        draws.append(jax.random.normal(kz, shape))
    return draws


@pytest.mark.parametrize("eta,w", [(0.0, 2.0), (0.5, 2.0)])
def test_sample_matches_jax(models, eta, w):
    """Five DDIM steps with guidance weight w (two UNet calls a step when
    w != 1, the second with the zeroed caption): relative max diff < 1e-4,
    the bar of the PC trajectory test."""
    jmodel, params, tmodel, ctx, mask = models
    steps = 5
    key = jax.random.PRNGKey(21)
    jsampler = jddim.DDIMSampler(jmodel, n_timestep=NUM_SCALES)
    want = jsampler.sample(params, key, SHAPE, context=jnp.asarray(ctx),
                           context_mask=jnp.asarray(mask), ddim_steps=steps,
                           eta=eta, w=w)
    draws = iter(_sample_draws(key, SHAPE, steps))
    tsampler = tddim.DDIMSampler(tmodel, n_timestep=NUM_SCALES)
    got = tsampler.sample(SHAPE, context=torch.from_numpy(ctx),
                          context_mask=torch.from_numpy(mask),
                          ddim_steps=steps, eta=eta, w=w,
                          noise_fn=lambda s: torch.from_numpy(
                              np.array(next(draws))))
    assert next(draws, None) is None
    assert np.isfinite(got.numpy()).all()
    assert rel_max_diff(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("loss_type,w", [("l1", 1.0), ("l2", 2.0)])
def test_p_loss_matches_jax_with_injected_draws(models, loss_type, w):
    """t and the noise drawn as JAX's p_loss draws them, injected into the
    port: the loss within rtol 1e-5."""
    jmodel, params, tmodel, ctx, mask = models
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_t, k_z = jax.random.split(key)
    t = np.asarray(jax.random.randint(k_t, (2,), 0, NUM_SCALES))
    noise = np.asarray(jax.random.normal(k_z, SHAPE))
    want = jddim.DDIMSampler(jmodel, n_timestep=NUM_SCALES).p_loss(
        params, jnp.asarray(x0), key, context=jnp.asarray(ctx),
        context_mask=jnp.asarray(mask), loss_type=loss_type, w=w)
    with torch.no_grad():
        got = tddim.DDIMSampler(tmodel, n_timestep=NUM_SCALES).p_loss(
            torch.from_numpy(x0), t=torch.from_numpy(t).long(),
            noise=torch.from_numpy(noise), context=torch.from_numpy(ctx),
            context_mask=torch.from_numpy(mask), loss_type=loss_type, w=w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_p_loss_draws_from_its_generator(models):
    """Without injected draws, t and the noise come from the generator: the
    same seed gives the same loss."""
    _, _, tmodel, ctx, mask = models
    sampler = tddim.DDIMSampler(tmodel, n_timestep=NUM_SCALES)
    x0 = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        losses = [float(sampler.p_loss(
            x0, generator=torch.Generator().manual_seed(s)))
            for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
