"""The port's PC inpainter against the JAX package
(text2protein_tpu/diffusion/inpainting.py).

The draws are made in JAX by replaying the PC sampler's key splits (the
inpainter is that sampler under the `inpainting` condition) and handed to
the port; the model is the tiny UNet with random weights carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.conditioning import selected_mask_batch as j_selected
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion import inpainting as jinpainting
from text2protein_tpu.diffusion import sde as jsde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.conditioning import selected_mask_batch
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion import inpainting as tinpainting
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


def _pc_draws(key, shape, num_steps, n_steps):
    """The PC sampler's draws: the prior, then per step the corrector's
    n_steps draws and the predictor's draw."""
    key, sub = jax.random.split(key)
    draws = [jax.random.normal(sub, shape)]
    for _ in range(num_steps):
        key, kc, kp = jax.random.split(key, 3)
        draws += [jax.random.normal(k, shape)
                  for k in jax.random.split(kc, n_steps)]
        draws.append(jax.random.normal(kp, shape))
    return draws


@pytest.mark.parametrize("mask_info", ["1:5,10:12"])
def test_pc_inpainter_matches_jax(mask_info):
    """Six PC steps inpainting the region `mask_info` names: the trajectory
    within a relative max diff of 1e-4 (the PC trajectory test's bar), the
    known region equal to coords_6d exactly, the NFE equal."""
    rng = np.random.default_rng(6)
    cfgd = tiny_config_dict()
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 4:] = False
    jmodel = j_build_model(j_load_config(cfgd))
    params = random_flax_params(
        flax_template(jmodel, rng.standard_normal(SHAPE),
                      np.zeros(2, np.float32), ctx, mask), 2)
    tmodel = build_model(load_config(cfgd), device="cpu")
    tmodel.load_state_dict(
        state_dict_from_flax_params(params, load_config(cfgd)), strict=True)
    coords = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    jmask = j_selected(mask_info, 2, N)
    tmask = selected_mask_batch(mask_info, 2, N)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))

    js = jsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0)
    ts = tsde.VESDE(N=NUM_SCALES, sigma_min=0.01, sigma_max=100.0)
    key = jax.random.PRNGKey(9)
    jout, jnfe = jinpainting.get_pc_inpainter(js, jmodel, SHAPE,
                                              num_steps=6)(
        params, key, jnp.asarray(coords), jmask, context=jnp.asarray(ctx),
        context_mask=jnp.asarray(mask))
    draws = iter(_pc_draws(key, SHAPE, 6, 1))
    tout, tnfe = tinpainting.get_pc_inpainter(ts, tmodel, SHAPE,
                                              num_steps=6)(
        torch.from_numpy(coords), tmask, context=torch.from_numpy(ctx),
        context_mask=torch.from_numpy(mask),
        noise_fn=lambda s: torch.from_numpy(np.array(next(draws))))
    assert next(draws, None) is None
    assert tnfe == int(jnfe) == 12
    tout = tout.numpy()
    known = ~tmask.numpy()
    np.testing.assert_array_equal(tout[known], coords[known])
    assert np.isfinite(tout).all()
    assert rel_max_diff(tout, jout) < 1e-4
