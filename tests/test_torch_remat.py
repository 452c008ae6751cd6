"""Remat in the port: the same function, the same draws, the same keys.

`model.remat_resblocks` rematerializes each residual block in the backward,
and every SpatialTransformer rematerializes its transformer blocks (the JAX
model's default, `remat_attention=True`). The dropout masks come from an
explicit generator, which torch.utils.checkpoint does not restore, so
`layers.remat` replays the generator's state for the recompute. The JAX
package holds its remat to the same rule (tests/test_training.py,
`test_remat_resblocks_matches_no_remat`); here, on the CPU, loss, gradients
and the updated weights must be bitwise equal.
"""

import numpy as np
import pytest
import torch

from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models import layers
from text2protein_tpu_torch.models.attention import SpatialTransformer
from text2protein_tpu_torch.models.unet import build_model, init_random_weights
from text2protein_tpu_torch.training.state import create_train_state
from text2protein_tpu_torch.training.steps import make_train_step

from torch_port_helpers import C, CONTEXT_DIM, N, tiny_config_dict


def _batch():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (2, N, N, C)).astype(np.float32)
    row = np.arange(N)[None, :] < np.array([11, N])[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    ctx_mask = np.ones((2, 8), bool)
    ctx_mask[0, 4:] = False
    return {
        "coords_6d": torch.from_numpy(coords * mask_pair[..., None]),
        "mask_pair": torch.from_numpy(mask_pair),
        "context": torch.from_numpy(rng.standard_normal(
            (2, 8, CONTEXT_DIM)).astype(np.float32)),
        "context_mask": torch.from_numpy(ctx_mask),
    }


def _step(dtype, remat):
    """One train step (dropout 0.1 in every block, draws from the step's
    generator) of the tiny model with or without remat: loss, gradients,
    updated weights, state-dict keys."""
    cfg = load_config(tiny_config_dict(dropout=0.1, dtype=dtype,
                                       norm_dtype=dtype,
                                       remat_resblocks=remat))
    model = init_random_weights(build_model(cfg, device="cpu"), 0)
    transformers = [m for m in model.modules()
                    if isinstance(m, SpatialTransformer)]
    assert transformers and all(m.remat for m in transformers)
    for m in transformers:
        m.remat = remat
    sde, _ = get_sde(cfg)
    state = create_train_state(cfg, model)
    loss = make_train_step(cfg, sde, model)(state, _batch(), 42)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    return loss, grads, weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_train_step_is_bitwise_the_step_without_remat(dtype):
    loss0, grads0, weights0 = _step(dtype, False)
    loss1, grads1, weights1 = _step(dtype, True)
    assert torch.isfinite(loss0)
    assert torch.equal(loss0, loss1)
    assert list(weights0) == list(weights1)  # the same state-dict keys
    assert list(grads0) == list(grads1)
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    for k in weights0:
        assert torch.equal(weights0[k], weights1[k]), k


def test_remat_replays_the_generator_for_the_recompute():
    """A block that draws from the generator: under `layers.remat` its
    gradient is the plain call's (the recompute draws the same mask), and
    the generator stands where the forward left it, both after the forward
    and after the backward."""

    def block(x, generator=None):
        keep = torch.rand(x.shape, generator=generator) < 0.5
        return torch.where(keep, x * 3.0, x.sin())

    x = torch.randn(64, requires_grad=True)
    gen = torch.Generator().manual_seed(3)
    block(x, generator=gen).sum().backward()
    want, after = x.grad.clone(), gen.get_state()
    x.grad = None
    gen.manual_seed(3)
    y = layers.remat(block, x, generator=gen)
    assert torch.equal(gen.get_state(), after)
    y.sum().backward()
    assert torch.equal(x.grad, want)
    assert torch.equal(gen.get_state(), after)
