"""Train and eval steps (counterpart of text2protein_tpu/training/steps.py).

A train step is loss and backward -> clip -> Adam -> EMA on one device; an
eval step computes the loss with the EMA params. Every random draw of a
step comes from one generator seeded from (seed, step), which takes the
place of the JAX package's `jax.random.fold_in(rng, state.step)`. The JAX
package's fused multi-step launch (`make_multi_train_step`) exists to hide
a TPU's dispatch latency; here it is a plain loop over `train_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.featurize import featurize_batch
from ..diffusion.ema import ema_update
from ..diffusion.losses import get_sde_loss_fn
from .state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, step)."""
    state = np.random.SeedSequence([int(seed) % 2**32, int(step)])
    value = int(state.generate_state(1, np.uint64)[0]) % 2**63
    return torch.Generator(device=device).manual_seed(value)


def featurize(config, batch):
    """The batch the loss takes: a batch that carries backbones (`bb`, from
    `data.featurize_on_device`) gets coords_6d and mask_pair built on its
    device (JAX `_featurizer`); any other batch is returned as it is."""
    if "bb" not in batch or "coords_6d" in batch:
        return batch
    coords_6d, mask_pair = featurize_batch(batch["bb"], batch["mask_res"],
                                           config.data.num_channels)
    return dict(batch, coords_6d=coords_6d, mask_pair=mask_pair)


def make_train_step(config, sde, model):
    """Returns train_step(state, batch, seed) -> loss (a 0-d tensor)."""
    loss_fn = get_sde_loss_fn(
        sde, model, train=True, condition=tuple(config.model.condition),
        context_dropout=float(config.model.get("context_dropout", 0.0)),
    )

    def train_step(state: TrainState, batch, seed):
        batch = featurize(config, batch)
        gen = step_generator(seed, state.step, batch["coords_6d"].device)
        state.optimizer.zero_grad()
        loss = loss_fn(None, batch, gen)
        loss.backward()
        state.optimizer.step()
        ema_update(state.ema, state.params)
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(config, sde, model):
    """Returns eval_step(state, batch, seed) -> loss, computed with the EMA
    params."""
    loss_fn = get_sde_loss_fn(sde, model, train=False,
                              condition=tuple(config.model.condition))

    def eval_step(state: TrainState, batch, seed):
        batch = featurize(config, batch)
        gen = torch.Generator(device=batch["coords_6d"].device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            return loss_fn(state.ema.params, batch, gen)

    return eval_step
