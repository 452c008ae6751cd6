"""Train state: the model, its optimizer, the EMA and the step (counterpart
of text2protein_tpu/training/state.py).

The optimizer is the JAX package's optax chain: global-norm clipping by
optax's rule, then Adam (AdamW when `optim.weight_decay` is set) with
b2 = 0.999 and eps outside the square root, at a learning rate that warms
up linearly from 0 (`optax.linear_schedule(0, lr, warmup)`) and is read at
the count of updates made so far, so the first update runs at lr 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..diffusion.ema import EMAState, ema_init
from ..parallel.mesh import local


def global_norm(grads, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax `global_norm`).
    Over sharded gradients (DTensors) each rank sums the squares of its
    shards and the sums are added over `group`, the `model` ranks: the
    `data` replicas hold the same averaged gradients, so a sum over them
    would count the norm `data` times."""
    total = sum(torch.sum(g * g) for g in map(local, grads))
    if group is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, group=None) -> torch.Tensor:
    """optax `clip_by_global_norm`, in place: where the global norm is at
    least `max_norm`, each gradient becomes (g / norm) * max_norm; below it
    nothing changes. No epsilon (torch's `clip_grad_norm_` divides by
    norm + 1e-6 and so differs). Decided on the device, without a host
    sync; a sharded gradient is clipped shard by shard. Returns the norm
    before clipping."""
    norm = global_norm(grads, group)
    trigger = norm < max_norm
    for g in map(local, grads):
        g.copy_(torch.where(trigger, g, g / norm * max_norm))
    return norm


class Optimizer:
    """Clip, then Adam at the warmed-up learning rate, over `params`."""

    def __init__(self, config, params):
        o = config.optim
        if o.optimizer != "Adam":
            raise ValueError(f"optimizer {o.optimizer} not supported")
        self.params = [p for p in params if p.requires_grad]
        self.lr = float(o.lr)
        self.warmup = max(int(o.warmup), 0)
        self.grad_clip = o.grad_clip
        kwargs = dict(lr=self.lr, betas=(float(o.beta1), 0.999),
                      eps=float(o.eps))
        if o.weight_decay:
            self.adam = torch.optim.AdamW(
                self.params, weight_decay=float(o.weight_decay), **kwargs)
        else:
            self.adam = torch.optim.Adam(self.params, **kwargs)
        self.count = 0  # updates made so far
        # the `model` ranks' group over which a sharded global norm is
        # summed (`parallel.mesh.shard_train_state`)
        self.norm_group = None

    def learning_rate(self, count: int) -> float:
        """optax linear_schedule(0, lr, warmup) at `count`."""
        if self.warmup == 0:
            return self.lr
        return self.lr * min(count, self.warmup) / self.warmup

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        """One update from the gradients in `.grad`. Returns the global
        gradient norm before clipping (a tensor on the device)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip is not None and self.grad_clip >= 0:
            norm = clip_by_global_norm(grads, float(self.grad_clip),
                                       self.norm_group)
        else:
            norm = global_norm(grads, self.norm_group)
        for group in self.adam.param_groups:
            group["lr"] = self.learning_rate(self.count)
        self.adam.step()
        self.count += 1
        return norm


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema: EMAState
    mesh: Any = None  # a parallel.mesh.Mesh once sharded

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def create_train_state(config, model) -> TrainState:
    """Step 0: the optimizer over the model's parameters and an EMA that
    starts from them."""
    params = dict(model.named_parameters())
    return TrainState(step=0, model=model,
                      optimizer=Optimizer(config, params.values()),
                      ema=ema_init(params, decay=config.model.ema_rate))


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
