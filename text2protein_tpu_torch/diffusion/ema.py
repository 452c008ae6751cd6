"""Exponential moving average of parameters (counterpart of
text2protein_tpu/diffusion/ema.py).

Effective decay = min(decay, (1 + n) / (10 + n)) with n counted after the
increment, and ema <- ema - (1 - decay) * (ema - p), computed in float32 as
the JAX package computes it. The JAX package returns a new state; here the
EMA tensors are updated in place, which saves a copy of the parameters per
step. Sharded EMA tensors and parameters (DTensors placed alike) are
updated shard by shard.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.mesh import local


@dataclass
class EMAState:
    decay: float
    num_updates: int = 0
    params: dict = field(default_factory=dict)  # name -> tensor


def ema_init(params: dict, decay: float = 0.999) -> EMAState:
    """EMA of `params` ({name: tensor}), starting from copies of them."""
    return EMAState(decay=decay, num_updates=0,
                    params={k: v.detach().clone() for k, v in params.items()})


@torch.no_grad()
def ema_update(state: EMAState, new_params: dict) -> EMAState:
    n = np.float32(state.num_updates + 1)
    decay = min(np.float32(state.decay),
                (np.float32(1.0) + n) / (np.float32(10.0) + n))
    one_minus = float(np.float32(1.0) - decay)
    for k, s in state.params.items():
        s, p = local(s), local(new_params[k].detach())
        s.sub_((s - p) * one_minus)
    state.num_updates += 1
    return state
