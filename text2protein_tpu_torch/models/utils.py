"""Score-function wrappers (counterpart of text2protein_tpu/models/utils.py).

  * VE SDE: labels = round((T - t) * (N - 1)) index the DESCENDING sigma
    ladder; the model output is the score (the model divides by sigma).
  * VP/sub-VP SDE: labels = t * (N - 1); score = -model(x, labels) / std.
"""

from __future__ import annotations

import torch

from ..diffusion import sde as sde_lib
from ..diffusion.sde import bcast


def get_model_fn(model, train=False):
    """Put the module in train or eval mode and return it as a callable
    model_fn(x, labels, context, context_mask)."""
    model.train(train)

    def model_fn(x, labels, context=None, context_mask=None):
        return model(x, labels, context=context, context_mask=context_mask)

    return model_fn


def get_score_fn(sde, model, train=False, continuous=False):
    """Wrap the model into a time-dependent score function score(x, t, ctx)."""
    model_fn = get_model_fn(model, train=train)

    if isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):

        def score_fn(x, t, context=None, context_mask=None):
            if continuous or isinstance(sde, sde_lib.subVPSDE):
                labels = t * 999
                out = model_fn(x, labels, context, context_mask)
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = t * (sde.N - 1)
                out = model_fn(x, labels, context, context_mask)
                std = sde.sqrt_1m_alphas_cumprod(x.device)[
                    labels.to(torch.int64)]
            return -out / bcast(std, x.ndim)

    elif isinstance(sde, sde_lib.VESDE):

        def score_fn(x, t, context=None, context_mask=None):
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1))
            return model_fn(x, labels, context, context_mask)

    else:
        raise NotImplementedError(
            f"SDE class {type(sde).__name__} not supported.")

    return score_fn
