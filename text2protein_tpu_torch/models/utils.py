"""Score-function wrappers (counterpart of text2protein_tpu/models/utils.py).

  * VE SDE: labels = round((T - t) * (N - 1)) index the DESCENDING sigma
    ladder; the model output is the score (the model divides by sigma).
  * VP/sub-VP SDE: labels = t * (N - 1); score = -model(x, labels) / std.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..diffusion import sde as sde_lib
from ..diffusion.sde import bcast, get_sigmas


def get_sigmas_for_config(config):
    """The model's DESCENDING sigma ladder (num_scales values from
    sigma_max to sigma_min), numpy float32."""
    return get_sigmas(config.model.sigma_min, config.model.sigma_max,
                      config.model.num_scales)


def get_model_fn(model, params=None, train=False, generator=None):
    """Put the module in train or eval mode and return it as a callable
    model_fn(x, labels, context, context_mask).

    `params` (a {name: tensor} dict, e.g. the EMA params) replaces the
    module's own parameters for the call, as the JAX package's `apply` takes
    a params tree; None uses the module's own. In train mode every dropout
    mask is drawn from `generator`."""
    model.train(train)
    extra = {"generator": generator} if train else {}

    def model_fn(x, labels, context=None, context_mask=None):
        kwargs = dict(context=context, context_mask=context_mask, **extra)
        if params is None:
            return model(x, labels, **kwargs)
        return functional_call(model, params, (x, labels), kwargs)

    return model_fn


def get_score_fn(sde, model, params=None, train=False, continuous=False,
                 generator=None):
    """Wrap the model into a time-dependent score function score(x, t, ctx)."""
    model_fn = get_model_fn(model, params, train=train, generator=generator)

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
