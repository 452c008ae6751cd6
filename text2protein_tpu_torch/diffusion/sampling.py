"""Predictor-Corrector sampling (counterpart of
text2protein_tpu/diffusion/sampling.py).

The reverse trajectory (corrector -> clamp -> predictor -> clamp) is a plain
Python loop; PyTorch runs it eagerly. Every random draw goes through one
`noise_fn(shape) -> tensor` in a fixed order (the prior, then for each step
the corrector's `n_steps` draws and the predictor's draw), so a test can
inject the JAX package's draws and compare trajectories.
"""

from __future__ import annotations

import dataclasses

import torch

from . import sde as sde_lib
from .sde import bcast
from ..models.utils import get_score_fn

_PREDICTORS = {}
_CORRECTORS = {}


def register_predictor(cls=None, *, name=None):
    def _register(c):
        local = name or c.__name__
        if local in _PREDICTORS:
            raise ValueError(f"Already registered predictor: {local}")
        _PREDICTORS[local] = c
        return c

    return _register if cls is None else _register(cls)


def register_corrector(cls=None, *, name=None):
    def _register(c):
        local = name or c.__name__
        if local in _CORRECTORS:
            raise ValueError(f"Already registered corrector: {local}")
        _CORRECTORS[local] = c
        return c

    return _register if cls is None else _register(cls)


def get_predictor(name):
    return _PREDICTORS[name]


def get_corrector(name):
    return _CORRECTORS[name]


class Predictor:
    """score_fn here is already context-bound: score_fn(x, t) -> score."""

    def __init__(self, sde, score_fn, probability_flow=False):
        self.sde = sde
        self.rsde = sde.reverse(score_fn, probability_flow)
        self.score_fn = score_fn

    def update_fn(self, noise_fn, x, t):
        raise NotImplementedError


class Corrector:
    def __init__(self, sde, score_fn, snr, n_steps):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    def update_fn(self, noise_fn, x, t):
        raise NotImplementedError


@register_predictor(name="reverse_diffusion")
class ReverseDiffusionPredictor(Predictor):
    def update_fn(self, noise_fn, x, t):
        f, G = self.rsde.discretize(x, t)
        z = noise_fn(x.shape)
        x_mean = x - f
        return x_mean + bcast(G, x.ndim) * z, x_mean


@register_predictor(name="euler_maruyama")
class EulerMaruyamaPredictor(Predictor):
    def update_fn(self, noise_fn, x, t):
        dt = -1.0 / self.rsde.N
        z = noise_fn(x.shape)
        drift, diffusion = self.rsde.sde(x, t)
        x_mean = x + drift * dt
        return x_mean + bcast(diffusion, x.ndim) * (-dt) ** 0.5 * z, x_mean


@register_predictor(name="none")
class NonePredictor(Predictor):
    def __init__(self, *args, **kwargs):
        pass

    def update_fn(self, noise_fn, x, t):
        return x, x


@register_corrector(name="langevin")
class LangevinCorrector(Corrector):
    """n_steps of step = 2*alpha*(snr*||z||/||grad||)^2; the norms are batch
    means."""

    def update_fn(self, noise_fn, x, t):
        sde = self.sde
        if isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):
            timestep = (t * (sde.N - 1) / sde.T).to(torch.int64)
            alpha = sde.alphas(x.device)[timestep]
        else:
            alpha = torch.ones_like(t)
        b = x.shape[0]
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t)
            noise = noise_fn(x.shape)
            grad_norm = torch.linalg.norm(grad.reshape(b, -1), dim=-1).mean()
            noise_norm = torch.linalg.norm(noise.reshape(b, -1), dim=-1).mean()
            step_size = (self.snr * noise_norm / grad_norm) ** 2 * 2 * alpha
            x_mean = x + bcast(step_size, x.ndim) * grad
            x = x_mean + bcast(torch.sqrt(step_size * 2), x.ndim) * noise
        return x, x_mean


@register_corrector(name="none")
class NoneCorrector(Corrector):
    def __init__(self, *args, **kwargs):
        pass

    def update_fn(self, noise_fn, x, t):
        return x, x


def apply_condition(x, condition):
    """Overwrite the prior sample with the conditioning information and build
    the conditional mask (True = free). Channel-last layout."""
    x = x.clone()
    cmask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for k, v in (condition or {}).items():
        if k == "length":
            v = v.to(x.dtype)  # (B, N, N)
            x = x * v[..., None]
            cmask = cmask & v[..., None].to(torch.bool)
            x[..., -1] = v
            cmask[..., -1] = False
        elif k == "ss":
            x[..., 4:7] = v  # v: (B, N, N, 3)
            cmask[..., 4:7] = False
        elif k == "inpainting":
            cmask = cmask & v["mask_inpaint"][..., None]  # True = inpaint
            x = torch.where(cmask, x, v["coords_6d"])
        else:
            raise ValueError(f"unknown condition {k}")
    return x, cmask


def get_pc_sampler(
    sde,
    model,
    shape,
    predictor="reverse_diffusion",
    corrector="langevin",
    snr=0.17,
    n_steps=1,
    probability_flow=False,
    denoise=True,
    eps=1e-5,
    num_steps=None,
    cfg_scale=1.0,
):
    """Build a PC sampler.

    Returns sampler(generator=None, condition=None, context=None,
    context_mask=None, noise_fn=None) -> (samples (B, N, N, C), nfe), run
    on the device of the model's parameters. Draws come from `noise_fn`,
    else from `torch.randn` with `generator`. `num_steps` overrides sde.N
    (NFE = num_steps * (n_steps + 1)). `cfg_scale` != 1 applies
    classifier-free guidance with the zeroed caption as the null condition,
    which doubles the NFE.
    """
    predictor_cls = get_predictor(predictor.lower())
    corrector_cls = get_corrector(corrector.lower())
    N = num_steps or sde.N
    # Stepping fewer times than the model's ladder: the SAMPLER uses a
    # re-discretized SDE (its G spans one sampled step) while the SCORE keeps
    # the model's num_scales label convention.
    sde_sampler = dataclasses.replace(sde, N=N) if N != sde.N else sde
    guided = cfg_scale != 1.0
    base_score_fn = get_score_fn(sde, model, train=False)

    def sampler(generator=None, condition=None, context=None,
                context_mask=None, noise_fn=None):
        device = next(model.parameters()).device
        if noise_fn is None:
            def noise_fn(s):
                return torch.randn(s, generator=generator, device=device)

        if guided and context is not None:
            def score_fn(x, t):
                s_cond = base_score_fn(x, t, context, context_mask)
                s_null = base_score_fn(x, t, torch.zeros_like(context),
                                       context_mask)
                return cfg_scale * s_cond + (1.0 - cfg_scale) * s_null
        else:
            def score_fn(x, t):
                return base_score_fn(x, t, context, context_mask)

        pred = predictor_cls(sde_sampler, score_fn, probability_flow)
        corr = corrector_cls(sde_sampler, score_fn, snr, n_steps)

        with torch.inference_mode():
            x = sde_sampler.prior_sampling(noise_fn(shape)).to(device)
            timesteps = torch.linspace(sde_sampler.T, eps, N, device=device)
            x, cmask = apply_condition(x, condition)
            x_initial = x_mean = x
            for i in range(N):
                vec_t = timesteps[i].expand(shape[0])
                x, x_mean = corr.update_fn(noise_fn, x, vec_t)
                x = torch.where(cmask, x, x_initial)
                x, x_mean = pred.update_fn(noise_fn, x, vec_t)
                x = torch.where(cmask, x, x_initial)
            x_mean = torch.where(cmask, x_mean, x_initial)
        mult = 2 if (guided and context is not None) else 1
        return (x_mean if denoise else x), N * (n_steps + 1) * mult

    return sampler


def get_sampling_fn(config, sde, model, shape, eps, num_steps=None):
    """Config-driven sampler factory. Only `sampling.method: pc` is ported;
    the ODE and hybrid samplers come with a later part of the port."""
    method = str(config.sampling.get("method", "pc")).lower()
    if method != "pc":
        raise NotImplementedError(
            f"sampling.method={method} is not ported yet; use pc")
    return get_pc_sampler(
        sde=sde,
        model=model,
        shape=shape,
        predictor=config.sampling.predictor,
        corrector=config.sampling.corrector,
        snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        denoise=config.sampling.noise_removal,
        eps=eps,
        num_steps=num_steps,
        cfg_scale=float(config.sampling.get("cfg_scale", 1.0)),
    )
