"""DDIM sampler with classifier-free guidance and the epsilon-prediction
loss (counterpart of text2protein_tpu/diffusion/ddim.py).

Beta schedules (linear, cosine, sqrt_linear, sqrt) in float64, the
eta-parameterized DDIM reverse loop with guidance weight `w`:
eps = w * model(x, t, ctx) + (1 - w) * model(x, t, 0), and the l1/l2
epsilon-prediction loss. The loop is a plain Python loop. Every draw can be
injected: `p_loss` takes `t` and `noise`; `sample` takes a
`noise_fn(shape)`, asked for the prior and then for one draw per step (made
even at eta = 0, where it is multiplied by 0, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.utils import get_model_fn
from .sampling import default_noise_fn
from .sde import linspace_f32


def make_beta_schedule(schedule: str, n_timestep: int, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3) -> np.ndarray:
    """The (n_timestep,) float64 betas of `schedule`."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                     + cosine_s)
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


def _bcast(v, ndim):
    return v.reshape(-1, *([1] * (ndim - 1)))


class DDIMSampler:
    """Epsilon-prediction DDIM with guidance. `model(x, t_labels, context,
    context_mask)` (in eval mode) must return the predicted noise. The
    cumulative alphas are float32, rounded once from the float64
    schedule."""

    def __init__(self, model, n_timestep=1000, schedule="linear",
                 linear_start=1e-4, linear_end=2e-2):
        self.model = model
        self.n_timestep = n_timestep
        betas = make_beta_schedule(schedule, n_timestep, linear_start,
                                   linear_end)
        ac = np.cumprod(1.0 - betas).astype(np.float32)
        self.alphas_cumprod = torch.from_numpy(ac)
        self.sqrt_ac = torch.sqrt(self.alphas_cumprod)
        self.sqrt_1m_ac = torch.sqrt(1.0 - self.alphas_cumprod)

    def _device(self):
        return next(self.model.parameters()).device

    def _eps(self, x, t, context, context_mask, w):
        model_fn = get_model_fn(self.model, train=False)

        def call(ctx):
            return model_fn(x, t.to(torch.float32), ctx, context_mask)

        if context is None or w == 1.0:
            return call(context)
        return w * call(context) + (1.0 - w) * call(torch.zeros_like(context))

    def q_sample(self, x0, t, noise):
        a = _bcast(self.sqrt_ac.to(x0.device)[t], x0.ndim)
        s = _bcast(self.sqrt_1m_ac.to(x0.device)[t], x0.ndim)
        return a * x0 + s * noise

    def p_loss(self, x0, t=None, noise=None, generator=None, context=None,
               context_mask=None, loss_type="l2", w=1.0):
        """Epsilon-prediction loss. `t` (B,) int and `noise` (x0's shape)
        are drawn from `generator` where not given."""
        b = x0.shape[0]
        if t is None:
            t = torch.randint(0, self.n_timestep, (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device)
        x_t = self.q_sample(x0, t, noise)
        eps = self._eps(x_t, t, context, context_mask, w)
        if loss_type == "l1":
            return torch.mean(torch.abs(eps - noise))
        return torch.mean((eps - noise) ** 2)

    def step_indices(self, ddim_steps):
        """(ddim_steps,) descending timesteps: XLA's f32 linspace from
        n_timestep - 1 to 0, rounded (half to even), then int. Many points
        fall on halves, so the linspace must round as XLA's does."""
        return linspace_f32(self.n_timestep - 1, 0,
                            ddim_steps).round().to(torch.int64)

    def sample(self, shape, generator=None, context=None, context_mask=None,
               ddim_steps=50, eta=0.0, w=1.0, noise_fn=None):
        """The DDIM reverse loop from a standard-normal prior."""
        device = self._device()
        noise_fn = default_noise_fn(noise_fn, generator, device)
        step_idx = self.step_indices(ddim_steps).tolist()
        prev_idx = step_idx[1:] + [-1]
        ac = self.alphas_cumprod.to(device)
        one = torch.ones((), device=device)
        with torch.inference_mode():
            x = noise_fn(shape).to(device)
            for t, t_prev in zip(step_idx, prev_idx):
                vec_t = torch.full((shape[0],), t, device=device)
                eps = self._eps(x, vec_t, context, context_mask, w)
                a_t = ac[t]
                a_prev = ac[t_prev] if t_prev >= 0 else one
                x0_pred = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
                sigma = (eta * torch.sqrt((1 - a_prev) / (1 - a_t))
                         * torch.sqrt(1 - a_t / a_prev))
                dir_xt = torch.sqrt(
                    torch.clamp(1 - a_prev - sigma**2, min=0.0)) * eps
                noise = sigma * noise_fn(x.shape)
                x = torch.sqrt(a_prev) * x0_pred + dir_xt + noise
        return x
