"""Forward/reverse SDEs (counterpart of text2protein_tpu/diffusion/sde.py).

SDE objects hold only Python floats; every method takes and returns tensors,
with `t` shaped (B,). Random draws are never made here: `prior_sampling`
takes a standard-normal tensor, so a caller can inject the noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def bcast(v, ndim):
    """Broadcast a (B,) vector against a (B, ...) tensor of rank `ndim`."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric sigma ladder, DESCENDING (sigma_max first): the model-side
    table."""
    return np.exp(
        np.linspace(math.log(sigma_max), math.log(sigma_min), num_scales)
    ).astype(np.float32)


@dataclass(frozen=True)
class SDE:
    """Base SDE. `N` is the number of discretization steps."""

    N: int

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t):
        raise NotImplementedError

    def marginal_prob(self, x, t):
        raise NotImplementedError

    def prior_sampling(self, z):
        """A prior sample from a standard-normal draw `z`."""
        raise NotImplementedError

    def discretize(self, x, t):
        """Euler-Maruyama by default: x_{i+1} = x_i + f_i + G_i z_i."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn, probability_flow: bool = False):
        """Reverse-time SDE/ODE with drift f - G^2 * score; `score_fn(x, t)`
        is already context-bound."""
        fwd = self
        mult = 0.5 if probability_flow else 1.0

        class _Reverse:
            N = fwd.N
            T = fwd.T

            def sde(self_r, x, t):
                drift, diffusion = fwd.sde(x, t)
                score = score_fn(x, t)
                drift = drift - bcast(diffusion, x.ndim) ** 2 * score * mult
                if probability_flow:
                    diffusion = torch.zeros_like(diffusion)
                return drift, diffusion

            def discretize(self_r, x, t):
                f, G = fwd.discretize(x, t)
                score = score_fn(x, t)
                rev_f = f - bcast(G, x.ndim) ** 2 * score * mult
                rev_G = torch.zeros_like(G) if probability_flow else G
                return rev_f, rev_G

        return _Reverse()


@dataclass(frozen=True)
class VPSDE(SDE):
    beta_min: float = 0.1
    beta_max: float = 20.0

    def discrete_betas(self, device=None):
        return torch.linspace(self.beta_min / self.N,
                              self.beta_max / self.N, self.N, device=device)

    def alphas(self, device=None):
        return 1.0 - self.discrete_betas(device)

    def sqrt_1m_alphas_cumprod(self, device=None):
        return torch.sqrt(1.0 - torch.cumprod(self.alphas(device), dim=0))

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        drift = -0.5 * bcast(beta_t, x.ndim) * x
        return drift, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        log_mean_coeff = (-0.25 * t**2 * (self.beta_max - self.beta_min)
                          - 0.5 * t * self.beta_min)
        mean = torch.exp(bcast(log_mean_coeff, x.ndim)) * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
        return mean, std

    def prior_sampling(self, z):
        return z

    def discretize(self, x, t):
        """DDPM discretization."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        beta = self.discrete_betas(x.device)[timestep]
        alpha = self.alphas(x.device)[timestep]
        f = bcast(torch.sqrt(alpha), x.ndim) * x - x
        return f, torch.sqrt(beta)


@dataclass(frozen=True)
class subVPSDE(SDE):
    beta_min: float = 0.1
    beta_max: float = 20.0

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        drift = -0.5 * bcast(beta_t, x.ndim) * x
        discount = 1.0 - torch.exp(
            -2 * self.beta_min * t - (self.beta_max - self.beta_min) * t**2)
        return drift, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        log_mean_coeff = (-0.25 * t**2 * (self.beta_max - self.beta_min)
                          - 0.5 * t * self.beta_min)
        mean = torch.exp(bcast(log_mean_coeff, x.ndim)) * x
        std = 1.0 - torch.exp(2.0 * log_mean_coeff)
        return mean, std

    def prior_sampling(self, z):
        return z


@dataclass(frozen=True)
class VESDE(SDE):
    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def discrete_sigmas(self, device=None):
        """ASCENDING sigma ladder of the SMLD discretization."""
        return torch.exp(torch.linspace(math.log(self.sigma_min),
                                        math.log(self.sigma_max), self.N,
                                        device=device))

    def sde(self, x, t):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        drift = torch.zeros_like(x)
        diffusion = sigma * math.sqrt(
            2 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return drift, diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def prior_sampling(self, z):
        return z * self.sigma_max

    def discretize(self, x, t):
        """SMLD (NCSN) discretization: G = sqrt(sigma_t^2 - sigma_{t-1}^2),
        with the time index truncated to an int."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        sigmas = self.discrete_sigmas(x.device)
        sigma = sigmas[timestep]
        adjacent = torch.where(timestep == 0, torch.zeros_like(t),
                               sigmas[(timestep - 1).clamp(min=0)])
        f = torch.zeros_like(x)
        return f, torch.sqrt(sigma**2 - adjacent**2)


def get_sde(config):
    """The SDE and sampling eps named by the config."""
    name = config.training.sde.lower()
    m = config.model
    if name == "vesde":
        return VESDE(N=m.num_scales, sigma_min=m.sigma_min,
                     sigma_max=m.sigma_max), 1e-5
    if name == "vpsde":
        return VPSDE(N=m.num_scales, beta_min=m.beta_min,
                     beta_max=m.beta_max), 1e-3
    if name == "subvpsde":
        return subVPSDE(N=m.num_scales, beta_min=m.beta_min,
                        beta_max=m.beta_max), 1e-3
    raise NotImplementedError(f"SDE {name} unknown.")
