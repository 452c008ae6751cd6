"""Core score-network layers (counterpart of text2protein_tpu/models/layers.py).

The JAX package works in NHWC; here the convolutions run in NCHW, PyTorch's
layout, and attention tokens are taken row-major over (H, W) exactly as the
JAX package's NHWC reshape takes them. Submodule names follow the
reference-format state dict (`GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`, ...)
that text2protein_tpu/interop/torch_port.py maps to.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention


def get_act(name: str):
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError(f"activation {name} does not exist")


def get_timestep_embedding(timesteps, embedding_dim, max_positions=10000):
    """Sinusoidal embedding, [sin | cos] order."""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
        * -emb
    )
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def conv3x3(in_ch, out_ch, stride=1):
    """3x3 convolution with the JAX package's SAME padding at stride 1."""
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)


def conv1x1(in_ch, out_ch):
    return nn.Conv2d(in_ch, out_ch, 1)


class NIN(nn.Module):
    """1x1 channel projection over the last axis, with the reference's
    parameter layout: W (in, out), b (out)."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return x @ self.W + self.b


def nin(in_dim, out_dim):
    return NIN(in_dim, out_dim)


class GroupNormF32Stats(nn.Module):
    """GroupNorm with float32 statistics, variance E[x^2] - E[x]^2 clamped at
    0 and eps 1e-6, as in the JAX package (torch's GroupNorm takes the
    variance in two passes with eps 1e-5). Input (B, C, ...)."""

    def __init__(self, num_groups, num_channels, eps=1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.to(torch.float32).reshape(b, g, c // g, *x.shape[2:])
        axes = tuple(range(2, xg.ndim))
        mean = xg.mean(dim=axes, keepdim=True)
        mean2 = (xg * xg).mean(dim=axes, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        y = ((xg - mean) * inv).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def _num_groups(ch: int) -> int:
    """min(ch // 4, 32), stepped down to the nearest divisor of ch."""
    g = max(min(ch // 4, 32), 1)
    while g > 1 and ch % g:
        g -= 1
    return g


def group_norm(ch):
    return GroupNormF32Stats(_num_groups(ch), ch, eps=1e-6)


def naive_upsample_2d(x, factor=2):
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def naive_downsample_2d(x, factor=2):
    return F.avg_pool2d(x, factor)


class Upsample(nn.Module):
    """Nearest x2 upsample (+ optional conv)."""

    def __init__(self, ch, with_conv=True):
        super().__init__()
        self.Conv_0 = conv3x3(ch, ch) if with_conv else None

    def forward(self, x):
        h = naive_upsample_2d(x)
        return self.Conv_0(h) if self.Conv_0 is not None else h


class Downsample(nn.Module):
    """x2 downsample: pad right and bottom, then a VALID 3x3 conv at stride 2;
    or a 2x2 mean-pool."""

    def __init__(self, ch, with_conv=True):
        super().__init__()
        self.Conv_0 = (nn.Conv2d(ch, ch, 3, stride=2, padding=0)
                       if with_conv else None)

    def forward(self, x):
        if self.Conv_0 is not None:
            return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class ResnetBlockDDPM(nn.Module):
    """DDPM-style resblock."""

    def __init__(self, act, in_ch, out_ch=None, temb_dim=None,
                 conv_shortcut=False, dropout=0.1, skip_rescale=False):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        self.Dense_0 = (nn.Linear(temb_dim, out_ch)
                        if temb_dim is not None else None)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = nin(in_ch, out_ch)

    def forward(self, x, temb=None):
        h = self.act(self.GroupNorm_0(x))
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        h = self.Conv_1(self.Dropout_0(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        elif self.NIN_0 is not None:
            x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out


class ResnetBlockBigGAN(nn.Module):
    """BigGAN-style resblock with in-block naive up/downsampling."""

    def __init__(self, act, in_ch, out_ch=None, temb_dim=None, up=False,
                 down=False, dropout=0.1, skip_rescale=True):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.up, self.down = up, down
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        self.Dense_0 = (nn.Linear(temb_dim, out_ch)
                        if temb_dim is not None else None)
        self.GroupNorm_1 = group_norm(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch)
        self.Conv_2 = (conv1x1(in_ch, out_ch)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x, temb=None):
        h = self.act(self.GroupNorm_0(x))
        if self.up:
            h = naive_upsample_2d(h)
            x = naive_upsample_2d(x)
        elif self.down:
            h = naive_downsample_2d(h)
            x = naive_downsample_2d(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        h = self.Conv_1(self.Dropout_0(h))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out


class AttnBlock(nn.Module):
    """Single-head self-attention over the full HW token grid, scale C^-0.5,
    through the flash-attention forward."""

    def __init__(self, ch, skip_rescale=False):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(ch)
        self.NIN_0 = nin(ch, ch)
        self.NIN_1 = nin(ch, ch)
        self.NIN_2 = nin(ch, ch)
        self.NIN_3 = nin(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x)
        tokens = h.flatten(2).transpose(1, 2)  # (B, HW, C), row-major
        q = self.NIN_0(tokens).reshape(b, 1, hh * ww, c)
        k = self.NIN_1(tokens).reshape(b, 1, hh * ww, c)
        v = self.NIN_2(tokens).reshape(b, 1, hh * ww, c)
        h = dot_product_attention(q, k, v, scale=c**-0.5)
        h = self.NIN_3(h.reshape(b, hh * ww, c))
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out
