"""Normalization zoo and dispatch (counterpart of
text2protein_tpu/models/normalization.py), NCHW.

Every shipped config uses plain GroupNorm; the plus / variance / none
variants and their class-conditional counterparts are the rest of the zoo.
Parameters carry the JAX modules' names and values: `alpha` and `gamma` are
offsets from 1 (initialized from N(0, 0.02)), `beta` starts at 0, and a
conditional module's per-class rows (`embed`) start at 1 + 0.02 N(0, 1)
for their scales and 0 for their biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNormF32Stats


def _offset_param(c):
    return nn.Parameter(torch.randn(c) * 0.02)


def _embed(num_classes, c_scale, c_bias):
    scale = 1.0 + 0.02 * torch.randn(num_classes, c_scale)
    return nn.Parameter(torch.cat([scale, torch.zeros(num_classes, c_bias)],
                                  dim=-1))


def _cast(v):  # (B, C) or (C,) -> broadcast over (B, C, H, W)
    return v[..., :, None, None]


def _instance_norm(x):
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + 1e-5)


def _plus_stats(x):
    """The normalized per-channel means (InstanceNorm++'s reintroduced
    mean); the variance over channels is unbiased (ddof 1)."""
    means = torch.mean(x, dim=(2, 3))  # (B, C)
    m = torch.mean(means, dim=-1, keepdim=True)
    v = torch.var(means, dim=-1, keepdim=True, correction=1)
    return (means - m) / torch.sqrt(v + 1e-5)


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: out = gamma * (h + means_norm * alpha) + beta."""

    def __init__(self, num_features, bias=True):
        super().__init__()
        self.alpha = _offset_param(num_features)
        self.gamma = _offset_param(num_features)
        self.beta = (nn.Parameter(torch.zeros(num_features)) if bias
                     else None)

    def forward(self, x):
        means_norm = _plus_stats(x)
        h = _instance_norm(x)
        h = h + _cast(means_norm) * _cast(self.alpha + 1.0)
        out = _cast(self.gamma + 1.0) * h
        if self.beta is not None:
            out = out + _cast(self.beta)
        return out


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++: gamma, alpha (and beta) from the
    class's row of `embed`."""

    def __init__(self, num_features, num_classes, bias=True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.embed = _embed(num_classes, 2 * c, c if bias else 0)

    def forward(self, x, y):
        c = x.shape[1]
        means_norm = _plus_stats(x)
        h = _instance_norm(x)
        row = self.embed[y]
        gamma, alpha = row[:, :c], row[:, c:2 * c]
        h = h + _cast(means_norm) * _cast(alpha)
        out = _cast(gamma) * h
        if self.bias:
            out = out + _cast(row[:, 2 * c:])
        return out


class ConditionalInstanceNorm2d(nn.Module):
    """Class-conditional plain instance norm."""

    def __init__(self, num_features, num_classes, bias=True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.embed = _embed(num_classes, c, c if bias else 0)

    def forward(self, x, y):
        c = x.shape[1]
        h = _instance_norm(x)
        row = self.embed[y]
        out = _cast(row[:, :c]) * h
        if self.bias:
            out = out + _cast(row[:, c:])
        return out


class VarianceNorm2d(nn.Module):
    """Variance-only normalization (unbiased variance over H, W)."""

    def __init__(self, num_features, bias=False):
        super().__init__()
        self.alpha = _offset_param(num_features)
        self.beta = (nn.Parameter(torch.zeros(num_features)) if bias
                     else None)

    def forward(self, x):
        v = torch.var(x, dim=(2, 3), keepdim=True, correction=1)
        h = x / torch.sqrt(v + 1e-5)
        out = _cast(self.alpha + 1.0) * h
        if self.beta is not None:
            out = out + _cast(self.beta)
        return out


class ConditionalVarianceNorm2d(nn.Module):
    """Class-conditional variance norm."""

    def __init__(self, num_features, num_classes, bias=False):
        super().__init__()
        self.embed = _embed(num_classes, num_features, 0)

    def forward(self, x, y):
        v = torch.var(x, dim=(2, 3), keepdim=True, correction=1)
        h = x / torch.sqrt(v + 1e-5)
        return _cast(self.embed[y]) * h


class NoneNorm2d(nn.Module):
    """Identity."""

    def __init__(self, num_features=None, bias=True):
        super().__init__()

    def forward(self, x):
        return x


class ConditionalNoneNorm2d(nn.Module):
    """Per-class affine without normalization."""

    def __init__(self, num_features, num_classes, bias=True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.embed = _embed(num_classes, c, c if bias else 0)

    def forward(self, x, y):
        c = x.shape[1]
        row = self.embed[y]
        out = _cast(row[:, :c]) * x
        if self.bias:
            out = out + _cast(row[:, c:])
        return out


class RunningBatchNorm2d(nn.BatchNorm2d):
    """flax `nn.BatchNorm(use_running_average=True)`: always normalizes by
    the running statistics (mean 0 and variance 1 until loaded), eps
    1e-5."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def get_normalization(name: str, conditional: bool = False,
                      num_classes=None):
    """A factory ch -> module by config name; the conditional branch has
    InstanceNorm++ only, as in the JAX package."""
    name = name.lower()
    if conditional:
        if name == "instancenorm++":
            return lambda ch: ConditionalInstanceNorm2dPlus(ch, num_classes)
        raise NotImplementedError(f"{name} has no conditional variant")
    if name == "groupnorm":
        return lambda ch: GroupNormF32Stats(min(ch // 4, 32), ch, eps=1e-6)
    if name == "instancenorm++":
        return lambda ch: InstanceNorm2dPlus(ch)
    if name == "instancenorm":
        return lambda ch: GroupNormF32Stats(ch, ch, eps=1e-5)
    if name == "variancenorm":
        return lambda ch: VarianceNorm2d(ch)
    if name == "nonenorm":
        return lambda ch: NoneNorm2d(ch)
    if name == "batchnorm":
        return lambda ch: RunningBatchNorm2d(ch, eps=1e-5)
    raise ValueError(f"normalization {name} unknown")
