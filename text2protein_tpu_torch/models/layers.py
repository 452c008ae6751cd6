"""Core score-network layers (counterpart of text2protein_tpu/models/layers.py).

The JAX package works in NHWC; here the convolutions run in NCHW, PyTorch's
layout, and attention tokens are taken row-major over (H, W) exactly as the
JAX package's NHWC reshape takes them. Submodule names follow the
reference-format state dict (`GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`, ...)
that text2protein_tpu/interop/torch_port.py maps to.

Compute dtype (`model.dtype`): parameters stay float32; a layer built with
`dtype=torch.bfloat16` casts its input and its weights to bf16 at the call,
as flax's `dtype=` does, and rounds where the JAX package rounds: the
product, then `+ bias` in bf16 (flax adds the bias after the product), and
every elementwise op of a bf16 tensor on its own, with Python constants
rounded to bf16 first (XLA rounds each bf16 op; a fused torch op such as
`F.silu` or `F.gelu` rounds once and is a different function). In float32
every layer computes exactly what it computed before.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import dot_product_attention
from ..parallel.mesh import rand


@functools.lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> float:
    """A Python constant as the JAX package uses it in an op on a `dtype`
    array: rounded to `dtype` (a weakly typed scalar takes the array's
    dtype), returned as the float it rounds to."""
    return float(torch.tensor(value, dtype=dtype))


def swish(x):
    """flax `nn.silu`, x * sigmoid(x). In bf16 XLA computes it as
    x * (1 / (1 + exp(-x))), each op rounded to bf16."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def gelu_tanh(x):
    """flax `nn.gelu` (the tanh approximation). In bf16 each op rounds:
    x * (0.5 * (1 + tanh(c * (x + 0.044715 * ((x * x) * x))))) with the
    constants rounded to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = functools.partial(const, dtype=x.dtype)
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (1.0 + torch.tanh(inner)))


def rescale(x):
    """x / sqrt(2), the skip rescale, in x's dtype."""
    return x / const(math.sqrt(2.0), x.dtype)


def get_act(name: str):
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return swish
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


class Dropout(nn.Module):
    """flax `nn.Dropout`: in train mode keep each element with probability
    1 - p and scale it by 1 / (1 - p); in eval mode the identity. The keep
    mask is drawn from the `generator` the caller passes, so every draw of
    a training step comes from one explicit, seeded generator (a
    RowGenerator on a mesh: drawn for the global batch and the whole grid,
    this rank's rows kept; `rows_dim` is the axis of the grid's rows in the
    input: 2 in NCHW, 1 for row-major tokens, None for an input that is not
    of the grid)."""

    def __init__(self, p, rows_dim=None):
        super().__init__()
        self.p = float(p)
        self.rows_dim = rows_dim

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode needs a torch.Generator")
        keep_prob = 1.0 - self.p
        keep = rand(x.shape, generator, x.device,
                    rows_dim=self.rows_dim) < keep_prob
        return torch.where(keep, x / const(keep_prob, x.dtype),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self):
        return f"p={self.p}"


class Conv2d(nn.Conv2d):
    """flax `nn.Conv` with `dtype`: in bf16 the input and the f32 weights
    are cast to bf16, the convolution's output is rounded to bf16 and the
    bias is added after it, in bf16. In float32 the plain `nn.Conv2d`.

    With a `row_group` (`parallel.sequence`: the grid's rows split over
    ranks) a 3x3 convolution takes one halo row from each neighbour and
    pads only the columns; a 1x1 one is local."""

    row_group = None

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x, padding = x.to(dt), self.padding
        if self.row_group is not None and self.kernel_size[0] > 1:
            x, padding = self.row_group.halo(x, 2), (0, 1)
        conv = functools.partial(F.conv2d, stride=self.stride,
                                 padding=padding, dilation=self.dilation,
                                 groups=self.groups)
        if dt == torch.float32:
            return conv(x, self.weight, self.bias)
        return conv(x, self.weight.to(dt)) + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """flax `nn.Dense` with `dtype`, as `Conv2d`: product in bf16, then
    `+ bias` in bf16."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def conv3x3(in_ch, out_ch, stride=1, dtype=torch.float32):
    """3x3 convolution with the JAX package's SAME padding at stride 1."""
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, dtype=dtype)


def conv1x1(in_ch, out_ch, dtype=torch.float32):
    return Conv2d(in_ch, out_ch, 1, dtype=dtype)


class NIN(nn.Module):
    """1x1 channel projection over the last axis, with the reference's
    parameter layout: W (in, out), b (out). A flax Dense in the JAX
    package, with its `dtype` (see `Linear`)."""

    def __init__(self, in_dim, out_dim, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.W = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        dt = self.compute_dtype
        return x.to(dt) @ self.W.to(dt) + self.b.to(dt)


def nin(in_dim, out_dim, dtype=torch.float32):
    return NIN(in_dim, out_dim, dtype=dtype)


class GroupNormF32Stats(nn.Module):
    """GroupNorm with float32 statistics, variance E[x^2] - E[x]^2 clamped at
    0 and eps 1e-6, as in the JAX package (torch's GroupNorm takes the
    variance in two passes with eps 1e-5). Input (B, C, ...).

    `follow_input_dtype` (`model.norm_dtype: bfloat16`): the normalization
    and the affine run in the input's dtype, op by op as XLA rounds them,
    (x - mean) * inv * scale + bias, with mean, inv, scale and bias rounded
    to that dtype. Otherwise (and for an f32 input) all in float32, and the
    output is float32.

    With a `row_group` (`parallel.sequence`) the f32 sums of x and x^2
    are summed over the group and divided by the whole grid's count."""

    row_group = None

    def __init__(self, num_groups, num_channels, eps=1e-6,
                 follow_input_dtype=False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.follow_input_dtype = follow_input_dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.to(torch.float32).reshape(b, g, c // g, *x.shape[2:])
        axes = tuple(range(2, xg.ndim))
        if self.row_group is None:
            mean = xg.mean(dim=axes, keepdim=True)
            mean2 = (xg * xg).mean(dim=axes, keepdim=True)
        else:
            count = xg[0, 0].numel() * self.row_group.size
            sums = self.row_group.sum(torch.stack(
                [xg.sum(dim=axes), (xg * xg).sum(dim=axes)], dim=-1))
            keep = (b, g) + (1,) * len(axes)
            mean, mean2 = (m.reshape(keep) for m in (sums / count).unbind(-1))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        shape = (1, c) + (1,) * (x.ndim - 2)
        dt = x.dtype
        if self.follow_input_dtype and dt != torch.float32:
            y = ((x.reshape(xg.shape) - mean.to(dt)) * inv.to(dt)).reshape(
                x.shape)
            return (y * self.weight.to(dt).reshape(shape)
                    + self.bias.to(dt).reshape(shape))
        y = ((xg - mean) * inv).reshape(x.shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def _num_groups(ch: int) -> int:
    """min(ch // 4, 32), stepped down to the nearest divisor of ch."""
    g = max(min(ch // 4, 32), 1)
    while g > 1 and ch % g:
        g -= 1
    return g


def group_norm(ch, norm_dtype=torch.float32):
    """GroupNorm(min(ch // 4, 32), eps=1e-6); `norm_dtype` bfloat16 makes it
    follow its input's dtype (JAX `group_norm(ch, dtype=norm_dtype)`)."""
    return GroupNormF32Stats(_num_groups(ch), ch, eps=1e-6,
                             follow_input_dtype=norm_dtype != torch.float32)


def naive_upsample_2d(x, factor=2):
    """Nearest upsampling as a broadcast; its gradient is a sum over the
    broadcast axes."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor) \
        .reshape(b, c, h * factor, w * factor)


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
                 conv_shortcut=False, dropout=0.1, skip_rescale=False,
                 dtype=torch.float32, norm_dtype=torch.float32):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, norm_dtype)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)
        self.Dense_0 = (Linear(temb_dim, out_ch, dtype=dtype)
                        if temb_dim is not None else None)
        self.GroupNorm_1 = group_norm(out_ch, norm_dtype)
        self.Dropout_0 = Dropout(dropout, rows_dim=2)
        self.Conv_1 = conv3x3(out_ch, out_ch, dtype=dtype)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = nin(in_ch, out_ch, dtype=dtype)

    def forward(self, x, temb=None, generator=None):
        h = self.act(self.GroupNorm_0(x))
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        h = self.Conv_1(self.Dropout_0(h, generator))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        elif self.NIN_0 is not None:
            x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        out = x + h
        return rescale(out) if self.skip_rescale else out


class ResnetBlockBigGAN(nn.Module):
    """BigGAN-style resblock with in-block naive up/downsampling."""

    def __init__(self, act, in_ch, out_ch=None, temb_dim=None, up=False,
                 down=False, dropout=0.1, skip_rescale=True,
                 dtype=torch.float32, norm_dtype=torch.float32):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.up, self.down = up, down
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, norm_dtype)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)
        self.Dense_0 = (Linear(temb_dim, out_ch, dtype=dtype)
                        if temb_dim is not None else None)
        self.GroupNorm_1 = group_norm(out_ch, norm_dtype)
        self.Dropout_0 = Dropout(dropout, rows_dim=2)
        self.Conv_1 = conv3x3(out_ch, out_ch, dtype=dtype)
        self.Conv_2 = (conv1x1(in_ch, out_ch, dtype=dtype)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x, temb=None, generator=None):
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
        h = self.Conv_1(self.Dropout_0(h, generator))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        out = x.to(h.dtype) + h
        return rescale(out) if self.skip_rescale else out


class AttnBlock(nn.Module):
    """Single-head self-attention over the full HW token grid, scale C^-0.5,
    through the flash-attention forward. With a `row_group`
    (`parallel.sequence`) the queries are this rank's tokens and the keys
    and values are gathered from every rank's."""

    row_group = None

    def __init__(self, ch, skip_rescale=False, dtype=torch.float32,
                 norm_dtype=torch.float32):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(ch, norm_dtype)
        self.NIN_0 = nin(ch, ch, dtype=dtype)
        self.NIN_1 = nin(ch, ch, dtype=dtype)
        self.NIN_2 = nin(ch, ch, dtype=dtype)
        self.NIN_3 = nin(ch, ch, dtype=dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x)
        tokens = h.flatten(2).transpose(1, 2)  # (B, HW, C), row-major
        q = self.NIN_0(tokens).reshape(b, 1, hh * ww, c)
        if self.row_group is None:
            k = self.NIN_1(tokens).reshape(b, 1, hh * ww, c)
            v = self.NIN_2(tokens).reshape(b, 1, hh * ww, c)
        else:
            k, v = gather_keys(self.row_group, self.NIN_1(tokens),
                               self.NIN_2(tokens))
            k, v = k[:, None], v[:, None]
        h = dot_product_attention(q, k, v, scale=c**-0.5)
        h = self.NIN_3(h.reshape(b, hh * ww, c))
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        out = x.to(h.dtype) + h
        return rescale(out) if self.skip_rescale else out


def gather_keys(group, k, v):
    """Every rank's keys and values (B, T, C), gathered over the row group
    along the token axis in one collective."""
    return group.gather(torch.cat([k, v], dim=-1), 1).chunk(2, dim=-1)


def remat(fn, *args, generator=None):
    """`fn(*args, generator=generator)` under `torch.utils.checkpoint`
    (non-reentrant), the counterpart of flax `nn.remat`: its activations are
    dropped after the forward and recomputed in the backward.

    torch.utils.checkpoint restores only the default CPU/CUDA generators,
    and every dropout mask here comes from the explicit `generator`: a
    plain recompute would advance it again and draw other masks, and the
    gradients would be those of a different function. So the generator's
    state is taken before the first run and set again for the recompute,
    which draws the same masks; the state the generator had before the
    recompute is put back after it. The first run draws exactly what a call
    without remat draws."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    start = generator.get_state()
    runs = []

    def run(*a):
        if not runs:  # the forward: draws as without remat
            runs.append(1)
            return fn(*a, generator=generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, generator=generator)
        finally:
            generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
